"""Seeded, checkpointable data pipeline (port of ``repro.data.pipeline``).

Every row is a pure function of ``(seed, step, global row)``, so a batch is
the same whatever the host count and after any restart: a checkpoint needs
only the step. The sources are numpy, as in the reference, so their
batches are the reference's bit for bit:

  * ``synthetic_lm_batch``: a zipf unigram draw with short repeated motifs
    (learnable structure, so loss curves mean something);
  * ``TokenFileSource``: a memory-mapped file of uint32 tokens, read in
    ``seq + 1`` windows strided by step and row;
  * ``image_batch``: class-conditional images (a level and a stripe
    frequency by class, plus noise) that a small Spikformer can learn.

``DataPipeline`` makes the batches on a prefetch thread and hands them
over as torch tensors: on the card through pinned host memory (the
producer pins, the consumer copies without blocking), else on the host.
Its state is one integer, the next step.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The reference's fields, in its order (a positional call means the
    same in both packages)."""
    seq: int = 1024
    global_batch: int = 8
    vocab: int = 50_000
    seed: int = 0
    kind: str = "synthetic_lm"      # synthetic_lm | token_file | images
    path: str | None = None         # token_file: .bin of uint32 tokens
    image_size: int = 32            # images
    n_classes: int = 10             # images
    host_id: int = 0
    n_hosts: int = 1
    prefetch: int = 2

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0, \
            (self.global_batch, self.n_hosts)
        return self.global_batch // self.n_hosts


# ---------------------------------------------------------------------------
# deterministic per-(step, host) generation
# ---------------------------------------------------------------------------

def _rng_for(cfg: DataConfig, step: int, row: int) -> np.random.Generator:
    # stable across restarts and host counts: keyed by the GLOBAL row index
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, row]))


def _synthetic_row(cfg: DataConfig, step: int, grow: int) -> np.ndarray:
    """One (seq+1,) token row: a zipf unigram draw with a short motif
    repeated at random offsets."""
    rng = _rng_for(cfg, step, grow)
    n = cfg.seq + 1
    toks = rng.zipf(1.3, size=n).astype(np.int64)
    toks = np.clip(toks, 1, cfg.vocab - 1)
    # cap the motif so it fits even a very short sequence
    hi = max(9, min(32, n // 2 + 1))
    mlen = int(rng.integers(min(8, hi - 1), hi))
    motif = rng.integers(1, cfg.vocab, size=mlen)
    reps = max(1, n // (4 * mlen))
    for _ in range(reps):
        off = int(rng.integers(0, max(1, n - mlen)))
        toks[off:off + mlen] = motif
    return toks.astype(np.int32)


def synthetic_lm_batch(cfg: DataConfig, step: int) -> dict:
    """This host's rows of step ``step``: ``{"tokens", "labels"}``, (B, S)
    int32 each, the labels the tokens shifted by one."""
    rows = []
    for local_row in range(cfg.local_batch):
        grow = cfg.host_id * cfg.local_batch + local_row
        rows.append(_synthetic_row(cfg, step, grow))
    arr = np.stack(rows)                                    # (B, S+1)
    return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def image_batch(cfg: DataConfig, step: int) -> dict:
    """This host's rows of step ``step``: ``{"image": (B, S, S, 3) uint8,
    "label": (B,) int32}``."""
    imgs, labels = [], []
    for local_row in range(cfg.local_batch):
        grow = cfg.host_id * cfg.local_batch + local_row
        rng = _rng_for(cfg, step, grow)
        label = int(rng.integers(0, cfg.n_classes))
        base = np.full((cfg.image_size, cfg.image_size, 3),
                       20 * label + 30, np.float32)
        # class-dependent stripe pattern + noise
        xs = np.arange(cfg.image_size)
        stripe = 60.0 * np.sin(xs * (label + 1) / 3.0)
        base += stripe[None, :, None]
        base += rng.normal(0, 12, base.shape)
        imgs.append(np.clip(base, 0, 255).astype(np.uint8))
        labels.append(label)
    return {"image": np.stack(imgs), "label": np.array(labels, np.int32)}


class TokenFileSource:
    """Memory-mapped uint32 token file; rows are contiguous seq+1 windows
    strided deterministically by (step, row), so a restart is exact."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=np.uint32, mode="r")
        self.n_windows = max(1, (len(self.tokens) - 1) // (cfg.seq + 1))

    def batch(self, step: int) -> dict:
        rows = []
        for local_row in range(self.cfg.local_batch):
            grow = self.cfg.host_id * self.cfg.local_batch + local_row
            w = (step * self.cfg.global_batch + grow) % self.n_windows
            start = w * (self.cfg.seq + 1)
            rows.append(np.asarray(
                self.tokens[start:start + self.cfg.seq + 1], np.int32))
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

class DataPipeline:
    """Checkpointable prefetching pipeline. State == one integer (`step`).

    ``device``: where ``next`` puts the batch's tensors; None keeps them on
    the host. For a CUDA device the producer thread pins each batch and
    ``next`` copies it without blocking the host."""

    def __init__(self, cfg: DataConfig, *, start_step: int = 0,
                 device=None):
        self.cfg = cfg
        self.step = start_step
        self.device = None if device is None else torch.device(device)
        self._pin = self.device is not None and self.device.type == "cuda"
        self._file = TokenFileSource(cfg) if cfg.kind == "token_file" else None
        self._q: queue.Queue = queue.Queue(maxsize=max(1, cfg.prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- generation ---------------------------------------------------------
    def _make(self, step: int) -> dict:
        if self.cfg.kind == "synthetic_lm":
            return synthetic_lm_batch(self.cfg, step)
        if self.cfg.kind == "token_file":
            return self._file.batch(step)
        if self.cfg.kind == "images":
            return image_batch(self.cfg, step)
        raise ValueError(self.cfg.kind)

    def _tensors(self, batch: dict) -> dict:
        out = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in batch.items()}
        if self._pin:
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._tensors(self._make(step))
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    # -- consumption ---------------------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        step, batch = self._q.get()
        # the prefetch thread races ahead; trust its step accounting
        self.step = step + 1
        if self.device is not None:
            batch = {k: v.to(self.device, non_blocking=self._pin)
                     for k, v in batch.items()}
        return batch

    # -- checkpointing --------------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": int(self.step), "seed": self.cfg.seed}

    @classmethod
    def restore(cls, cfg: DataConfig, state: dict, **kw) -> "DataPipeline":
        if state.get("seed", cfg.seed) != cfg.seed:
            raise ValueError("restoring a pipeline with a different data "
                             f"seed: {state['seed']} != {cfg.seed}")
        return cls(cfg, start_step=int(state["step"]), **kw)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
