"""Seeded synthetic data (port of the image half of
``repro.data.pipeline``; numpy only, no torch).

Every row is a pure function of ``(seed, step, global row)``, so a batch is
the same whatever the host count and after any restart: a checkpoint needs
only the step. ``image_batch`` gives class-conditional images (a level and
a stripe frequency by class, plus noise) that a small Spikformer can
learn. The LM sources wait for the LM training slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The image fields of the reference's ``DataConfig``; the LM fields
    (``seq``, ``vocab``, ``kind``, ``path``, ``prefetch``) come with the
    LM sources."""
    global_batch: int = 8
    seed: int = 0
    image_size: int = 32
    n_classes: int = 10
    host_id: int = 0
    n_hosts: int = 1

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0, \
            (self.global_batch, self.n_hosts)
        return self.global_batch // self.n_hosts


def _rng_for(cfg: DataConfig, step: int, row: int) -> np.random.Generator:
    # stable across restarts and host counts: keyed by the GLOBAL row index
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, row]))


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
