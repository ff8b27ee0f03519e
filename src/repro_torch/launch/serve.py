"""LM serving: per-request prefill and continuous-batching decode (port of
``repro.launch.serve``).

The engine keeps a fixed pool of ``slots`` (the decode batch); each slot
holds one request's KV cache rows. A request's prompt is prefilled alone
into a fresh one-row cache (its attention runs the flash kernel), the row
is spliced into the pool, and one decode step advances every slot by one
token per iteration, each row at its own position.

    python -m repro_torch.launch.serve --arch smollm-360m [--reduce] \\
        [--slots 4 --requests 8 --prompt-len 32 --max-new 16]

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import deque

import torch

from ..configs.base import get_config
from ..device import resolve_device
from ..nn import transformer as T


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    t_arrival: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class Engine:
    """Continuous-batching engine over a static slot pool.

    ``params`` (for example a reference tree carried across by
    ``repro_torch.weights.lm_from_reference``) default to ``init_model`` of
    a generator on the engine's device seeded with ``seed``. Defaults follow
    the reference: the config's compute dtype (bf16) and a bf16 cache.
    ``flash=False`` runs the plain attention in prefill too.
    """

    def __init__(self, cfg, *, slots: int, cache_len: int, seed: int = 0,
                 params=None, compute_dtype=None,
                 cache_dtype=torch.bfloat16, device=None,
                 flash: bool = True):
        self.cfg = cfg
        self.slots = slots
        self.cache_len = cache_len
        self.device = resolve_device(device)
        self.compute_dtype = T.as_dtype(compute_dtype or cfg.compute_dtype)
        self.cache_dtype = cache_dtype
        self.flash = flash
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = T.init_model(gen, cfg, device=self.device)
        self.params = params
        self.pool = T.init_cache(cfg, slots, cache_len, dtype=cache_dtype,
                                 device=self.device)
        self.active: dict[int, Request] = {}           # slot -> request
        self.positions = [0] * slots                    # per-slot cache_pos
        self.queue: deque[Request] = deque()
        self.done: list[Request] = []
        self.decode_step_s: list[float] = []            # host clock, synced

    def _prefill(self, tokens):
        """tokens: (1, S) -> (next_token, cache_row)."""
        cache = T.init_cache(self.cfg, 1, self.cache_len,
                             dtype=self.cache_dtype, device=self.device)
        logits, cache, _ = T.model_apply(
            self.params, {"tokens": tokens, "cache_pos": 0}, self.cfg,
            mode="prefill", cache=cache, compute_dtype=self.compute_dtype,
            flash=self.flash)
        return int(logits[0, -1].argmax()), cache

    def _decode(self, tokens, positions):
        """tokens: (slots, 1); positions: (slots,) per-slot cache_pos. One
        step advances every slot, each row at its own offset."""
        logits, self.pool, _ = T.model_apply(
            self.params, {"tokens": tokens, "cache_pos": positions},
            self.cfg, mode="decode", cache=self.pool,
            compute_dtype=self.compute_dtype, flash=self.flash)
        return logits[:, -1].argmax(-1).tolist()

    def _splice(self, slot: int, row_cache):
        """Copy a one-row prefill cache into pool slot ``slot`` (axis 1 of
        the stacked (L, B, ...) leaves), clearing what the slot held."""
        for name, leaf in self.pool["kv"].items():
            leaf[:, slot] = row_cache["kv"][name][:, 0]

    def submit(self, req: Request):
        req.t_arrival = time.perf_counter()
        self.queue.append(req)

    def _admit(self):
        free = [s for s in range(self.slots) if s not in self.active]
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.popleft()
            toks = torch.tensor([req.prompt], dtype=torch.int64,
                                device=self.device)
            next_tok, row = self._prefill(toks)
            req.out.append(next_tok)
            req.t_first = time.perf_counter()
            self._splice(slot, row)
            self.positions[slot] = len(req.prompt)
            self.active[slot] = req

    def step(self) -> int:
        """One engine iteration; returns the number of active slots."""
        self._admit()
        if not self.active:
            return 0
        tokens = [[0] for _ in range(self.slots)]
        for slot, req in self.active.items():
            tokens[slot] = [req.out[-1]]
        t0 = time.perf_counter()
        toks = self._decode(
            torch.tensor(tokens, dtype=torch.int64, device=self.device),
            torch.tensor(self.positions, dtype=torch.int64,
                         device=self.device))
        self.decode_step_s.append(time.perf_counter() - t0)
        self.positions = [p + 1 for p in self.positions]
        finished = []
        for slot, req in self.active.items():
            req.out.append(toks[slot])
            if len(req.out) >= req.max_new:
                req.t_done = time.perf_counter()
                finished.append(slot)
        for slot in finished:
            self.done.append(self.active.pop(slot))
        return len(self.active)

    def run(self):
        while self.queue or self.active:
            self.step()
        return self.done


def _percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def summary(done, wall_s: float, decode_step_s) -> dict:
    """Host-clock serving figures of one run."""
    total = sum(len(r.out) for r in done)
    ttfts = [r.t_first - r.t_arrival for r in done]
    return {
        "requests": len(done),
        "total_new_tokens": total,
        "wall_s": wall_s,
        "tok_per_s": total / wall_s,
        "mean_ttft_s": sum(ttfts) / len(ttfts),
        "decode_steps": len(decode_step_s),
        "decode_step_p50_s": _percentile(decode_step_s, 0.5),
        "decode_step_p95_s": _percentile(decode_step_s, 0.95),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = cfg.reduced()
    eng = Engine(cfg, slots=args.slots, cache_len=args.cache_len,
                 seed=args.seed, device=args.device)
    gen = torch.Generator().manual_seed(args.seed + 1)
    t0 = time.perf_counter()
    for i in range(args.requests):
        prompt = torch.randint(0, cfg.vocab, (args.prompt_len,),
                               generator=gen).tolist()
        eng.submit(Request(rid=i, prompt=prompt, max_new=args.max_new))
    done = eng.run()
    wall = time.perf_counter() - t0
    out = {"arch": cfg.name, "device": str(eng.device),
           **summary(done, wall, eng.decode_step_s)}
    if eng.device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(eng.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
