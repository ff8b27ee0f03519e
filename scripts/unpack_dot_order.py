#!/usr/bin/env python3
"""How far the reference's default f32 plan moves when its unpack dots sum
in another order, on the card.

    python3 scripts/unpack_dot_order.py

The paper config (Spikformer V2-8-512, the seeded gained tree of
``chip_smoke.py``, its first 8 request images), ``ExecutionPlan()`` with
backend ``packed`` (f32, bucket 8), one eager step, held to the same step
on ``packed_plain`` (the f32 matmul of the unpacked planes). Three ways to
sum each of the 49 unpack-routed layers:

- ``kernel``: the f32 unpack dot (``csrc/unpack_dot.cu``) as the plan
  runs it;
- ``plain_f64``: the plain dot in float64, rounded once to f32 (close to a
  correctly rounded sum);
- ``plain_reversed_k``: the plain f32 dot over K in reversed order.

For each: the largest logit difference from ``packed_plain``'s, that
difference over the smoke gate's tolerance (atol 1e-3 + rtol 1e-3), whether
the labels agree, and the spike bits of each LIF that differ (the total,
and the first LIF with any). Prints the card's name and power limit, then
one JSON line a way. Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("unpack_dot_order.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.spike import unpack_timesteps
    from repro_torch.core.spikformer import SpikformerConfig
    from repro_torch.infer import ExecutionPlan, compile
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = SpikformerConfig()
    folded = cs.gained_tree(torch, cfg)
    batch = torch.from_numpy(np.concatenate(cs.request_images(cfg))[
        :cs.BATCH]).to(dev)
    pop = torch.tensor([bin(i).count("1") for i in range(256)], device=dev)

    def step(backend):
        model = compile(folded, cfg, ExecutionPlan(backend=backend),
                        folded=True, device=dev, jit=False)
        logits, rows = cs.recorded_step(model, batch)
        return logits, [(n, o) for n, o in rows if n in cs.LIFS]

    want, want_rows = step("packed_plain")
    plain_dot = ref.spike_matmul_ref

    def f64_dot(x, w, *, t=None, mode="per_plane"):
        if mode != "per_plane" or x.dim() != 3:
            return plain_dot(x, w, t=t, mode=mode)
        _, m, k = x.shape
        planes = unpack_timesteps(x, t).reshape(t * m, k).double()
        return (planes @ w.double()).float().reshape(t, m, w.shape[-1])

    def reversed_dot(x, w, *, t=None, mode="per_plane"):
        if mode != "per_plane" or x.dim() != 3:
            return plain_dot(x, w, t=t, mode=mode)
        return plain_dot(x.flip(-1).contiguous(), w.flip(0).contiguous(),
                         t=t)

    lines = []
    for name, backend, dot in (("kernel", "packed", None),
                               ("plain_f64", "packed_plain", f64_dot),
                               ("plain_reversed_k", "packed_plain",
                                reversed_dot)):
        if dot is not None:
            ref.spike_matmul_ref = dot
        try:
            got, rows = step(backend)
        finally:
            ref.spike_matmul_ref = plain_dot
        err = (got - want).abs()
        flips = [int(pop[(a ^ b).long()].sum())
                 for (_, a), (_, b) in zip(rows, want_rows)]
        lines.append({
            "sum": name, "max_abs_logit_err": float(err.max()),
            "err_over_tol": float((err / (1e-3 + 1e-3 * want.abs())).max()),
            "labels_equal": bool(torch.equal(got.argmax(-1),
                                             want.argmax(-1))),
            "spike_flips": sum(flips), "lifs": len(flips),
            "first_lif_with_flips": next(
                (i for i, f in enumerate(flips) if f), None),
            "spikes": int(sum(int(pop[b.long()].sum())
                              for _, b in want_rows))})
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"
    print(smi)
    for line in lines:
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
