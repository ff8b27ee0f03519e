#!/usr/bin/env python3
"""The plain versions of kernels 1, 2, 4 and 5 at ``chip_smoke.py``'s
shapes, timed on the card for one tree of the port.

    python3 scripts/plain_turns.py [--tree DIR] [--label NAME]

``--tree`` names the root of a checkout of the repository (default: this
one), whose ``src/repro_torch`` is imported. Running it over two trees in
turns (parent, change, change, parent) in one call on one card tells a
change to a plain version from run-to-run noise. The plain versions, at
batch 8 of Spikformer V2-8-512, t = 4:

- ``tflif_plain``: x (4, 1568 * 2048) f32, per-channel bias and v_th;
- ``lut_gather_packed_plain``: packed spikes (1, 1568, 512) x an int16
  table (64, 256, 512) (q/k/v);
- ``stdp_attention_packed_plain``: q, k, v (1, 8, 8, 196, 64) plane
  groups, the permuted view of (1, 8, 196, 512);
- ``tflif_lut_plain``: x (4, 1568, 2048) f32 x an f32 table (256, 256,
  512) (path A's fc1 -> fc2).

Times: ``events_ms``, CUDA events around 20 back-to-back calls after 3
warm-ups (``chip_smoke.py``'s ``plain_ms``); ``device_ms``, the device
time of every kernel a call launches, by ``torch.profiler`` over 20 calls.
Prints the card's name and power limit, then one JSON line. Needs one
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPS = 20
SEED = 0


def events_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def device_ms(torch, fn) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            t = getattr(ev, "self_device_time_total", None)
            us += ev.self_cuda_time_total if t is None else t
    return us / 1e3 / REPS


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        print("plain_turns.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.spike import pack_timesteps
    from repro_torch.kernels import lut_matmul as lut
    from repro_torch.kernels.fused import tflif_lut_plain
    from repro_torch.kernels.spike_matmul import lut_gather_packed_plain
    from repro_torch.kernels.stdp_attention import stdp_attention_packed_plain
    from repro_torch.kernels.tflif import tflif_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t, batch, tokens, dim, heads = 4, 8, 196, 512, 8
    m, hidden, dh = batch * tokens, 4 * dim, dim // heads

    def spikes(*shape):
        return (torch.rand(shape, generator=gen, device=dev) < 0.2).to(
            torch.uint8)

    x = torch.randn((t, m * hidden), generator=gen, device=dev) * 2.0
    bias = torch.randn(hidden, generator=gen, device=dev) * 0.1
    vth = 0.5 + torch.rand(hidden, generator=gen, device=dev)
    xq = pack_timesteps(spikes(t, m, dim))
    tbl16 = lut.build_lut(torch.randint(-127, 128, (dim, dim), generator=gen,
                                        device=dev).to(torch.int8))
    qp, kp, vp = (pack_timesteps(spikes(t, batch, tokens, dim)).reshape(
        1, batch, tokens, heads, dh).permute(0, 1, 3, 2, 4)
        for _ in range(3))
    x1 = torch.randn((t, m, hidden), generator=gen, device=dev) * 2.0
    tbl2f = lut.build_lut(torch.randn((hidden, dim), generator=gen,
                                      device=dev))
    calls = {
        "tflif_plain": lambda: tflif_plain(x, bias, vth),
        "lut_gather_packed_plain": lambda: lut_gather_packed_plain(
            xq, tbl16, t=t),
        "stdp_attention_packed_plain": lambda: stdp_attention_packed_plain(
            qp, kp, vp, t=t, scale=0.125),
        "tflif_lut_plain": lambda: tflif_lut_plain(x1, bias, tbl2f, vth),
    }
    res = {"tree": args.label or str(tree)}
    for name, fn in calls.items():
        res[name] = {"events_ms": events_ms(torch, fn),
                     "device_ms": device_ms(torch, fn)}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
