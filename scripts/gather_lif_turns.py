#!/usr/bin/env python3
"""Kernels 1 (TFLIF) and 2 (the byte-LUT gather) at the main path's shapes,
timed on the card for one tree of the port.

    python3 scripts/gather_lif_turns.py [--tree DIR] [--label NAME]

``--tree`` names the root of a checkout of the repository (default: this
one), whose ``src/repro_torch`` is imported and whose kernels are built
from its own sources. Running it over two trees in turns (parent, change,
change, parent) in one call on one card compares two versions of the
kernels. Shapes, at batch 8 of Spikformer V2-8-512:

- gather, q/k/v: index bytes (4, 1568, 64) x an int16 table (64, 256, 512);
- gather, path A's fc1: (4, 1568, 64) x an f32 table (64, 256, 2048);
- gather, conv0: the value planes (8, 100352, 2) x int16 and f32 tables
  (2, 256, 64);
- TFLIF at fc1's LIF: x (4, 1568 * 2048) f32, per-channel bias and v_th;
- TFLIF at conv0 through ``ops.tflif_pack``: the (4, 8, 112, 112, 64)
  accumulators expanded over T from one (8, 112, 112, 64) tensor, as
  ``PackedBackend.sssc_lif`` hands them over (a tree whose kernel needs
  contiguous x pays for the copy inside the call).

The gather is called through ``lut_gather_matmul`` (index bytes, every
tree) and, where the tree has it, ``lut_gather_packed`` (packed spikes).
Every result is held bit-exact to its plain version. Times: device time
by ``torch.profiler`` over 20 calls after 3 warm-ups, per launch of the
named kernel (``lut_gather_kernel``, ``tflif_kernel``), or per call over
every kernel the call launches (``tflif_pack`` at conv0, where a tree may
copy before its kernel); ``tflif_fc1_events_ms`` is the host's view, CUDA
events around back-to-back calls. Prints the card's name and power limit,
then one JSON line. Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPS = 20
SEED = 0


def time_ms(torch, fn) -> float:
    """Host view: CUDA events around REPS back-to-back calls."""
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


def device_ms(torch, fn, name: str = "") -> float:
    """Device view, by torch.profiler over REPS calls: one launch of the
    kernels named ``name``, or with no name every kernel of a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and name in ev.key:
            t = getattr(ev, "self_device_time_total", None)
            us += ev.self_cuda_time_total if t is None else t
            n += ev.count
    if n < REPS:
        raise SystemExit(f"{n} launches of {name!r} in {REPS} calls")
    return us / 1e3 / (n if name else REPS)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        print("gather_lif_turns.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.spike import pack_timesteps
    from repro_torch.kernels import lut_matmul as lut
    from repro_torch.kernels import ops
    from repro_torch.kernels import spike_matmul as sm
    from repro_torch.kernels.tflif import tflif_fused, tflif_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t, m, dim, hidden = 4, 8 * 196, 512, 2048
    res = {"tree": args.label or str(tree)}

    def held(got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"{what} differs from its plain version")

    def spikes(*shape):
        return (torch.rand(shape, generator=gen, device=dev) < 0.2).to(
            torch.uint8)

    xq = pack_timesteps(spikes(t, m, dim))                    # (1, M, 512)
    img = torch.randint(0, 256, (1, 8 * 112 * 112, 12), generator=gen,
                        device=dev).to(torch.uint8)
    cases = {
        "qkv_int16": (xq, t, torch.randint(-127, 128, (dim, dim),
                                           generator=gen, device=dev).to(
                                               torch.int8)),
        "fc1_f32": (xq, t, torch.randn((dim, hidden), generator=gen,
                                       device=dev)),
        "conv0_int16": (img, 8, torch.randint(-127, 128, (12, 64),
                                              generator=gen, device=dev).to(
                                                  torch.int8)),
        "conv0_f32": (img, 8, torch.randn((12, 64), generator=gen,
                                          device=dev)),
    }
    packed_entry = getattr(sm, "lut_gather_packed", None)
    for name, (x, tt, w) in cases.items():
        tbl = lut.build_lut(w)
        idx = lut.plane_indices(x)[:tt].contiguous()
        want = lut.lut_matmul(idx, tbl)
        held(sm.lut_gather_matmul(idx, tbl), want, f"gather {name}")
        row = {"idx_ms": device_ms(torch, lambda: sm.lut_gather_matmul(
            idx, tbl), "lut_gather_kernel")}
        if packed_entry is not None:
            held(packed_entry(x, tbl, t=tt), want, f"packed gather {name}")
            row["packed_ms"] = device_ms(torch, lambda: packed_entry(
                x, tbl, t=tt), "lut_gather_kernel")
        res[f"gather_{name}"] = row

    x = torch.randn((t, m * hidden), generator=gen, device=dev) * 2.0
    bias = torch.randn(hidden, generator=gen, device=dev) * 0.1
    vth = 0.5 + torch.rand(hidden, generator=gen, device=dev)
    held(tflif_fused(x, bias, vth), tflif_plain(x, bias, vth), "tflif fc1")
    res["tflif_fc1_ms"] = device_ms(torch, lambda: tflif_fused(x, bias, vth),
                                    "tflif_kernel")
    res["tflif_fc1_events_ms"] = time_ms(torch, lambda: tflif_fused(x, bias,
                                                                    vth))
    acc0 = torch.randn((8, 112, 112, 64), generator=gen, device=dev) * 40
    acc = acc0.unsqueeze(0).expand(t, *acc0.shape)
    b0 = torch.randn(64, generator=gen, device=dev)
    held(ops.tflif_pack(acc, b0), ops.tflif_pack(acc.contiguous(), b0,
                                                 plain=True), "tflif conv0")
    res["tflif_pack_conv0_ms"] = device_ms(torch, lambda: ops.tflif_pack(
        acc, b0))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
