#!/usr/bin/env python3
"""Kernel 3 with f32 weights (the grouped unpack dot, ``csrc/unpack_dot.cu``)
at the four layer shapes of the reference's default f32 plan, timed on the
card for one tree of the port.

    python3 scripts/unpack_dot_shapes.py [--tree DIR] [--label NAME]

``--tree`` names the root of a checkout of the repository (default: this
one), whose ``src/repro_torch`` is imported and whose kernels are built
from its own sources. Running it over two trees in turns (parent, change,
change, parent) in one call on one card compares two versions of the
kernel. A tree whose wrapper takes the weights' three-term bf16 split
(``bf16x3_weights``) gets it prebuilt, as the planner builds it; an older
tree gets the f32 weights. Shapes, at batch 8 of Spikformer V2-8-512 (M =
8 x 196 rows, t = 4, spikes at a 0.2 rate, normal weights): conv3 (K 1024,
N 512), q/k/v/wo (512, 512), fc1 (512, 2048), fc2 (2048, 512).

Each result is held to its plain version (the f32 matmul of the unpacked
planes) within atol 1e-3 + rtol 1e-5. Times: device ms a call by CUDA
events around the replay of one CUDA graph of 20 captured calls, best of
three replays (the host's launch cost stays out); the library's one f32
``torch.matmul`` on the unpacked planes the same way. Prints the card's
name and power limit, then one JSON line. Needs one CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPS = 20
SEED = 0
SHAPES = (("conv3", 1024, 512), ("q/k/v/wo", 512, 512), ("fc1", 512, 2048),
          ("fc2", 2048, 512))


def graph_ms(torch, fn) -> float:
    """Device ms a call: CUDA events around one graph of REPS calls."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                        # build, warm up, set attributes
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / REPS)
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("unpack_dot_shapes.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.spike import pack_timesteps, unpack_timesteps
    from repro_torch.kernels import ref, spike_matmul as sm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    split = getattr(sm, "bf16x3_weights", None)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t, rows = 4, 8 * 196
    out = {"label": args.label, "tree": args.tree,
           "operand": "bf16x3 split" if split else "f32 weights"}
    for name, k, n in SHAPES:
        x = pack_timesteps((torch.rand((t, rows, k), generator=gen,
                                       device=dev) < 0.2).to(torch.uint8))
        w = torch.randn((k, n), generator=gen, device=dev)
        if split:
            w3 = split(w)

            def call():
                return sm.spike_matmul_grouped(x, w, t=t, w_bf16x3=w3)
        else:
            def call():
                return sm.spike_matmul_grouped(x, w, t=t)
        got, want = call(), ref.spike_matmul_ref(x, w, t=t)
        err = float((got - want).abs().max())
        if not bool(((got - want).abs() <= 1e-3 + 1e-5 * want.abs()).all()):
            print(f"unpack_dot_shapes.py: {name} off its plain version by "
                  f"{err}", file=sys.stderr)
            return 1
        planes = unpack_timesteps(x, t).reshape(t * rows, k)
        out[name] = {"ms": graph_ms(torch, call),
                     "library_ms": graph_ms(torch, lambda: torch.matmul(
                         planes, w)),
                     "max_abs_err": err}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
