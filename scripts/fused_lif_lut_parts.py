#!/usr/bin/env python3
"""Where the fused fc1 LIF -> fc2 gather kernel spends its time, on the card.

    python3 scripts/fused_lif_lut_parts.py

Builds four variants of ``src/repro_torch/kernels/csrc/fused_lif_lut.cu``
with ``nvcc`` into ``build/kernel_parts/``: the kernel as it is, without its
LIF (no index bytes are formed), without its gathers (the slabs still
stream in), and without both (only the TMA slab ring and the barriers).
Each is timed at path A's fc2 shape (x (4, 1568, 2048) f32, an f32 table
(256, 256, 512)) by CUDA events, 20 calls after 3 warm-ups, in two rounds.
Only the full kernel computes the right result; the others exist to be
timed. Prints one JSON line per variant and round, with the card's name
and power limit. Needs one CUDA card and the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/fused_lif_lut.cu"
OUT = ROOT / "build/kernel_parts"
LIF = ("      // the LIF of this block's share of the group's chunks",
       "      cluster_sync();   // the group's index words")
GATHER = ("#pragma unroll\n    for (int i = 0; i < RPW; ++i) {\n"
          "      const uint32_t* words",
          "    __syncthreads();   // every warp is done with this stage")
VARIANTS = {"full": [], "no_lif": ["-DNO_LIF"], "no_gather": ["-DNO_GATHER"],
            "slabs_only": ["-DNO_LIF", "-DNO_GATHER"]}
T, R, K, N = 4, 1568, 2048, 512


def cut(src: str, span, macro: str) -> str:
    a, b = src.index(span[0]), src.index(span[1])
    return f"{src[:a]}#ifndef {macro}\n{src[a:b]}#endif\n{src[b:]}"


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / "fused_lif_lut_parts.cu"
    cu.write_text(cut(cut(SOURCE.read_text(), LIF, "NO_LIF"), GATHER,
                      "NO_GATHER"))
    procs = {}
    for name, flags in VARIANTS.items():
        so = OUT / f"fused_lif_lut_{name}.so"
        procs[name] = (so, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", "-gencode",
             "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", *flags, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    libs = build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((T, R, K), generator=g, device=dev) * 2.0
    bias = torch.randn(K, generator=g, device=dev) * 0.1
    vth = 0.5 + torch.rand(K, generator=g, device=dev)
    table = torch.randn((K // 8, 256, N), generator=g, device=dev)
    spikes = torch.empty((1, R, K), dtype=torch.uint8, device=dev)
    acc = torch.empty((T, R, N), device=dev)
    argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    for rnd in range(2):
        for name, lib in libs.items():
            fn = lib.fused_lif_lut_f32
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                err = fn(x.data_ptr(), bias.data_ptr(), vth.data_ptr(),
                         table.data_ptr(), spikes.data_ptr(), acc.data_ptr(),
                         T, R, K, N, 2.0, stream)
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")

            for _ in range(3):
                call()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call()
            end.record()
            torch.cuda.synchronize()
            print(json.dumps({"variant": name, "round": rnd,
                              "ms": start.elapsed_time(end) / 20,
                              "shape": f"x ({T}, {R}, {K}) f32, table "
                                       f"({K // 8}, 256, {N}) f32",
                              "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
