#!/usr/bin/env python3
"""Where the split-TF32 kernels' time goes, on the card: ``csrc/stdp.cu``
and the f32 ``csrc/flash_attention.cu`` built from edited copies of their
sources and timed in one process.

    python3 scripts/tf32x3_variants.py [--rounds 2]

Variants (each an edit of ``csrc/tf32x3.cuh``):

- ``kept``: the sources as they are;
- ``masked``: the 13 low bits of every operand cleared before the mma;
  its outputs must equal ``kept``'s bit for bit, which shows that the
  tensor cores read only a tf32 operand's top 19 bits;
- ``cvt``: the split by ``cvt.rna.tf32.f32`` in place of the integer add;
- ``nosplit``: no split (each f32 operand as it is, small = 0), still three
  products a step: the time of the splits;
- ``one_product``: the split, big big only: the time of the two
  correction products (mma.sync, or wgmma with the lo accumulator left at
  zero);
- ``nosplit_one``: neither: one unsplit TF32 product a step.

STDP at (256, 196, 64) spikes (chip_smoke.py's kernel phase) and f32 flash
attention at (15, 2048, 64) causal, scale 1/8. Device ms a call by CUDA
events around one CUDA graph of 20 calls, best of 5 replays. Each line also
gives the spike STDP's exactness, the real-valued STDP's largest error over
(|Q| |K|^T) |V| * scale and the flash kernel's largest error against the
exact softmax. Prints the card's name and power limit, then one JSON line
a variant and round. Needs one CUDA card and ``nvcc``; builds into
``build/tf32x3_variants/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SPLIT = ("  big = rna_operand(x);\n"
         "  small = rna_operand(x - __uint_as_float(big & 0xffffe000u));")
ADD = "  return __float_as_uint(x) + 0x1000u;"
CORRECTIONS = ("  mma_tf32(lo, a.big, b.small);\n"
               "  mma_tf32(lo, a.small, b.big);")
WG_CORRECTIONS = ("  wgmma_tf32(lo, a.big, b_small, !first);\n"
                  "  wgmma_tf32(lo, a.small, b_big, 1);")
WG_NO_CORRECTIONS = ("#pragma unroll\n"
                     "  for (int i = 0; i < 32; ++i) lo[i] = first ? 0.f : lo[i];")
VARIANTS = {
    "kept": [],
    "masked": [(ADD, "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;")],
    "cvt": [(ADD, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : '
                  '"=r"(r) : "f"(x));\n  return r;')],
    "nosplit": [(SPLIT, "  big = __float_as_uint(x);\n  small = 0u;")],
    "one_product": [(CORRECTIONS, ""), (WG_CORRECTIONS, WG_NO_CORRECTIONS)],
    "nosplit_one": [(SPLIT, "  big = __float_as_uint(x);\n  small = 0u;"),
                    (CORRECTIONS, ""), (WG_CORRECTIONS, WG_NO_CORRECTIONS)],
}


def build(_build, out: Path) -> dict:
    """Each variant's two libraries, all compiled at once."""
    shutil.rmtree(out, ignore_errors=True)
    procs = {}
    for variant, edits in VARIANTS.items():
        d = out / variant
        d.mkdir(parents=True)
        for f in _build.CSRC.glob("*.cuh"):
            shutil.copy(f, d)
        for name in ("stdp", "flash_attention"):
            shutil.copy(_build.CSRC / f"{name}.cu", d)
        header = d / "tf32x3.cuh"
        text = header.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{variant}: the header no longer holds "
                                   f"{old!r}")
            text = text.replace(old, new)
        header.write_text(text)
        for name in ("stdp", "flash_attention"):
            so = d / f"{name}.so"
            procs[variant, name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                 str(d / f"{name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        libs[key] = so
    return libs


def graph_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    best = float("inf")
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("tf32x3_variants.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.stdp_attention import stdp_attention

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = build(_build, ROOT / "build" / "tf32x3_variants")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    qs, ks, vs = ((torch.rand((256, 196, 64), generator=g, device=dev) < 0.2)
                  .float() for _ in range(3))
    qr, kr, vr = (torch.randn((256, 196, 64), generator=g, device=dev)
                  for _ in range(3))
    q3, k3, v3 = (torch.randn((15, 2048, 64), generator=g, device=dev)
                  for _ in range(3))
    spikes_want = ref.stdp_attention_ref(qs, ks, vs, scale=0.125)
    real_want = ref.stdp_attention_ref(qr, kr, vr, scale=0.125)
    real_scale = ref.stdp_attention_ref(qr.abs(), kr.abs(), vr.abs(),
                                        scale=0.125)
    flash_want = torch.cat([ref.flash_attention_ref(
        q3[h:h + 1], k3[h:h + 1], v3[h:h + 1], scale=0.125)
        for h in range(q3.shape[0])])

    def use(variant):
        for name in ("stdp", "flash_attention"):
            lib = ctypes.CDLL(str(libs[variant, name]))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _build._LIBS[name] = lib

    kept = {}
    for rnd in range(args.rounds):
        for variant in VARIANTS:
            use(variant)
            real = stdp_attention(qr, kr, vr, scale=0.125)
            flash = flash_attention(q3, k3, v3, scale=0.125)
            torch.cuda.synchronize()
            if variant == "kept":
                kept = {"real": real, "flash": flash}
            line = dict(
                variant=variant, round=rnd,
                stdp_ms=graph_ms(torch, lambda: stdp_attention(
                    qs, ks, vs, scale=0.125)),
                flash_ms=graph_ms(torch, lambda: flash_attention(
                    q3, k3, v3, scale=0.125)),
                stdp_spikes_exact=bool(torch.equal(stdp_attention(
                    qs, ks, vs, scale=0.125), spikes_want)),
                stdp_real_err_over_scale=float(
                    ((real - real_want).abs() / real_scale).max()),
                flash_max_abs_err=float((flash - flash_want).abs().max()),
                bit_identical_to_kept=bool(
                    torch.equal(real, kept["real"])
                    and torch.equal(flash, kept["flash"])) if kept else None)
            print(json.dumps(line), flush=True)
    _build._LIBS.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
