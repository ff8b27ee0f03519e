#!/usr/bin/env python3
"""How the bf16 tensor cores add inside one ``wgmma``, read through the f32
unpack dot (``csrc/unpack_dot.cu``), and a plain model of it.

    python3 scripts/wgmma_accumulation.py [--out build/wgmma_accumulation.json]

The model (``block_fma``): a ``wgmma`` k16 adds its products to the
accumulator C in groups of ``group`` products; each group's terms, C
among them, are aligned to the largest term's leading bit, keep ``bits``
bits below and including it (dropping the rest: ``align="rz"``, or
rounding it to nearest even: ``"rn"``), are summed exactly, and the sum is
rounded back to f32 (``normalize`` ``"rz"`` or ``"rn"``). ``kept_scheme``
is the kernel's order (each 16-deep slice's hi products from zero, added
to an f32 master sum with round-to-nearest adds; the lo then mid products
into a second accumulator over all of K, added last);
``single_accumulator_scheme`` is an earlier design (each 64-deep K step's
lo, mid and hi products of its four slices into one accumulator from
zero, the step's sum then added to the master sum).

On the card, two probes through the kernel, each held bit for bit to
every candidate model (bits 23-28, groups of 4, 8 and 16, both roundings
at both places):

- ``fresh``: K = 16, one slice, bf16-exact weights (mid = lo = 0), so
  the output is one ``wgmma`` from zero: 16 products of random sign and
  exponents 2^-40..2^0 against 64 spike rows;
- ``fc2``: the whole scheme at fc2's K (2048), the weights of fc2 of the
  paper config's gained tree (lecun normal x 2.8) at a 0.2 firing rate,
  64 rows x 512 columns, for the candidates ``fresh`` leaves at zero
  mismatches; beside them, the plain f32 dot on the card (TF32 off).

Prints the card's name and power limit, one JSON line a probe (the
candidates with their mismatch counts, best first), and writes the whole
report to ``--out``. Needs one CUDA card and ``nvcc``. The model
functions need neither and run on CPU tensors.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SLICE, STEP = 16, 64          # wgmma depth; K a kernel step
# the model H100's tensor cores match in both probes (see PERF.md)
MODEL = {"bits": 26, "group": 16, "align": "rz", "normalize": "rz"}


def _round(x: torch.Tensor, mode: str) -> torch.Tensor:
    return torch.trunc(x) if mode == "rz" else torch.round(x)


def to_f32(s: torch.Tensor, mode: str) -> torch.Tensor:
    """float64 -> float32, rounded to nearest even or toward zero."""
    r = s.to(torch.float32)
    if mode == "rn":
        return r
    over = r.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def block_fma(c: torch.Tensor | None, a: torch.Tensor, w: torch.Tensor, *,
              bits: int, group: int, align: str, normalize: str
              ) -> torch.Tensor:
    """One ``wgmma`` slice as the model adds it: (R, N) f32 C (None: from
    zero) plus the products of (R, k) {0, 1} ``a`` (float64) and (k, N)
    bf16-exact ``w`` (float64), ``group`` products at a time. Returns (R,
    N) f32."""
    c = None if c is None else c.double()
    for g0 in range(0, a.shape[1], group):
        c = _group_fma(c, a[:, g0:g0 + group], w[g0:g0 + group], bits=bits,
                       align=align, normalize=normalize)
    return c.float()


def _group_fma(c, a, w, *, bits, align, normalize):
    """One group of products and C (None: zero), all float64. Where no
    term can hold a bit below the window of the largest term the column
    could have, the aligned sum is the exact sum: one f64 matmul (every
    term a multiple of that window's lowest bit, the sum below 2^(bits +
    5)). The rest of the elements take the term-by-term path."""
    _, lead = torch.frexp(w.abs().amax(0))                     # (N,)
    if c is None:
        slow = (_lowest_bit(w) < lead - bits).expand(a.shape[0], -1)
        s = to_f32(a @ w, normalize).double()
        c = torch.zeros_like(s)
    else:
        _, lead_c = torch.frexp(c)
        lead = torch.maximum(torch.where(c == 0, lead_c.new_tensor(-2000),
                                         lead_c), lead)
        # c is f32: its lowest bit is at or above 2^(lead_c - 24)
        slow = (c != 0) & (lead_c - 24 < lead - bits)
        slow |= (_lowest_bit(w) < lead - bits)
        s = to_f32(c + a @ w, normalize).double()
    if bool(slow.any()):
        r, n = slow.nonzero(as_tuple=True)
        s[r, n] = _aligned_sum(c[r, n], a[r], w[:, n].T, bits=bits,
                               align=align, normalize=normalize)
    return s


def _lowest_bit(w: torch.Tensor) -> torch.Tensor:
    """(k, N) float64 -> (N,) int: the least exponent e with a term of the
    column holding bit 2^e (a large number for an all-zero column)."""
    m, e = torch.frexp(w.abs())
    sig = (m * 2.0 ** 53).long()                 # 53-bit significands
    low = torch.log2((sig & -sig).double()).long() + e.long() - 53
    return torch.where(w == 0, 2000, low).amin(0)


def _aligned_sum(c, a, w, *, bits, align, normalize):
    """Term by term: (n,) C, (n, k) {0, 1} ``a`` and (n, k) ``w``."""
    p = a * w
    big = torch.maximum(c.abs(), p.abs().amax(1))
    _, lead = torch.frexp(big)                 # big = m 2^lead, m in [0.5, 1)
    q = torch.ldexp(torch.ones_like(big), (lead - bits).long())
    s = _round(c / q, align) * q + (_round(p / q[:, None], align)
                                     * q[:, None]).sum(1)
    return to_f32(s, normalize).double()


def split_terms(w: torch.Tensor) -> tuple:
    """(K, N) f32 -> its three bf16 terms hi, mid, lo as float64 (K, N),
    as ``bf16x3_weights`` builds them."""
    hi = w.to(torch.bfloat16).float()
    mid = (w - hi).to(torch.bfloat16).float()
    lo = ((w - hi) - mid).to(torch.bfloat16).float()
    return hi.double(), mid.double(), lo.double()


def kept_scheme(a: torch.Tensor, w: torch.Tensor, **model) -> torch.Tensor:
    """The kernel's arithmetic for (R, K) {0, 1} rows ``a`` (any float
    dtype) and (K, N) f32 ``w``: each slice's hi products from zero, added
    to the master f32 sum with round-to-nearest adds; lo, then mid, into
    a second accumulator over all of K, which the master takes last."""
    a = a.double()
    hi, mid, lo = split_terms(w)
    master = rest = torch.zeros((a.shape[0], w.shape[1]))
    for s0 in range(0, a.shape[1], SLICE):
        sl, aa = slice(s0, s0 + SLICE), a[:, s0:s0 + SLICE]
        master = master + block_fma(None, aa, hi[sl], **model)
        rest = block_fma(rest, aa, lo[sl], **model)
        rest = block_fma(rest, aa, mid[sl], **model)
    return master + rest


def single_accumulator_scheme(a: torch.Tensor, w: torch.Tensor, **model
                              ) -> torch.Tensor:
    """An earlier design's arithmetic: each 64-deep K step's four slices,
    lo, mid then hi products each, into one accumulator from zero, the
    step's sum added to the master f32 sum."""
    a = a.double()
    hi, mid, lo = split_terms(w)
    master = torch.zeros((a.shape[0], w.shape[1]))
    for k0 in range(0, a.shape[1], STEP):
        acc = torch.zeros_like(master)
        for s0 in range(k0, min(k0 + STEP, a.shape[1]), SLICE):
            sl, aa = slice(s0, s0 + SLICE), a[:, s0:s0 + SLICE]
            for term in (lo, mid, hi):
                acc = block_fma(acc, aa, term[sl], **model)
        master = master + acc
    return master


def candidates() -> list:
    return [dict(bits=b, group=g, align=al, normalize=no)
            for b, g, al, no in itertools.product(
                range(23, 29), (4, 8, 16), ("rz", "rn"), ("rz", "rn"))]


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())


def fresh_inputs(gen: torch.Generator, rows: int = 64, cols: int = 1024):
    """K = 16 spike rows and bf16-exact weights: the first product of each
    column near 1, the other 15 of random sign and exponent 2^-40..2^0."""
    a = (torch.rand((rows, SLICE), generator=gen) < 0.5).float()
    a[0] = 1.0
    sig = 1.0 + torch.randint(0, 128, (SLICE, cols), generator=gen) / 128.0
    exp = -torch.randint(0, 41, (SLICE, cols), generator=gen).float()
    exp[0] = 0.0
    sign = torch.where(torch.rand((SLICE, cols), generator=gen) < 0.5,
                       -1.0, 1.0)
    return a, (sign * sig * torch.exp2(exp)).float()


def fc2_inputs(gen: torch.Generator, rows: int = 64, cols: int = 512,
               k: int = 2048):
    """fc2's K, the law of fc2 in the paper config's gained tree (lecun
    normal, BN folded at init, x 4 x 0.7), spikes at a 0.2 rate."""
    a = (torch.rand((rows, k), generator=gen) < 0.2).float()
    w = torch.randn((k, cols), generator=gen) * (2.8 / k ** 0.5)
    return a, w.float()


def _kernel(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels.spike_matmul import (bf16x3_weights,
                                                  spike_matmul_grouped)
    dev = torch.device("cuda")
    x = a.to(torch.uint8)[None].to(dev)          # one group, plane 0
    wd = w.to(dev)
    out = spike_matmul_grouped(x, wd, t=1, w_bf16x3=bf16x3_weights(wd))
    return out[0].cpu()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/wgmma_accumulation.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    if not torch.cuda.is_available():
        print("wgmma_accumulation.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    report = {}

    a, w = fresh_inputs(gen)
    got = _kernel(a, w)
    fresh = []
    for cand in candidates():
        want = block_fma(None, a.double(), w.double(), **cand)
        fresh.append({**cand, "mismatches": mismatches(got, want)})
    fresh.sort(key=lambda r: r["mismatches"])
    report["fresh"] = {"outputs": got.numel(), "candidates": fresh}

    a, w = fc2_inputs(gen)
    got = _kernel(a, w)
    exact = a.double() @ w.double()
    plain = (a.cuda() @ w.cuda()).cpu()
    fc2 = []
    for cand in [c for c in fresh if c["mismatches"] == 0] or fresh[:4]:
        model = {k: cand[k] for k in MODEL}
        want = kept_scheme(a, w, **model)
        fc2.append({**model, "mismatches": mismatches(got, want)})
    fc2.sort(key=lambda r: r["mismatches"])
    report["fc2"] = {
        "outputs": got.numel(), "candidates": fc2,
        "plain_f32_mismatches": mismatches(got, plain),
        "kernel_max_abs_err_vs_f64": float((got.double() - exact).abs()
                                           .max()),
        "plain_f32_max_abs_err_vs_f64": float((plain.double() - exact)
                                              .abs().max())}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"
    report["device"] = smi
    print(smi)
    for probe in ("fresh", "fc2"):
        r = dict(report[probe])
        r["candidates"] = r["candidates"][:8]
        print(json.dumps({"probe": probe, **r}))
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
