#!/usr/bin/env python3
"""Kernel 7 (flash attention, both dtypes) at public models' prefill
layouts, timed on the card for one tree of the port.

    python3 scripts/flash_turns.py [--tree DIR] [--label NAME] [--build-log]

``--tree`` names the root of a checkout of the repository (default: this
one), whose ``src/repro_torch`` is imported and whose kernels are built
from its own sources. Running it over two trees in turns (parent, change,
change, parent) in one call on one card compares two versions of the
kernels. Each layout is a 2048-token causal prefill laid out as the LM
path hands it over (q transposed from (1, S, Hq, Dh), k and v the first S
rows of a (1, KV, 2S, Dh) cache), in f32 and in bf16:

- smollm-360m (15 over 5 heads, Dh 64), glm4-9b (32 over 2, Dh 128),
  stablelm-12b (32 over 8, Dh 160), qwen3-moe-30b-a3b (32 over 4, Dh
  128), phi-3-mini's head dim (32 over 32, Dh 96),
  Qwen3-Next-80B-A3B (16 over 2, Dh 256, its published ``head_dim``),
  DeepSeek-V4-Flash (64 over 1, Dh 512, its published attention layout)
  and sarvam-105b's MLA in its absorbed form (64 heads over one latent of
  576: ``kv_lora_rank`` 512 + ``qk_rope_head_dim`` 64, its ``head_dim``).

A layout's kernel is held to its plain version within atol = rtol = 2e-4
(``max_abs_err``); a tree that refuses the head dim gets ``"refused"``.
Times: ``ms``, device time of one launch by ``torch.profiler`` over 20
calls after 3 warm-ups; ``sdpa_ms``, the same for
``scaled_dot_product_attention`` in the operands' dtype on KV expanded to
the q heads beforehand (every kernel of one call), beside the backend
SDPA takes for those operands (``sdpa_backend``); ``bound_ms``, the
larger of the bytes (q, k, v read once, the f32 output written once) at
3.35 TB/s and the kept (query, key) pairs' products (four operations a
pair and column; f32 counts three TF32 products at 495 TFLOP/s, bf16 one
at 989). ``--build-log`` prints the flash sources' ptxas lines and
times one ``nvcc`` of each flash source alone (``nvcc_s_<source>``). Prints the card's name and power limit,
then one JSON line. Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPS = 20
SEED = 0
TOL = 2e-4
LAYOUTS = {          # name: (q heads, KV heads, Dh)
    "smollm-360m": (15, 5, 64),
    "glm4-9b": (32, 2, 128),
    "stablelm-12b": (32, 8, 160),
    "qwen3-moe-30b-a3b": (32, 4, 128),
    "dh96": (32, 32, 96),
    "qwen3-next-80b-a3b": (16, 2, 256),
    "deepseek-v4-flash": (64, 1, 512),
    "sarvam-105b": (64, 1, 576),
}


def device_ms(torch, fn, name: str = "") -> float:
    """Device view, by torch.profiler over REPS calls: one launch of the
    kernels named ``name``, or with no name every kernel of a call. A
    window in which the profiler saw fewer launches than calls is taken
    again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
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
        if n >= REPS:
            return us / 1e3 / (n if name else REPS)
    raise SystemExit(f"{n} launches of {name!r} in {REPS} calls")


def sdpa_backend(torch, q, k, v, scale: float) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these causal
    operands (its own dispatcher's choice, ``torch._fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(
        q, k, v, None, 0.0, True, scale=scale)).name


def nvcc_seconds(build, source: Path) -> float:
    """Wall seconds of one ``nvcc`` of ``source`` alone, with the tree's
    own flags, into a scratch library beside its build directory."""
    out = build.BUILD_DIR / f"{source.stem}.timing.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(source)], check=True, capture_output=True)
    seconds = time.perf_counter() - t0
    out.unlink()
    return seconds


def max_err(torch, got, want) -> float:
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not bool(((got - want).abs() <= TOL + TOL * want.abs()).all()):
        raise SystemExit(f"off the plain version by {err}")
    return err


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default=None)
    ap.add_argument("--build-log", action="store_true")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        print("flash_turns.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    t0 = time.perf_counter()
    report = _build.build_all()
    res = {"tree": args.label or str(tree),
           "build_s": time.perf_counter() - t0,
           "build_s_by_source": {k: v["seconds"] for k, v in report.items()}}
    if args.build_log:
        for name in ("flash_attention", "flash_attention_tc"):
            if name in report:
                print(f"--- {name}.cu ---")
                print("\n".join(line for line in report[name]["log"].split(
                    "\n") if "ptxas" in line or "bytes" in line
                    or "arning" in line))
            res[f"nvcc_s_{name}"] = nvcc_seconds(_build,
                                                 _build.CSRC / f"{name}.cu")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    s = 2048
    for model, (hq, kvh, dh) in LAYOUTS.items():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            q = torch.randn((1, s, hq, dh), generator=gen, device=dev).to(
                dtype).transpose(1, 2)
            k, v = (torch.randn((1, kvh, 2 * s, dh), generator=gen,
                                device=dev).to(dtype)[:, :, :s]
                    for _ in range(2))
            scale = dh ** -0.5
            call = lambda: flash_attention(  # noqa: E731
                q, k, v, scale=scale)
            try:
                got = call()
            except ValueError:
                res[f"{model}_{name}"] = "refused"
                continue
            row = {"max_abs_err": max_err(
                torch, got, flash_attention_plain(q, k, v, scale=scale))}
            kernel = ("flash_tc_kernel" if dtype == torch.bfloat16
                      else "flash_attention_kernel")
            row["ms"] = device_ms(torch, call, kernel)
            ke, ve = (z.repeat_interleave(hq // kvh, dim=1).contiguous()
                      for z in (k, v))
            qc = q.contiguous()
            row["sdpa_ms"] = device_ms(torch, lambda: sdpa(
                qc, ke, ve, is_causal=True, scale=scale))
            row["sdpa_backend"] = sdpa_backend(torch, qc, ke, ve, scale)
            nbytes = (q.numel() + k.numel() + v.numel()) * q.element_size() \
                + q.numel() * 4
            ops_n = 4 * hq * (s * (s + 1) // 2) * dh
            if dtype == torch.float32:
                ops_t = 3 * ops_n / 495e12
            else:
                ops_t = ops_n / 989e12
            row["bound_ms"] = max(nbytes / 3.35e12, ops_t) * 1e3
            row["bound_share"] = row["bound_ms"] / row["ms"]
            res[f"{model}_{name}"] = row
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
