#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; fails without them. It

1. builds the ten CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. runs each kernel at the shapes its main path gives it (the Spikformer
   kernels at batch 8: TFLIF at fc1 and, through a stride-0 view, at
   conv0; the LUT gather's packed entry at q/k/v, path A's fc1 with an f32
   table and conv0, each also through the index-byte entry; the grouped
   unpack dot on the int8 tensor cores
   over the plan's K-major weights, packed STDP on the backend's
   plane-group layout,
   bf16 flash attention on the tensor cores at smollm-360m's 2048-token
   prefill with its 15 heads over 5 KV heads read in place, and the f32
   kernels of the unpack dot, STDP and flash attention on the CUDA cores),
   holds it
   against its plain PyTorch version on the card and times kernel, plain
   version and the nearest single PyTorch call (the kernel by its device
   time under ``torch.profiler`` and the library call by CUDA events
   around a captured graph of its calls, since a call's host cost exceeds
   some kernels' own time; ``ms_events`` keeps the CUDA-event view of the
   kernel, the plain version is timed by CUDA events);
3. drives four paths of the full-width Spikformer V2-8-512 (224x224x3,
   T=4, 8 blocks, 1000 classes) from one seeded ``init`` (fixed gains on
   the folded kernels keep the IAND residual stream firing), each with
   the launch counts set to 0 just before it and read just after (the
   wrappers' counters, which eager steps and captures tick, plus each
   captured graph's launches times its replays; a graphed model must
   launch nothing eagerly):
   - int8 weights under the default plan, served with ``jit=True`` (one
     CUDA graph a bucket) through ``MicroBatchEngine`` (TFLIF, LUT gather,
     int8 unpack dot, packed STDP);
   - f32 weights with ``route="lut"``, the same requests, graphed (every
     layer gathers, the MLP pair runs the fused kernel);
   - int8 weights with ``route="unpack"``, one graphed bucket-8 step
     (conv0 runs the shift-sum kernel, every other layer the int8 unpack
     dot);
   - the route fit: ``repro_torch.launch.autotune_routes``' int8 ``--cuda
     --fast`` fit on the card (fragment in ``build/routes_int8.json``),
     then the int8 model under the reference's and the fitted constants,
     each eager and graphed, serving the requests, profiled, and timed
     layer by layer with ``profile_step``;
   and checks every request completes, each count grew by its per-step
   count times the steps taken, the final residual stream still fires, and
   one bucket-8 batch gives bit-identical logits across the graph replay,
   the eager step and the plain versions (``packed_plain``) on the card
   and, for the f32 LUT path, the unfused MLP step and the float
   ``reference`` backend; each path's bucket-8 step is profiled graphed
   and eager; then the serving stack (``serving_stack``), and three paths
   on the reference's default backend ``packed``, each gated to run the
   kernels and never the reference's CPU branch:
   - ``events_cli``: ``serve_spikformer.main --events --smoke`` on the
     synthetic trace and on the committed ``dvs_synth_mini.jsonl`` (the
     reference's event config and default plan; the CLI's own gates),
     then ``main_events`` on the fixture with the gained tree, whose
     logits on the trace's count frames are bit-identical to
     ``packed_plain``'s at buckets 2 and 8 and whose labels are not all
     one class;
   - ``events_full_width``: four ``EventStreamSession``s on one runtime,
     each fed a seeded DVS stream at 128x128 (40 windows of 20 ms) at
     V2-8-512, int8, graphed, served untraced (windows/s, latencies) and
     again under ``torch.profiler`` (idle share); every window labelled,
     each label equal to ``classify`` of its count frame and in both
     passes, not all one class, the logits on the count frames
     bit-identical to ``packed_plain``'s at buckets 1 and 8; each
     bucket's step profiled;
   - ``packed_default_f32``: ``ExecutionPlan()`` as the reference defines
     it (``packed``, f32, bucket 8), graphed: 49 f32 unpack-dot launches a
     step, logits against ``packed_plain``'s, the unpack dot timed at each
     of its layer shapes (CUDA events around a captured graph whose
     capture launched the kernel once a call, and ``torch.profiler``);
4. drives the LM path: smollm-360m at full width from a seeded
   ``init_model``, ``Engine(slots=4, cache_len=4096)`` in bf16 serving 8
   requests (prompts of 77 to 2048 tokens, 32 new tokens each), every
   prefill's attention on the bf16 tensor-core flash kernel, in three
   passes over the same weights, counters set to 0 just before each and
   read just after: an eager engine (``jit=False``); a graphed one
   (``jit=True``: decode one CUDA graph, prefill one a prompt length),
   cold, capturing the 8 lengths; the same engine warm, every call a
   replay. Checks every request completes, its 32 tokens are identical
   across the passes, and each pass ran 32 layers x 8 prefills of the
   flash kernel (eagerly, or replayed with nothing launched eagerly
   beyond each new graph's warm-up run and capture); profiles the
   2048-token prefill and a four-slot decode step eager and graphed; then,
   counters at 0 again, holds one f32 prefill's logits on the flash route
   (the f32 flash kernel, once a layer) against the plain route;
5. trains ``SpikformerConfig()`` from the seeded ``init`` for 5 AdamW
   steps at batch 16 (eager surrogate-gradient BPTT, BN on batch
   statistics), gating finite losses and gradients, nonzero gradient
   norms at conv0 and in the last block, changed parameters and a firing
   last residual; holds the reduced training step on the card to the same
   step on the CPU; runs ``examples/torch_classify_spikformer.py`` at its
   defaults (loss falls, accuracy above chance, ``packed`` logits equal to
   ``reference``'s);
6. runs ``examples/torch_quickstart.py`` (launching the f32 STDP, the f32
   unpack dot, the shift-sum and TFLIF kernels) and short forms of the
   three serving examples, and prints the analytic engine model's frames
   per second beside the card's served rate.

Prints the serving stats and profiles as JSON lines, the fitted route
constants (``route_fit``) and the 2x2 of constants x ``jit``
(``route_cells``: device and wall ms, idle share, images/s, peak memory,
launches a step, ``profile_step``'s per-route sums), the card's name and
power limit, the kernel table, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
A full report goes to ``build/chip_smoke.json``. Any failed check
exits non-zero before the last line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 8
REQUEST_SIZES = (1, 8, 3, 5, 8)     # 25 images: three bucket-8 steps + one 1
GAIN, GAIN_RESIDUAL = 4.0, 0.7       # kernel gains; wo/fc2 get both
FIRING_RATE = 0.2
REPS = 20
PROFILE_TRIES = 3
PROFILE_WINDOWS: dict = {}   # kernel counter -> device_ms windows

# the LM path: smollm-360m at full width, 8 requests of these prompt lengths
LM_ARCH = "smollm-360m"
LM_HEADS, LM_HEAD_DIM = 15, 64
LM_PROMPTS = (77, 128, 300, 512, 640, 1000, 1536, 2048)
LM_MAX_NEW = 32
LM_SLOTS, LM_CACHE_LEN = 4, 4096
LM_GATE_LEN = 1000
FLASH_TOL = 2e-4       # the reference's own flash tests' rtol = atol
LM_LOGITS_TOL = 1e-4   # f32 prefill logits, flash route against plain

# published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12

SOURCES = {
    "tflif": ("src/repro_torch/kernels/csrc/tflif.cu",
              "src/repro/kernels/tflif.py:65"),
    "lut_gather": ("src/repro_torch/kernels/csrc/lut_gather.cu",
                   "src/repro/kernels/spike_matmul.py:173"),
    "unpack_dot": ("src/repro_torch/kernels/csrc/unpack_dot.cu",
                   "src/repro/kernels/spike_matmul.py:225"),
    "unpack_dot_s8": ("src/repro_torch/kernels/csrc/unpack_dot_s8.cu",
                      "src/repro/kernels/spike_matmul.py:225"),
    "stdp": ("src/repro_torch/kernels/csrc/stdp.cu",
             "src/repro/kernels/stdp_attention.py:45"),
    "stdp_packed": ("src/repro_torch/kernels/csrc/stdp_packed.cu",
                    "src/repro/kernels/stdp_attention.py:45"),
    "fused_lif_lut": ("src/repro_torch/kernels/csrc/fused_lif_lut.cu",
                      "src/repro/kernels/fused.py:80"),
    "shift_sum": ("src/repro_torch/kernels/csrc/shift_sum.cu",
                  "src/repro/kernels/spike_matmul.py:69"),
    "flash_attention_tc": (
        "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        "src/repro/kernels/flash_attention.py:62"),
    "flash_attention_f32": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:62"),
}
# kernels that no driven path launches (since the quickstart drives the f32
# STDP, none)
OFF_PATH = ()


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def bound_ms(bytes_moved: float, ops: float, ops_per_s: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def unpack_dot_bound_ms(x, w, out):
    """The f32 unpack dot's bound: x, the three bf16 terms of w and the
    f32 output moved once, against its three bf16 products (a spike times
    each term, summed in f32) at the dense bf16 tensor rate."""
    t, m, n = out.shape
    return bound_ms(x.numel() + 3 * w.numel() * 2 + out.numel() * 4,
                    3 * 2 * t * m * w.shape[0] * n, BF16_OPS_PER_S)


def max_abs_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def time_ms(torch, fn, reps: int = REPS) -> float:
    """Mean ms per call over ``reps`` calls after a warm-up, by CUDA
    events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def traced(torch, warm, body) -> tuple:
    """``torch.profiler`` (CPU and CUDA activity) over ``body()``, after a
    traced ``warm()`` whose records it discards (its schedule's warm-up
    step): late in a long process the profiler can lose the first kernel
    records of a session (five of every window, where it did), and the
    warm-up step takes that loss. Returns ``(key_averages, events)`` of
    ``body()`` alone."""
    import warnings

    from torch.profiler import ProfilerActivity, profile, schedule

    out = []
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", ".*Profiler clears events")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: out.append(
                         (p.key_averages(), p.events()))) as prof:
            for part in (warm, body):
                part()
                torch.cuda.synchronize()
                prof.step()
    check(len(out) == 1, f"the profiler traced {len(out)} windows, not 1")
    return out[0]


def device_ms(torch, fn, name: str, reps: int = REPS) -> float:
    """Device ms of one launch of the kernels whose name holds ``name``, by
    ``torch.profiler`` (CUDA activity) over ``reps`` calls after a warm-up
    and ``reps`` traced warm-up calls (``traced``):
    the kernel alone, free of the host's launch cost, which exceeds some
    kernels' own time. Each call must launch one of the port's kernels, by
    the wrappers' own counts over the window: a window in which the
    wrappers launched anything but ``reps`` fails at once. A window in
    which the profiler shows fewer of those launches than were made (its
    records are not always complete) is taken again, up to PROFILE_TRIES
    windows in all; every window's count goes into PROFILE_WINDOWS, under
    the kernel's counter, for ``build/chip_smoke.json``."""
    ms, seen = profiled_ms(torch, fn, name, reps)
    check(ms is not None, f"device_ms: the profiler showed {seen} of {reps} "
          f"launches of {name!r} in {PROFILE_TRIES} windows")
    return ms


def profiled_ms(torch, fn, name: str, reps: int = REPS) -> tuple:
    """``device_ms``'s measurement without its last gate: ``(ms, seen)``,
    ``ms`` None where no window showed all ``reps`` launches, ``seen`` the
    profiler's count in each window. A short window also records, in
    PROFILE_WINDOWS, the host's launch calls the profiler saw and each
    kernel record's start, in us after the first launch call, so that the
    records it lost can be placed."""
    from torch.autograd import DeviceType

    from repro_torch.kernels import ops

    def calls():
        for _ in range(reps):
            fn()

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen, short = [], []
    for _ in range(PROFILE_TRIES):
        with ops.recording_launches() as launched:
            averages, events = traced(torch, calls, calls)
        check(len(launched) == 1 and sum(launched.values()) == 2 * reps,
              f"device_ms: the wrappers launched {launched} in 2 x {reps} "
              f"calls timed as {name!r}")
        [counter] = launched
        us, n = 0.0, 0
        for ev in averages:
            if ev.device_type == DeviceType.CUDA and name in ev.key:
                t = getattr(ev, "self_device_time_total", None)
                us += ev.self_cuda_time_total if t is None else t
                n += ev.count
        seen.append(n)
        check(n <= reps, f"device_ms: the profiler shows {n} launches of "
              f"{name!r}, the wrappers made {reps}")
        if n == reps:
            break
        launch_calls = [e.time_range.start for e in events
                        if e.device_type == DeviceType.CPU
                        and "LaunchKernel" in e.name]
        t0 = min(launch_calls, default=0.0)
        short.append({"launch_calls_seen": len(launch_calls),
                      "kernel_start_us": [
                          round(e.time_range.start - t0, 1) for e in events
                          if e.device_type == DeviceType.CUDA
                          and name in e.name],
                      "launch_call_us": [round(c - t0, 1)
                                         for c in launch_calls]})
    PROFILE_WINDOWS.setdefault(counter, []).append(
        {"kernel": name, "launched": reps, "seen": seen,
         "windows": len(seen), "short_windows": short})
    return (us / 1e3 / n if n == reps else None), seen


def graph_ms(torch, fn, reps: int = REPS,
             kernel: str | None = None) -> float:
    """Device ms per call of ``fn`` by CUDA events around the replay of
    one CUDA graph of ``reps`` captured calls, best of three replays: the
    host's launch cost stays out, as in the route fit's ``graph_time``.
    The wrappers' counts over the capture must show ``reps`` launches of
    ``kernel`` (a port kernel's counter; one more for ``graph_time``'s
    eager call before it), and none of any port kernel where ``kernel`` is
    None (a library call)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.autotune_routes import graph_time
    with ops.recording_launches() as launched:
        ms = graph_time(fn, inner=reps, repeats=3) * 1e3
    want = {kernel: reps + 1} if kernel else {}
    check({k: v for k, v in launched.items() if v} == want,
          f"graph_ms: the wrappers launched {launched}, want {want}")
    return ms


def kernel_phase(torch, dev) -> dict:
    """Each kernel at its main-path shape against its plain version."""
    from repro_torch.core.spike import pack_timesteps, unpack_timesteps
    from repro_torch.kernels import lut_matmul as lut
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused import tflif_lut_matmul, tflif_lut_plain
    from repro_torch.kernels.spike_matmul import (bf16x3_weights,
                                                  kmajor_weights,
                                                  lut_gather_matmul,
                                                  lut_gather_packed,
                                                  lut_gather_packed_plain,
                                                  shift_sum_matmul,
                                                  spike_matmul,
                                                  spike_matmul_grouped,
                                                  spike_matmul_grouped_s8)
    from repro_torch.kernels.stdp_attention import (
        stdp_attention, stdp_attention_packed, stdp_attention_packed_plain)
    from repro_torch.kernels.tflif import tflif_fused, tflif_plain

    gen = torch.Generator(device=dev).manual_seed(SEED)
    t, tokens, dim, heads = 4, 196, 512, 8
    m = BATCH * tokens

    def spikes(*shape):
        return (torch.rand(shape, generator=gen, device=dev)
                < FIRING_RATE).to(torch.uint8)

    out = {}

    # TFLIF at fc1's LIF: (4, 8*196*2048) accumulators, per-channel v_th
    hidden = 4 * dim
    x = torch.randn((t, m * hidden), generator=gen, device=dev) * 2.0
    bias = torch.randn(hidden, generator=gen, device=dev) * 0.1
    vth = 0.5 + torch.rand(hidden, generator=gen, device=dev)
    got, want = tflif_fused(x, bias, vth), tflif_plain(x, bias, vth)
    check(torch.equal(got, want), "tflif kernel differs from its plain version")
    err = max_abs_err(got, want)
    nbytes = x.numel() * 4 + bias.numel() * 4 + vth.numel() * 4 + got.numel()
    b_ms, b_by = bound_ms(nbytes, 5 * x.numel(), F32_OPS_PER_S)
    # conv0's LIF through ops.tflif_pack: the (8, 112, 112, 64)
    # accumulators expanded over T, read in place by the kernel
    acc0 = torch.randn((BATCH, 112, 112, 64), generator=gen, device=dev) * 40
    acc0x = acc0.unsqueeze(0).expand(t, *acc0.shape)
    b0 = torch.randn(64, generator=gen, device=dev)
    got0 = ops.tflif_pack(acc0x, b0)
    want0 = ops.tflif_pack(acc0x.contiguous(), b0, plain=True)
    check(torch.equal(got0, want0),
          "tflif kernel (conv0, stride-0 x) differs from its plain version")
    out["tflif"] = dict(
        shape=f"x {tuple(x.shape)} f32, per-channel bias/v_th ({hidden},); "
              f"conv0: x {tuple(acc0x.shape)} expanded over T (stride 0)",
        max_abs_err=max(err, max_abs_err(got0, want0)),
        firing_rate=float(unpack_timesteps(got, t).mean()),
        ms=device_ms(torch, lambda: tflif_fused(x, bias, vth), "tflif_kernel"),
        ms_events=time_ms(torch, lambda: tflif_fused(x, bias, vth)),
        ms_conv0_stride0=device_ms(torch, lambda: ops.tflif_pack(acc0x, b0),
                                   "tflif_kernel"),
        plain_ms=time_ms(torch, lambda: tflif_plain(x, bias, vth)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del acc0, acc0x, got0, want0

    # LUT gather, packed entry (the one the driven paths call), at q/k/v:
    # (1, 1568, 512) packed spikes, t = 4, x (64, 256, 512) int16; every
    # shape also through the index-byte entry, all held bit-exact to
    # lut_matmul over plane_indices
    xq = pack_timesteps(spikes(t, m, dim))                   # (1, M, 512)
    idx = lut.plane_indices(xq)[:t].contiguous()
    w_int = torch.randint(-127, 128, (dim, dim), generator=gen,
                          device=dev).to(torch.int8)
    tbl16 = lut.build_lut(w_int)
    errs = []

    def held(x8, tt, tbl, what):
        want = lut.lut_matmul(lut.plane_indices(x8)[:tt], tbl)
        got = lut_gather_packed(x8, tbl, t=tt)
        check(torch.equal(got, want),
              f"lut_gather ({what}, packed entry) differs from its plain "
              "version")
        ix = lut.plane_indices(x8)[:tt].contiguous()
        check(torch.equal(lut_gather_matmul(ix, tbl), want),
              f"lut_gather ({what}, index bytes) differs from its plain "
              "version")
        errs.append(max_abs_err(got, want))

    held(xq, t, tbl16, "q/k/v, int16 table")
    w_f32 = torch.randn((dim, dim), generator=gen, device=dev)
    held(xq, t, lut.build_lut(w_f32), "q/k/v, f32 table")
    # path A's fc1: the same spikes x (64, 256, 2048) f32 (128 MiB)
    w1f = torch.randn((dim, hidden), generator=gen, device=dev)
    tbl1 = lut.build_lut(w1f)
    held(xq, t, tbl1, "fc1, f32 table")
    # conv0 of the main path: SSSC value planes of a batch of 8 images
    img = torch.randint(0, 256, (BATCH * 112 * 112, 12), generator=gen,
                        device=dev).to(torch.uint8)
    img3 = img[None]
    tbl0 = lut.build_lut(torch.randint(-127, 128, (12, 64), generator=gen,
                                       device=dev).to(torch.int8))
    tbl0f = lut.build_lut(torch.randn((12, 64), generator=gen, device=dev))
    held(img3, 8, tbl0, "conv0, int16 table")
    held(img3, 8, tbl0f, "conv0, f32 table")
    planes = unpack_timesteps(xq, t).reshape(t * m, dim)
    wf = w_int.to(torch.float32)
    c_, n_ = tbl16.shape[0], tbl16.shape[-1]
    b_ms, b_by = bound_ms(xq.numel() + tbl16.numel() * 2 + t * m * n_ * 4,
                          t * m * c_ * n_, F32_OPS_PER_S)
    b1_ms, _ = bound_ms(xq.numel() + tbl1.numel() * 4
                        + t * m * hidden * 4, t * m * c_ * hidden,
                        F32_OPS_PER_S)
    out["lut_gather"] = dict(
        shape=f"x {tuple(xq.shape)} u8 packed spikes, t={t} x table "
              f"{tuple(tbl16.shape)} int16 (q/k/v); also fc1's f32 table "
              f"{tuple(tbl1.shape)} and conv0's value planes "
              f"{tuple(img3.shape)}, t=8, x tables {tuple(tbl0.shape)}",
        max_abs_err=max(errs),
        ms=device_ms(torch, lambda: lut_gather_packed(xq, tbl16, t=t),
                     "lut_gather_kernel"),
        ms_index_entry=device_ms(torch, lambda: lut_gather_matmul(idx, tbl16),
                                 "lut_gather_kernel"),
        ms_events=time_ms(torch, lambda: lut_gather_packed(xq, tbl16, t=t)),
        plain_ms=time_ms(torch, lambda: lut_gather_packed_plain(xq, tbl16,
                                                                t=t)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(torch, lambda: torch.matmul(planes, wf)),
        ms_fc1_f32=device_ms(torch, lambda: lut_gather_packed(xq, tbl1, t=t),
                             "lut_gather_kernel"),
        bound_ms_fc1_f32=b1_ms,
        library_ms_fc1_f32=graph_ms(torch, lambda: torch.matmul(planes, w1f)),
        ms_conv0_int16=device_ms(torch, lambda: lut_gather_packed(
            img3, tbl0, t=8), "lut_gather_kernel"),
        ms_conv0_f32=device_ms(torch, lambda: lut_gather_packed(
            img3, tbl0f, t=8), "lut_gather_kernel"))
    del tbl1

    # grouped unpack dot on the int8 tensor cores at fc1: (1, 1568, 512) u8
    # x (512, 2048) int8, the K-major copy made as the plan makes it, once
    w1i = torch.randint(-127, 128, (dim, hidden), generator=gen,
                        device=dev).to(torch.int8)
    w1 = w1i.to(torch.float32)
    w1k = kmajor_weights(w1i)
    got = spike_matmul_grouped_s8(xq, w1k, t=t)
    want = ref.spike_matmul_ref(xq, w1, t=t)
    check(torch.equal(got, want),
          "unpack_dot_s8 differs from its plain version")
    err = max_abs_err(got, want)
    # conv3 (8*14*14 rows, 1024 -> 512) and fc2 (2048 -> 512) of the path
    for rows, k_in, n_out in ((BATCH * tokens, 4 * 256, dim),
                              (m, hidden, dim)):
        xs = pack_timesteps(spikes(t, rows, k_in))
        ws = torch.randint(-127, 128, (k_in, n_out), generator=gen,
                           device=dev).to(torch.int8)
        check(torch.equal(spike_matmul_grouped_s8(xs, kmajor_weights(ws),
                                                  t=t),
                          ref.spike_matmul_ref(xs, ws.to(torch.float32),
                                               t=t)),
              f"unpack_dot_s8 differs from its plain version at K={k_in}")
    planes_s8 = planes.to(torch.int8)
    check(torch.equal(torch._int_mm(planes_s8, w1i).to(torch.float32),
                      want.reshape(t * m, hidden)),
          "torch._int_mm does not compute the unpack dot")
    b_ms, b_by = bound_ms(xq.numel() + w1i.numel() + got.numel() * 4,
                          2 * t * m * dim * hidden, INT8_OPS_PER_S)
    out["unpack_dot_s8"] = dict(
        shape=f"x {tuple(xq.shape)} u8 x w {tuple(w1i.shape)} int8 (K-major"
              f" copy {tuple(w1k.shape)}), t={t} (fc1)", max_abs_err=err,
        ms=device_ms(torch, lambda: spike_matmul_grouped_s8(xq, w1k, t=t),
                     "unpack_dot_s8_kernel"),
        ms_events=time_ms(torch, lambda: spike_matmul_grouped_s8(xq, w1k,
                                                                 t=t)),
        plain_ms=time_ms(torch, lambda: ref.spike_matmul_ref(xq, w1, t=t)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(torch, lambda: torch.matmul(planes, w1)),
        library_int8_ms=graph_ms(torch, lambda: torch._int_mm(planes_s8,
                                                             w1i)))

    # the f32 grouped unpack dot (on the bf16 tensor cores, over the
    # weights' three-term split, built once as the planner builds it) at
    # the same shape; the driven default f32 plan's shapes are timed in
    # ``packed_default_f32_phase``
    w1s = bf16x3_weights(w1)
    got = spike_matmul_grouped(xq, w1, t=t, w_bf16x3=w1s)
    want = ref.spike_matmul_ref(xq, w1, t=t)
    check(torch.equal(got, want),
          "unpack_dot (integer weights) differs from its plain version")
    err = max_abs_err(got, want)
    w1f = torch.randn((dim, hidden), generator=gen, device=dev)
    gotf = spike_matmul_grouped(xq, w1f, t=t, w_bf16x3=bf16x3_weights(w1f))
    wantf = ref.spike_matmul_ref(xq, w1f, t=t)
    err_f = float((gotf - wantf).abs().max())
    # f32 weights: sums of up to 512 terms in another order; tolerance
    # atol 1e-3 + rtol 1e-5 (|sums| stay below ~100, ulp ~1e-5)
    check(bool(((gotf - wantf).abs() <= 1e-3 + 1e-5 * wantf.abs()).all()),
          f"unpack_dot (f32 weights) off by {err_f}")
    b_ms, b_by = unpack_dot_bound_ms(xq, w1, got)
    out["unpack_dot"] = dict(
        shape=f"x {tuple(xq.shape)} u8 x w {tuple(w1.shape)} int-valued f32"
              f" (its bf16 split), t={t}", max_abs_err=err,
        max_abs_err_f32_weights=err_f,
        ms=device_ms(torch, lambda: spike_matmul_grouped(
            xq, w1, t=t, w_bf16x3=w1s), "unpack_dot_kernel"),
        ms_events=time_ms(torch, lambda: spike_matmul_grouped(
            xq, w1, t=t, w_bf16x3=w1s)),
        plain_ms=time_ms(torch, lambda: ref.spike_matmul_ref(xq, w1, t=t)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(torch, lambda: torch.matmul(planes, w1)))

    # STDP at (T*B*heads, N, Dh) = (256, 196, 64)
    bh, dh = t * BATCH * heads, dim // heads
    q, k, v = (spikes(bh, tokens, dh).to(torch.float32) for _ in range(3))
    got = stdp_attention(q, k, v, scale=0.125)
    want = ref.stdp_attention_ref(q, k, v, scale=0.125)
    check(torch.equal(got, want), "stdp kernel differs from its plain version")
    err = max_abs_err(got, want)
    v8 = v * 0.125
    check(torch.equal(torch.bmm(torch.bmm(q, k.mT), v8), want),
          "two bmms do not compute the STDP function")
    b_ms, b_by = bound_ms(4 * q.numel() * 4, 4 * bh * tokens * tokens * dh,
                          INT8_OPS_PER_S)
    out["stdp"] = dict(
        shape=f"q, k, v {tuple(q.shape)} f32 spikes",
        max_abs_err=err,
        ms=device_ms(torch, lambda: stdp_attention(q, k, v, scale=0.125),
                     "stdp_kernel"),
        ms_events=time_ms(torch, lambda: stdp_attention(q, k, v,
                                                        scale=0.125)),
        plain_ms=time_ms(torch, lambda: ref.stdp_attention_ref(
            q, k, v, scale=0.125)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(torch, lambda: torch.bmm(torch.bmm(q, k.mT), v8)))

    # packed STDP at the same work: (G, B, H, N, Dh) = (1, 8, 8, 196, 64)
    # plane groups, the permuted view of (1, 8, 196, 512) that the backend's
    # ``to_heads`` passes, t = 4
    qp, kp, vp = (pack_timesteps(spikes(t, BATCH, tokens, dim)).reshape(
        1, BATCH, tokens, heads, dh).permute(0, 1, 3, 2, 4)
        for _ in range(3))
    got = stdp_attention_packed(qp, kp, vp, t=t, scale=0.125)
    want = stdp_attention_packed_plain(qp, kp, vp, t=t, scale=0.125)
    check(torch.equal(got, want),
          "stdp_packed kernel differs from its plain version")
    err = max_abs_err(got, want)
    qf, kf, vf = (unpack_timesteps(z.reshape(1, -1, tokens, dh), t).reshape(
        -1, tokens, dh).contiguous() for z in (qp, kp, vp))
    vf8 = vf * 0.125
    check(torch.equal(torch.bmm(torch.bmm(qf, kf.mT), vf8).reshape(
        got.shape), want), "two bmms do not compute the packed STDP function")
    nbytes = 3 * qp.numel() + got.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 4 * t * BATCH * heads * tokens * tokens * dh,
                          BF16_OPS_PER_S)
    out["stdp_packed"] = dict(
        shape=f"q, k, v {tuple(qp.shape)} u8 plane groups (permuted view),"
              f" t={t}", max_abs_err=err,
        ms=device_ms(torch, lambda: stdp_attention_packed(
            qp, kp, vp, t=t, scale=0.125), "stdp_packed_kernel"),
        ms_events=time_ms(torch, lambda: stdp_attention_packed(
            qp, kp, vp, t=t, scale=0.125)),
        plain_ms=time_ms(torch, lambda: stdp_attention_packed_plain(
            qp, kp, vp, t=t, scale=0.125)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(torch, lambda: torch.bmm(torch.bmm(qf, kf.mT),
                                                    vf8)))

    # fused fc1 LIF -> fc2 gather: x (4, 1568, 2048), table (256, 256, 512)
    x1 = torch.randn((t, m, hidden), generator=gen, device=dev) * 2.0
    w2i = torch.randint(-127, 128, (hidden, dim), generator=gen,
                        device=dev).to(torch.int8)
    w2f = torch.randn((hidden, dim), generator=gen, device=dev)
    tbl2i, tbl2f = lut.build_lut(w2i), lut.build_lut(w2f)
    for tbl in (tbl2i, tbl2f):
        (gs, ga), (ws, wa) = (tflif_lut_matmul(x1, bias, tbl, vth),
                              tflif_lut_plain(x1, bias, tbl, vth))
        check(torch.equal(gs, ws) and torch.equal(ga, wa),
              f"fused_lif_lut ({tbl.dtype} table) differs from its plain "
              "version")
    err = max(max_abs_err(gs, ws), max_abs_err(ga, wa))
    fc1_planes = unpack_timesteps(ws, t).reshape(t * m, hidden)
    nbytes = (x1.numel() * 4 + 2 * hidden * 4 + tbl2f.numel() * 4
              + gs.numel() + ga.numel() * 4)
    b_ms, b_by = bound_ms(nbytes, t * m * tbl2f.shape[0] * dim,
                          F32_OPS_PER_S)
    out["fused_lif_lut"] = dict(
        shape=f"x {tuple(x1.shape)} f32, per-channel bias/v_th ({hidden},)"
              f" x table {tuple(tbl2f.shape)} f32 (path A's fc1 -> fc2)",
        max_abs_err=err, firing_rate=float(fc1_planes.mean()),
        ms=device_ms(torch, lambda: tflif_lut_matmul(x1, bias, tbl2f, vth),
                     "fused_lif_lut_kernel"),
        ms_events=time_ms(torch, lambda: tflif_lut_matmul(x1, bias, tbl2f,
                                                          vth)),
        ms_int16_table=device_ms(torch, lambda: tflif_lut_matmul(
            x1, bias, tbl2i, vth), "fused_lif_lut_kernel"),
        plain_ms=time_ms(torch, lambda: tflif_lut_plain(x1, bias, tbl2f,
                                                        vth)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(torch, lambda: torch.matmul(fc1_planes, w2f)))

    # shift-sum dot at conv0: (8*112*112, 12) pixel bytes x (12, 64)
    w0i = torch.randint(-127, 128, (12, 64), generator=gen,
                        device=dev).to(torch.float32)
    w0f = torch.randn((12, 64), generator=gen, device=dev)
    got = shift_sum_matmul(img, w0i)
    want = ref.spike_matmul_ref(img, w0i, mode="shift_sum")
    check(torch.equal(got, want),
          "shift_sum (integer weights) differs from its plain version")
    err = max_abs_err(got, want)
    gotf = shift_sum_matmul(img, w0f)
    wantf = ref.spike_matmul_ref(img, w0f, mode="shift_sum")
    err_f = max_abs_err(gotf, wantf)
    # f32 weights: the plain version sums 8 per-plane dots scaled by up to
    # 2^7, so its rounding is ~1e-3 absolute: atol 1e-3 + rtol 1e-5
    check(bool(((gotf - wantf).abs() <= 1e-3 + 1e-5 * wantf.abs()).all()),
          f"shift_sum (f32 weights) off by {err_f}")
    per = spike_matmul(img, w0i, mode="per_plane")
    check(torch.equal(per, ref.spike_matmul_ref(img, w0i, mode="per_plane")),
          "per_plane spike_matmul differs from its plain version")
    xf = img.to(torch.float32)
    check(torch.equal(torch.matmul(xf, w0i), want),
          "torch.matmul does not compute the shift-sum function")
    b_ms, b_by = bound_ms(img.numel() + w0i.numel() * 4 + got.numel() * 4,
                          2 * img.numel() * 64, F32_OPS_PER_S)
    out["shift_sum"] = dict(
        shape=f"x {tuple(img.shape)} u8 x w {tuple(w0i.shape)} int-valued "
              "f32 (path B's conv0)",
        max_abs_err=err, max_abs_err_f32_weights=err_f,
        ms=device_ms(torch, lambda: shift_sum_matmul(img, w0i),
                     "shift_sum_kernel"),
        ms_events=time_ms(torch, lambda: shift_sum_matmul(img, w0i)),
        plain_ms=time_ms(torch, lambda: ref.spike_matmul_ref(
            img, w0i, mode="shift_sum")),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(torch, lambda: torch.matmul(img.to(torch.float32),
                                                       w0i)))
    out.update(flash_kernel_phase(torch, dev, gen))
    ops.reset_launch_counts()     # comparison launches do not count
    return out


def flash_kernel_phase(torch, dev, gen) -> dict:
    """Kernel 7 at smollm-360m's longest prefill, causal, scale 1/8, held
    to its plain version (exact softmax in f32 on the same values) within
    atol = rtol = FLASH_TOL. bf16, the serving path, on the tensor cores: q
    (1, 15, 2048, 64) transposed from (1, 2048, 15, 64), k and v the first
    2048 rows of a (1, 5, 4096, 64) cache, read in place (group 3); the
    library yardstick is SDPA on KV expanded to the 15 heads beforehand.
    f32 on the CUDA cores at (15, 2048, 64), the gate route."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    kvh = 5
    h, s, dh = LM_HEADS, LM_PROMPTS[-1], LM_HEAD_DIM
    scale = dh ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = s * (s + 1) // 2                      # causal (query, key) pairs
    ops_n = 4 * h * pairs * dh

    def held(got, want, what):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(bool(((got - want).abs() <= FLASH_TOL
                    + FLASH_TOL * want.abs()).all()),
              f"flash_attention ({what}) off its plain version by {err}")
        return err

    q = torch.randn((1, s, h, dh), generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((1, kvh, 2 * s, dh), generator=gen, device=dev).to(
        torch.bfloat16)[:, :, :s] for _ in range(2))
    err = held(flash_attention(q, k, v, scale=scale),
               flash_attention_plain(q, k, v, scale=scale), "bf16")
    qc = q.contiguous()
    ke, ve = (z.repeat_interleave(h // kvh, dim=1).contiguous()
              for z in (k, v))
    nbytes = (q.numel() + k.numel() + v.numel()) * 2 + q.numel() * 4
    b_ms, b_by = bound_ms(nbytes, ops_n, BF16_OPS_PER_S)
    tc = dict(
        shape=f"q {tuple(q.shape)} bf16 (transposed view) over k, v "
              f"{tuple(k.shape)} bf16 (cache slices), causal, scale {scale} "
              "(smollm-360m's 2048-token prefill, one layer)",
        max_abs_err=err, tolerance=f"atol = rtol = {FLASH_TOL}",
        ms=device_ms(torch, lambda: flash_attention(q, k, v, scale=scale),
                     "flash_tc_kernel"),
        ms_events=time_ms(torch, lambda: flash_attention(q, k, v,
                                                         scale=scale)),
        plain_ms=time_ms(torch, lambda: flash_attention_plain(
            q, k, v, scale=scale)),
        bound_ms=b_ms, bound_by=b_by,
        bytes_bound_ms=bound_ms(nbytes, 0, BF16_OPS_PER_S)[0],
        library_ms=graph_ms(torch, lambda: sdpa(qc, ke, ve, is_causal=True,
                                               scale=scale)))
    tc["ms_again"] = device_ms(torch, lambda: flash_attention(
        q, k, v, scale=scale), "flash_tc_kernel")

    q3, k3, v3 = (torch.randn((h, s, dh), generator=gen, device=dev)
                  for _ in range(3))
    err = held(flash_attention(q3, k3, v3, scale=scale),
               flash_attention_plain(q3, k3, v3, scale=scale), "f32")
    nbytes = 4 * q3.numel() * 4
    b_ms, b_by = bound_ms(nbytes, ops_n, F32_OPS_PER_S)
    f32 = dict(
        shape=f"q, k, v {tuple(q3.shape)} f32, causal, scale {scale}",
        max_abs_err=err, tolerance=f"atol = rtol = {FLASH_TOL}",
        ms=device_ms(torch, lambda: flash_attention(q3, k3, v3, scale=scale),
                     "flash_attention_kernel"),
        ms_events=time_ms(torch, lambda: flash_attention(q3, k3, v3,
                                                         scale=scale)),
        plain_ms=time_ms(torch, lambda: flash_attention_plain(
            q3, k3, v3, scale=scale)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(torch, lambda: sdpa(
            q3[None], k3[None], v3[None], is_causal=True, scale=scale)))
    return {"flash_attention_tc": tc, "flash_attention_f32": f32}


class LayerRecorder:
    """Wraps a backend and keeps every layer's packed output, in forward
    order, and the residual stream the head reads."""

    def __init__(self, inner):
        self.inner, self.rows = inner, []

    def _rec(self, name, out):
        self.rows.append((name, out))
        return out

    def sssc_lif(self, *a, **kw):
        return self._rec("sssc", self.inner.sssc_lif(*a, **kw))

    def zsc_lif(self, *a, **kw):
        return self._rec("zsc", self.inner.zsc_lif(*a, **kw))

    def wssl_lif(self, *a, **kw):
        return self._rec("wssl", self.inner.wssl_lif(*a, **kw))

    def stdp_lif(self, *a, **kw):
        return self._rec("stdp", self.inner.stdp_lif(*a, **kw))

    def residual(self, *a, **kw):
        return self._rec("residual", self.inner.residual(*a, **kw))

    def to_tokens(self, x):
        return self.inner.to_tokens(x)

    def rate(self, x, *, t):
        self._rec("final_residual", x)
        return self.inner.rate(x, t=t)


# the layers whose output is a LIF's spikes
LIFS = ("sssc", "zsc", "wssl", "stdp")


def recorded_step(model, batch) -> tuple:
    """One eager step of ``model`` on ``batch`` through ``LayerRecorder``:
    ``(logits, rows)``."""
    from repro_torch.infer.compile import lower
    rec = LayerRecorder(model.backend)
    logits = lower(model.folded, model.cfg, rec, jit=False)(model.folded,
                                                            batch)
    return logits, rec.rows


OUR_KERNELS = ("tflif_kernel", "lut_gather_kernel", "unpack_dot_kernel",
               "unpack_dot_s8_kernel", "stdp_kernel", "stdp_packed_kernel", "fused_lif_lut_kernel",
               "shift_sum_kernel", "flash_attention_kernel", "flash_tc_kernel")


def profile_phase(torch, step, batch, steps: int = 3) -> dict:
    """Where one bucket-8 step's time goes (``step(batch)``: a model's
    graphed step, or its eager lowering): host wall time per synchronised
    step, device time per kernel by ``torch.profiler`` (CUDA activity), the
    device's idle share of the wall time, and peak device memory. Checks
    that every gather of the step ran the packed entry (the kernel's third
    template argument), which forms its index bytes on chip."""
    prof = profile_fn(torch, lambda: step(batch), steps)
    for row in prof["by_kernel"]:
        if "lut_gather_kernel<" in row["kernel"]:
            args = row["kernel"].split("lut_gather_kernel<")[1].split(",")
            check(args[2].strip() == "true",
                  f"a step's gather ran the index-byte entry: {row['kernel']}")
    return {"bucket": int(batch.shape[0]), **prof}


def profile_fn(torch, fn, steps: int) -> dict:
    """``fn`` once to warm up, ``steps`` times on the host clock (peak
    memory over those), then ``steps`` times under ``torch.profiler``
    (after ``steps`` traced warm-up calls, ``traced``):
    wall and device ms per call, device ms by kernel, idle share."""
    from torch.autograd import DeviceType

    def calls():
        for _ in range(steps):
            fn()

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    calls()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    averages, _ = traced(torch, calls, calls)
    rows = []
    for ev in averages:
        # the schedule's step annotation has a device row of its own
        if (ev.device_type != DeviceType.CUDA
                or ev.key.startswith("ProfilerStep")):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append({"kernel": ev.key[:100],
                         "ours": any(k in ev.key for k in OUR_KERNELS),
                         "ms_per_step": us / 1e3 / steps,
                         "launches_per_step": ev.count / steps})
    rows.sort(key=lambda r: -r["ms_per_step"])
    device_ms = sum(r["ms_per_step"] for r in rows)
    ours_ms = sum(r["ms_per_step"] for r in rows if r["ours"])
    glue = [r for r in rows if not r["ours"]]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms if rows else "not measured",
        "our_kernels_ms_per_step": ours_ms if rows else "not measured",
        "glue_ms_per_step": (sum(r["ms_per_step"] for r in glue) if rows
                             else "not measured"),
        "glue_launches_per_step": sum(r["launches_per_step"] for r in glue),
        "idle_share": 1.0 - device_ms / wall_ms if rows else "not measured",
        "peak_mem_mib": peak_mib,
        "launches_per_step": sum(r["launches_per_step"] for r in rows),
        "by_kernel": rows[:25]}


def gained_tree(torch, cfg, conv0_gain: float = 1.0):
    """The seeded folded tree with the fixed gains that keep the IAND
    residual stream firing (conv0 ``conv0_gain`` times more)."""
    from repro_torch.core.spikformer import fold_inference_params, init
    from repro_torch.infer.quant import map_folded_layers

    def gain(path, layer):
        g = GAIN * (GAIN_RESIDUAL if path.endswith(("/wo", "/fc2")) else 1.0)
        if path == "scs/conv0":
            g *= conv0_gain
        return {**layer, "kernel": layer["kernel"] * g}

    return map_folded_layers(fold_inference_params(
        init(torch.Generator().manual_seed(SEED), cfg), cfg), gain)


def request_images(cfg) -> list:
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, 256, (n, cfg.img_size, cfg.img_size,
                                  cfg.in_channels), dtype=np.uint8)
            for n in REQUEST_SIZES]


def per_step_launches(cfg, routes: dict, dtype: str = "int8") -> dict:
    """Kernel launches a step makes under ``routes`` (empty for
    ``route="unpack"``): a LIF a layer and attention, the gather a lut
    layer, the fused kernel where fc2 gathers (it runs fc1's LIF and fc2's
    gather), the unpack dot of the weights' ``dtype`` (int8 or f32) every
    other unpack layer, the shift-sum dot an unpack conv0, packed STDP a
    block."""
    paths = [f"scs/conv{i}" for i in range(len(cfg.scs_channels))] + [
        f"blocks/b{i}/{w}" for i in range(cfg.depth)
        for w in ("ssa/wq", "ssa/wk", "ssa/wv", "ssa/wo", "mlp/fc1",
                  "mlp/fc2")]
    route = {p: routes.get(p, "unpack") for p in paths}
    fused = sum(route[f"blocks/b{i}/mlp/fc2"] == "lut"
                for i in range(cfg.depth))
    n_lut = sum(r == "lut" for r in route.values())
    unpack = "unpack_dot_s8" if dtype == "int8" else "unpack_dot"
    counts = {"tflif": len(paths) + cfg.depth - fused,
              "lut_gather": n_lut - fused, "fused_lif_lut": fused,
              unpack: len(paths) - n_lut - (route["scs/conv0"] == "unpack"),
              "shift_sum": int(route["scs/conv0"] == "unpack"),
              "stdp_packed": cfg.depth}
    return {k: v for k, v in counts.items() if v}


def check_step_launches(launches: dict, per_step: dict, steps: int) -> None:
    expect = {k: per_step.get(k, 0) * steps for k in launches}
    check(launches == expect,
          f"launch counts {launches} != {steps} steps x {per_step}")


def reset_counts(model) -> None:
    """Every launch count to 0: the wrappers' and the model's replays."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    model.reset_graph_launch_counts()


def read_counts(torch, model) -> dict:
    """Launches since ``reset_counts``: the wrappers' counters (eager
    steps) plus each captured graph's launches times its replays; a
    graphed model must have launched nothing eagerly."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    eager, graphed = ops.launch_counts(), model.graph_launch_counts()
    if model.jit:
        check(not any(eager.values()),
              f"a graphed model launched kernels eagerly: {eager}")
    return {k: eager[k] + graphed.get(k, 0) for k in eager}


def serve_requests(torch, model, requests, per_step: dict) -> dict:
    """Serve ``requests`` through ``MicroBatchEngine``, the launch counts
    set to 0 just before and read just after; checks every request
    completes and each kernel was launched its per-step count a step."""
    from repro_torch.infer import MicroBatchEngine

    engine = MicroBatchEngine(model)
    reset_counts(model)
    reqs = [engine.submit(imgs) for imgs in requests]
    engine.run()
    launches = read_counts(torch, model)
    steps = engine.acct.batches
    check(all(r.t_done and len(r.labels) == len(r.images)
              and None not in r.labels for r in reqs),
          "a request did not complete")
    check_step_launches(launches, per_step, steps)
    return dict(steps=steps, jit=model.jit, per_step_launches=per_step,
                launches=launches, stats=engine.stats(),
                engine_ms_per_step=engine.acct.wall_s * 1e3 / steps,
                model_step_ms_per_step=engine.acct.busy_s * 1e3 / steps)


def engine_host_ms(requests, reps: int = 5) -> dict:
    """Host ms of the engine's per-step numpy work on one bucket-8 batch:
    ``assemble_batch``, and the occupancy stat two ways, the port's byte
    popcount (``batch_occupancy``) and the reference's mean over
    ``np.unpackbits`` (written out here: the port never imports the
    reference), each the mean of ``reps`` calls; checks both give the
    same float."""
    import numpy as np
    from repro_torch.infer.engine import assemble_batch, batch_occupancy

    images = list(np.concatenate(requests)[:BATCH])

    def unpackbits_occupancy():
        arr = np.asarray(images, np.uint8)
        return float(np.unpackbits(arr.reshape(-1)).mean())

    out, values = {}, {}
    for name, fn in (("assemble_batch", lambda: assemble_batch(images,
                                                                BATCH)),
                     ("batch_occupancy", lambda: batch_occupancy(images)),
                     ("batch_occupancy_unpackbits", unpackbits_occupancy)):
        values[name] = fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    check(values["batch_occupancy"] == values["batch_occupancy_unpackbits"],
          f"popcount occupancy {values['batch_occupancy']!r} != unpackbits "
          f"{values['batch_occupancy_unpackbits']!r}")
    out["occupancy"] = values["batch_occupancy"]
    return out


def eager_step(model):
    """The model's step lowered eagerly over its own tree."""
    from repro_torch.infer.compile import lower
    fwd = lower(model.folded, model.cfg, model.backend, jit=False)
    return lambda batch: fwd(model.folded, batch)


def check_graph_logits(torch, model, batch, what: str):
    """The graphed step's logits of ``batch``, held bit-identical to the
    eager step's of the same tree."""
    graph = model.step(batch)
    eager = eager_step(model)(batch)
    torch.cuda.synchronize()
    check(model.jit and torch.equal(graph, eager),
          f"{what}: graph replay logits differ from the eager step's")
    return graph


def check_logits(torch, logits, others: dict, what: str) -> list:
    """Finite, non-zero logits, bit-identical to every entry of ``others``
    (name -> logits of the same batch); returns the labels."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits).all()), f"{what}: non-finite logits")
    check(bool((logits != 0).any()),
          f"{what}: all logits are zero: the network is silent")
    for name, other in others.items():
        check(torch.equal(logits, other),
              f"{what}: packed_cuda logits differ from {name} on the card: "
              f"max {float((logits - other).abs().max())}")
    return logits.argmax(-1).tolist()


def final_firing(model, batch) -> tuple:
    """Per-layer firing rates of ``batch`` in forward order; checks the
    final residual stream still fires."""
    from repro_torch.core.spike import packed_occupancy
    rows = [(n, packed_occupancy(o, model.cfg.timesteps))
            for n, o in recorded_step(model, batch)[1]]
    check(rows[-1][1] > 0, "the final residual stream is silent")
    return rows[-1][1], [(n, round(o, 5)) for n, o in rows]


def serve_phase(torch, dev, cfg, folded, requests, batch) -> dict:
    """The PR 11 path: int8 weights under the default plan (the paper's
    int8 route mix), served with ``jit=True`` (one CUDA graph a bucket);
    one batch's graph logits against the eager step's and
    ``packed_plain``'s. Both the graphed and the eager step are
    profiled."""
    from repro_torch.infer import ExecutionPlan, compile

    t0 = time.perf_counter()
    model = compile(folded, cfg, ExecutionPlan(
        backend="packed_cuda", weight_dtype="int8", batch_buckets=(1, BATCH)),
        folded=True, device=dev)
    compile_s = time.perf_counter() - t0
    routes = model.plan.routes
    want_routes = {p: ("unpack" if p in ("scs/conv3",) or "/mlp/" in p
                       else "lut") for p in routes}
    check(routes == want_routes,
          f"routes differ from the paper config's int8 mix: {routes}")
    warmup_s = model.warmup()
    served = serve_requests(torch, model, requests,
                            per_step_launches(cfg, routes))

    logits = check_graph_logits(torch, model, batch, "int8 default plan")
    plain = compile(model.folded, cfg, dataclasses.replace(
        model.plan, backend="packed_plain"), folded=True, device=dev,
        jit=False)
    labels = check_logits(torch, logits, {"packed_plain": plain.step(batch)},
                          "int8 default plan")
    del plain
    final_occ, layers = final_firing(model, batch)
    prof = profile_phase(torch, model.step, batch)
    prof_eager = profile_phase(torch, eager_step(model), batch)
    return dict(
        config="SpikformerConfig() V2-8-512: 224x224x3, T=4, dim 512, "
               "depth 8, heads 8, 1000 classes; int8, packed_cuda, jit=True",
        compile_s=compile_s, warmup_s=warmup_s, **served,
        bucket8_labels=labels, distinct_labels=len(set(labels)),
        logits_bit_identical_to=["eager step", "packed_plain"],
        logits=logits.cpu(),
        final_residual_occupancy=final_occ, layer_occupancy=layers,
        profile=prof, profile_eager=prof_eager)


def lut_serve_phase(torch, dev, cfg, folded, requests, batch) -> dict:
    """Path A: f32 weights with every layer pinned to the gather, served
    with ``jit=True``. Every block runs fc1 -> (LIF + pack + fc2 gather in
    the fused kernel) -> fc2 LIF. One bucket-8 batch is held bit-identical
    across the graph replay, the eager step, packed_cuda without the fused
    step, packed_plain and the float reference backend, all compiled from
    the one resolved plan."""
    from repro_torch.infer import ExecutionPlan, compile

    t0 = time.perf_counter()
    model = compile(folded, cfg, ExecutionPlan(
        backend="packed_cuda", weight_dtype="float32", route="lut",
        batch_buckets=(1, BATCH)), folded=True, device=dev)
    compile_s = time.perf_counter() - t0
    routes = model.plan.routes
    check(set(routes.values()) == {"lut"} and len(routes) == 4 + 6 * cfg.depth,
          f"route='lut' left a layer off the gather: {routes}")
    warmup_s = model.warmup()
    served = serve_requests(torch, model, requests,
                            per_step_launches(cfg, routes))
    prof = profile_phase(torch, model.step, batch)
    prof_eager = profile_phase(torch, eager_step(model), batch)

    logits = check_graph_logits(torch, model, batch, "f32 route='lut'")
    others, seconds = {}, {}
    for name, backend, options in (
            ("packed_cuda(fuse_mlp=False)", "packed_cuda",
             {"fuse_mlp": False}),
            ("packed_plain", "packed_plain", {}),
            ("reference", "reference", {})):
        t0 = time.perf_counter()
        other = compile(model.folded, cfg, dataclasses.replace(
            model.plan, backend=backend, backend_options=options),
            folded=True, device=dev, jit=False)
        check(other.plan.routes == routes,
              f"{name} planned other routes than packed_cuda")
        others[name] = other.step(batch)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        del other
        torch.cuda.empty_cache()
    labels = check_logits(torch, logits, others, "f32 route='lut'")
    final_occ, layers = final_firing(model, batch)
    return dict(
        config="SpikformerConfig() V2-8-512; float32 weights, route='lut', "
               "packed_cuda, jit=True", compile_s=compile_s,
        warmup_s=warmup_s, **served, bucket8_labels=labels,
        distinct_labels=len(set(labels)),
        logits_bit_identical_to=["eager step", *sorted(others)],
        parity_compile_and_step_s=seconds,
        final_residual_occupancy=final_occ, layer_occupancy=layers,
        profile=prof, profile_eager=prof_eager)


def unpack_step_phase(torch, dev, cfg, folded, batch, int8_logits) -> dict:
    """Path B: int8 weights with every table stripped, one graphed
    bucket-8 step. conv0 runs the shift-sum kernel, every other linear the
    int8 unpack dot; logits bit-identical to the eager step's,
    packed_plain's and, int8 sums being exact on every route, the default
    plan's. Then the graphed and the eager step are profiled."""
    from repro_torch.infer import ExecutionPlan, compile

    model = compile(folded, cfg, ExecutionPlan(
        backend="packed_cuda", weight_dtype="int8", route="unpack"),
        folded=True, device=dev)
    check(model.plan.routes == {}, "route='unpack' kept a planned route")
    model.warmup()
    per_step = per_step_launches(cfg, {})
    reset_counts(model)
    logits = model.step(batch)
    launches = read_counts(torch, model)
    check_step_launches(launches, per_step, 1)
    check_graph_logits(torch, model, batch, "int8 route='unpack'")
    plain = compile(model.folded, cfg, dataclasses.replace(
        model.plan, backend="packed_plain"), folded=True, device=dev,
        jit=False)
    labels = check_logits(torch, logits, {
        "packed_plain": plain.step(batch),
        "the default int8 plan": int8_logits.to(dev)}, "int8 route='unpack'")
    del plain
    final_occ, _ = final_firing(model, batch)
    prof = profile_phase(torch, model.step, batch)
    prof_eager = profile_phase(torch, eager_step(model), batch)
    return dict(
        config="SpikformerConfig() V2-8-512; int8 weights, route='unpack', "
               "packed_cuda, jit=True, one bucket-8 step",
        steps=1, jit=model.jit, per_step_launches=per_step,
        launches=launches, bucket8_labels=labels,
        final_residual_occupancy=final_occ, profile=prof,
        profile_eager=prof_eager)


def route_phase(torch, dev, cfg, folded, requests, batch,
                int8_logits) -> dict:
    """The route autotuner fitted on the card, then the int8 model
    compiled four times: the reference's and the fitted constants, each
    with ``jit=False`` and ``jit=True``. The fit is the int8 ``--cuda
    --fast`` one of ``repro_torch.launch.autotune_routes``; its fragment
    goes to ``build/routes_int8.json`` and is served through
    ``ExecutionPlan.from_json``. Each of the four serves the requests
    (launch counts gated), gives logits bit-identical to ``packed_plain``
    (and, for a graph, to its eager step), is profiled at bucket 8 and
    timed layer by layer by ``profile_step``. One model is alive at a
    time."""
    from repro_torch.infer import ExecutionPlan, compile
    from repro_torch.launch import autotune_routes as tune

    t0 = time.perf_counter()
    samples = tune.measure_cuda_grid(tune.cuda_grid(fast=True),
                                     weight_dtype="int8", repeats=2, inner=5,
                                     seed=SEED)
    fitted = tune.fit_cuda_constants(samples)
    fit_s = time.perf_counter() - t0
    text = json.dumps(tune.plan_fragment(fitted, "int8"), indent=1,
                      sort_keys=True)
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "routes_int8.json").write_text(text + "\n")
    plans = {"reference": ExecutionPlan(weight_dtype="int8",
                                        batch_buckets=(1, BATCH)),
             "fitted": dataclasses.replace(ExecutionPlan.from_json(text),
                                           batch_buckets=(1, BATCH))}
    check(plans["fitted"].weight_dtype == "int8",
          "the fitted fragment lost its weight dtype")
    fit_keys = ("pallas_gather_cost", "pallas_dot_cost", "transpose_cost")
    cells, routes_by = [], {}
    for name, plan in plans.items():
        plain = compile(folded, cfg, dataclasses.replace(
            plan, backend="packed_plain"), folded=True, device=dev,
            jit=False)
        want = plain.step(batch)
        torch.cuda.synchronize()
        routes_by[name] = plain.plan.routes
        del plain
        torch.cuda.empty_cache()
        for jit in (False, True):
            t0 = time.perf_counter()
            model = compile(folded, cfg, plan, folded=True, device=dev,
                            jit=jit)
            compile_s = time.perf_counter() - t0
            check(model.plan.routes == routes_by[name],
                  f"{name}: packed_cuda planned other routes than "
                  "packed_plain")
            per_step = per_step_launches(cfg, model.plan.routes)
            warmup_s = model.warmup()
            served = serve_requests(torch, model, requests, per_step)
            logits = (check_graph_logits(torch, model, batch, name) if jit
                      else model.step(batch))
            check_logits(torch, logits, {
                "packed_plain": want, "the default int8 plan": int8_logits.to(
                    dev)}, f"int8, {name} constants, jit={jit}")
            prof = profile_phase(torch, model.step, batch)
            rows = model.profile_step(batch)
            cells.append(dict(
                constants=name, jit=jit, compile_s=compile_s,
                warmup_s=warmup_s, per_step_launches=per_step,
                steps=served["steps"], launches=served["launches"],
                images_per_s=served["stats"]["fps"],
                engine_ms_per_step=served["engine_ms_per_step"],
                model_step_ms_per_step=served["model_step_ms_per_step"],
                serve=served["stats"],
                wall_ms=prof["wall_ms_per_step"],
                device_ms=prof["device_ms_per_step"],
                idle_share=prof["idle_share"],
                peak_mem_mib=prof["peak_mem_mib"],
                profiled_launches_per_step=prof["launches_per_step"],
                by_kernel=[(r["kernel"][:48], r["ms_per_step"],
                            r["launches_per_step"])
                           for r in prof["by_kernel"][:10]],
                profile_step_s=sum(r["seconds"] for r in rows),
                profile_step_routes=tune.route_sums(rows)))
            del model
            torch.cuda.empty_cache()
    launches = {}
    for c in cells:
        for k, v in c["launches"].items():
            launches[k] = launches.get(k, 0) + v
    route_counts = {name: {r: list(rs.values()).count(r)
                           for r in sorted(set(rs.values()))}
                    for name, rs in routes_by.items()}
    return dict(
        config="SpikformerConfig() V2-8-512; int8, packed_cuda, buckets "
               "(1, 8); reference vs fitted route constants x jit",
        fit_s=fit_s, fit_samples=samples, fitted=fitted.to_dict(),
        fitted_keys={k: getattr(fitted, k) for k in fit_keys},
        fit_agreement=tune.cuda_agreement(samples, fitted),
        fragment=json.loads(text), routes=routes_by,
        route_counts=route_counts, cells=cells, launches=launches,
        engine_host_ms=engine_host_ms(requests))


# the event workload: count frames carry event counts where conv0's fold
# scales 8-bit pixels by 1/255, so the event paths gain conv0 by 255 more
# (without it every layer is silent and every label 0)
COUNT_GAIN = 255.0
EVENT_WINDOW_US = 20_000
EVENT_WINDOWS = 40
EVENT_SESSIONS = 4
EVENTS_TRACE = "benchmarks/traces/dvs_synth_mini.jsonl"


@contextlib.contextmanager
def cpu_branch_calls():
    """Counts calls into the CPU branch's ops while the block runs (its
    route resolution, its gather, packed STDP asked for the CPU branch):
    ``{name: calls}``."""
    from repro_torch.kernels import ops
    calls = {}
    saved = {name: getattr(ops, name) for name in (
        "_resolve_route", "_cpu_gather", "stdp_attention_packed")}

    def counting(name, fn):
        def wrapped(*a, **kw):
            if name != "stdp_attention_packed" or kw.get("cpu_branch"):
                calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    for name, fn in saved.items():
        setattr(ops, name, counting(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def graph_replays(model) -> int:
    """Replays of every bucket's graph since the last reset."""
    return sum(g.replays for g in model._fwd.graphs.values())


def check_graphed_run(torch, model, per_step: dict, captures: int) -> dict:
    """Launches since ``reset_counts`` of a graphed model that captured
    ``captures`` bucket graphs in the window (each capture one eager run
    and one recording, both ticking the wrappers) and replayed the rest:
    eager launches are per_step x 2 x captures, replayed ones per_step x
    the replays. Returns every kernel's total."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    eager, graphed = ops.launch_counts(), model.graph_launch_counts()
    check_step_launches(eager, per_step, 2 * captures)
    replays = graph_replays(model)
    check_step_launches({k: graphed.get(k, 0) for k in eager}, per_step,
                        replays)
    return {k: eager[k] + graphed.get(k, 0) for k in eager}


def events_cli_phase(torch, dev) -> dict:
    """``serve_spikformer``'s event workload with ``--events --smoke``:
    ``main`` on the synthetic trace and on ``--trace`` of the committed
    fixture (the reference's event config, ``scaled(img_size=16, dim=32,
    depth=1)`` with two polarity channels, the port's seeded ``init``, on
    the reference's default plan, ``packed``, buckets (2, 8), graphed, on
    the card), then ``main_events`` on the fixture with a model built here
    from the gained tree (conv0 x COUNT_GAIN more) under the same plan,
    since the untrained model is silent (every label 0). The CLI's own
    smoke asserts gate (zero sheds and drops, SLO attainment 1.0, equal
    ``labels_sha`` over the double replay); here, besides: the backend is
    ``packed`` on its kernel branch, no call reached the CPU branch's ops,
    and each kernel launched its per-step count for every capture and
    replay. For the gained model: the labels are not all one class, its
    graphed logits on the trace's count frames are bit-identical to
    ``packed_plain``'s (``jit=False``, the same folded tree) at bucket 2
    and at bucket 8, and the served labels equal ``packed_plain``'s."""
    import numpy as np
    from repro_torch.events import trace_to_load
    from repro_torch.infer import compile
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_spikformer as cli

    out = {"config": "SpikformerConfig().scaled(img_size=16, dim=32, "
                     "depth=1), in_channels=2; ExecutionPlan(backend="
                     "'packed', batch_buckets=(2, 8)), jit=True",
           "runs": [], "launches": {}}
    fixture = ["--trace", str(ROOT / EVENTS_TRACE)]
    for flags, gained in (([], False), (fixture, False), (fixture, True)):
        args = cli.parse_args(["--events", "--smoke", *flags])
        ops.reset_launch_counts()
        with cpu_branch_calls() as calls:
            try:
                if gained:
                    trace = cli.event_trace(args)
                    cfg = cli.event_config(trace)
                    model = compile(gained_tree(torch, cfg,
                                                conv0_gain=COUNT_GAIN),
                                    cfg, cli.plan_from_args(args),
                                    folded=True, device=dev)
                    summary = cli.main_events(args, model, model.warmup())
                else:
                    summary = cli.main(["--events", "--smoke", *flags])
            except AssertionError as e:
                raise CheckFailed(f"events CLI {flags}: smoke gate: {e}")
        model = summary.pop("model")
        what = f"events CLI {flags}{' gained' if gained else ''}"
        check(model.plan.backend == "packed" and model.backend.name ==
              "packed" and model.backend.pallas and not model.backend.plain,
              f"{what}: not the packed backend's kernels")
        check(not calls, f"{what}: the CPU branch ran: {calls}")
        runs = summary.pop("runs")
        check(all(r["requests_rejected"] == 0 and r["requests_dropped"] == 0
                  and r["slo_attainment"] == 1.0 for r in runs)
              and len({r["labels_sha"] for r in runs}) == 1 and len(runs) == 2,
              f"{what}: the smoke contract failed")
        per_step = per_step_launches(model.cfg, model.plan.routes,
                                     model.weight_dtype)
        launches = check_graphed_run(torch, model, per_step,
                                     captures=len(model.buckets))
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        row = {
            "trace": summary["trace"], "gained": gained,
            "backend": summary["backend"],
            "routes": sorted(set(model.plan.routes.values())),
            "windows": summary["windows"], "labels_sha": summary["labels_sha"],
            "slo_attainment": summary["slo_attainment"],
            "requests_rejected": summary["requests_rejected"],
            "latency_p50_s": summary["latency_p50_s"],
            "latency_p99_s": summary["latency_p99_s"],
            "per_step_launches": per_step, "replays": graph_replays(model),
            "launches": {k: v for k, v in launches.items() if v},
            "cpu_branch_calls": sum(calls.values())}
        if gained:
            # comparison launches, after the counted window
            _, make = trace_to_load(trace)
            frames = np.concatenate([make(k, 1)
                                     for k in range(len(trace.arrivals))])
            plain = compile(model.folded, model.cfg, dataclasses.replace(
                model.plan, backend="packed_plain"), folded=True, device=dev,
                jit=False)
            row["held_to_packed_plain"] = held_to_plain(
                torch, model, plain, frames, what)
            labels = [lab for labs in summary["labels"] for lab in labs]
            want = plain.classify(frames).tolist()
            check(labels == want, f"{what}: served labels {labels} differ "
                  f"from packed_plain's {want}")
            check(len(set(labels)) > 1, f"{what}: every window got one label")
            row.update(labels=labels, distinct_labels=len(set(labels)))
            del plain
            ops.reset_launch_counts()
        out["runs"].append(row)
        del model
    return out


def held_to_plain(torch, model, plain, frames, what: str) -> dict:
    """The graphed ``model``'s logits on ``frames`` held bit-identical to
    ``plain``'s (the same tree on ``packed_plain``), at every bucket of
    ``model``: at bucket b, each whole run of b frames from the first.
    Returns ``{bucket: frames compared}``."""
    out = {}
    for b in model.buckets:
        n = len(frames) // b * b
        check(n > 0, f"{what}: fewer frames than bucket {b}")
        for lo in range(0, n, b):
            x = torch.from_numpy(frames[lo:lo + b]).to(model.device)
            got, want = model.step(x), plain.step(x)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()) and bool((got != 0).any()),
                  f"{what}: logits non-finite or all zero at bucket {b}")
            check(torch.equal(got, want), f"{what}: logits at bucket {b} "
                  f"differ from packed_plain's by "
                  f"{float((got - want).abs().max())}")
        out[b] = n
    return out


def event_streams(size: int, seeds) -> list:
    """One DVS stream a seed: a moving edge sweeping the sensor once and
    four flicker bursts, EVENT_WINDOWS windows long."""
    from repro_torch.events import (flicker_burst_events, merge_streams,
                                    moving_edge_events)
    kw = dict(height=size, width=size,
              duration_us=EVENT_WINDOWS * EVENT_WINDOW_US)
    return [merge_streams(moving_edge_events(seed=s, **kw),
                          flicker_burst_events(seed=s + 100, bursts=4, **kw))
            for s in seeds]


def serve_event_sessions(model, streams, policy) -> tuple:
    """One pass of ``streams`` through fresh ``EventStreamSession``s (one a
    stream, capturing their count frames) on a fresh ``AsyncServeRuntime``
    over ``model``, each fed window by window at its recorded times.
    Returns ``(sessions, elapsed seconds, runtime stats)``."""
    from repro_torch.events import EventStreamSession
    from repro_torch.serve import AsyncServeRuntime

    size = model.cfg.img_size
    with AsyncServeRuntime(model, policy=policy) as rt:
        sessions = [EventStreamSession(
            rt, window_us=EVENT_WINDOW_US, height=size, width=size,
            capture=True) for _ in streams]
        t_start = time.perf_counter()
        for w in range(EVENT_WINDOWS):
            lo, hi = w * EVENT_WINDOW_US, (w + 1) * EVENT_WINDOW_US
            time.sleep(max(0.0, t_start + lo / 1e6 - time.perf_counter()))
            for s, stream in zip(sessions, streams):
                s.feed(stream.slice_time(lo, hi))
        time.sleep(max(0.0, t_start + EVENT_WINDOWS * EVENT_WINDOW_US / 1e6
                       - time.perf_counter()))
        for s in sessions:
            s.close(timeout=120)
        elapsed = time.perf_counter() - t_start
        stats = rt.stats()
    return sessions, elapsed, stats


def events_full_width_phase(torch, dev) -> dict:
    """A synthetic DVS stream served at the paper model's widths:
    V2-8-512 (dim 512, depth 8, heads 8, T=4) on a 128x128 two-polarity
    sensor (DVS128 / CIFAR10-DVS resolution), 10 classes, the gained tree
    with conv0 x COUNT_GAIN more, int8, ``packed``, buckets (1, 8),
    graphed. Four ``EventStreamSession``s on one ``AsyncServeRuntime``,
    each fed its own stream (seeds 0-3) window by window at its recorded
    times: 40 windows of 20 ms a session. Served twice: once untraced,
    which gives windows/s and the latencies, and once under
    ``torch.profiler``, which gives the card's idle share (its host cost
    stretches that pass). Gates: no window shed, every window labelled,
    each label equal to ``classify`` of its count frame and the same in
    both passes, not all one class, the graphed logits on the count
    frames bit-identical to ``packed_plain``'s at bucket 1 and bucket 8,
    no call into the CPU branch, and the launches of the warm-up's
    captures and of every replay at their per-step counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import numpy as np
    from repro_torch.core.spikformer import SpikformerConfig
    from repro_torch.events import events_to_frame
    from repro_torch.infer import ExecutionPlan, compile
    from repro_torch.kernels import ops
    from repro_torch.serve import ServePolicy

    cfg = dataclasses.replace(SpikformerConfig(), img_size=128,
                              in_channels=2, num_classes=10)
    folded = gained_tree(torch, cfg, conv0_gain=COUNT_GAIN)
    streams = event_streams(cfg.img_size, range(EVENT_SESSIONS))
    t0 = time.perf_counter()
    model = compile(folded, cfg, ExecutionPlan(
        backend="packed", weight_dtype="int8", batch_buckets=(1, BATCH)),
        folded=True, device=dev)
    compile_s = time.perf_counter() - t0
    check(model.backend.name == "packed" and model.backend.pallas,
          "the full-width event model is not on the packed kernels")
    per_step = per_step_launches(cfg, model.plan.routes, "int8")
    policy = ServePolicy(max_wait_ms=5.0, slo_ms=100.0, max_queue_images=512)
    reset_counts(model)
    with cpu_branch_calls() as calls:
        warmup_s = model.warmup()
        sessions, elapsed, stats = serve_event_sessions(model, streams,
                                                        policy)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced, traced_elapsed, traced_stats = serve_event_sessions(
                model, streams, policy)
            torch.cuda.synchronize()
    check(not calls, f"full-width events: the CPU branch ran: {calls}")
    launches = check_graphed_run(torch, model, per_step,
                                 captures=len(model.buckets))
    by_kernel = sorted(
        ((ev.key[:60], (getattr(ev, "self_device_time_total", None)
                        or getattr(ev, "self_cuda_time_total", 0.0)) / 1e3,
          ev.count)
         for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA),
        key=lambda r: -r[1])
    device_us = sum(ms for _, ms, _ in by_kernel) * 1e3
    rows = [r for s in sessions for r in s.windows]
    labels = [r["label"] for r in rows]
    check(sum(s.windows_shed for s in sessions + traced) == 0,
          "full-width events: a window was shed")
    check(len(rows) == EVENT_SESSIONS * EVENT_WINDOWS
          and None not in labels,
          f"full-width events: {len(rows)} windows, "
          f"{labels.count(None)} unlabelled")
    check([r["label"] for s in traced for r in s.windows] == labels,
          "full-width events: the traced pass's labels differ")
    frames = np.stack([events_to_frame(ev) for s in sessions
                       for _, _, ev in s.captured])
    want = model.classify(frames).tolist()
    check(labels == want, "full-width events: served labels differ from "
          "classify of the count frames")
    check(len(set(labels)) > 1, "full-width events: every window got one "
          "label")
    # comparison launches, after the counted window
    plain = compile(model.folded, cfg, dataclasses.replace(
        model.plan, backend="packed_plain"), folded=True, device=dev,
        jit=False)
    held = held_to_plain(torch, model, plain, frames, "full-width events")
    del plain
    torch.cuda.empty_cache()
    occ = [r["occupancy"] for r in rows]
    # where a step's time goes at both buckets, on the sessions' frames
    steps = {b: profile_phase(torch, model.step, torch.from_numpy(
        frames[:b]).to(dev)) for b in model.buckets}
    ops.reset_launch_counts()
    return dict(
        config="SpikformerConfig() V2-8-512 at 128x128x2, 10 classes; "
               "gained tree, conv0 x255 more; int8, packed, buckets (1, 8), "
               "jit=True; 4 sessions x 40 windows of 20 ms on one runtime, "
               "served twice (untraced, then under torch.profiler)",
        compile_s=compile_s, warmup_s=warmup_s, routes=model.plan.routes,
        per_step_launches=per_step, replays=graph_replays(model),
        launches={k: v for k, v in launches.items() if v},
        windows=len(rows), elapsed_s=elapsed,
        windows_per_s=len(rows) / elapsed,
        latency_p50_s=stats["latency_p50_s"],
        latency_p99_s=stats["latency_p99_s"], batches=stats["batches"],
        pad_waste=stats["pad_waste"], step_fps=stats["fps"],
        held_to_packed_plain=held,
        mean_window_occupancy=float(np.mean(occ)),
        mean_firing_rate=float(np.mean([r["firing_rate"] for r in rows])),
        events=sum(len(s) for s in streams),
        distinct_labels=len(set(labels)),
        traced=dict(elapsed_s=traced_elapsed,
                    latency_p50_s=traced_stats["latency_p50_s"],
                    latency_p99_s=traced_stats["latency_p99_s"],
                    batches=traced_stats["batches"],
                    device_ms=device_us / 1e3,
                    idle_share=1.0 - device_us / 1e3
                    / (traced_elapsed * 1e3)),
        top_kernels_ms=by_kernel[:10], cpu_branch_calls=0,
        all_launches=launches,
        step_profiles={b: {k: p[k] for k in (
            "wall_ms_per_step", "device_ms_per_step", "idle_share",
            "launches_per_step", "glue_ms_per_step")}
            | {"top_kernels": [(r["kernel"][:48], r["ms_per_step"],
                                r["launches_per_step"])
                               for r in p["by_kernel"][:8]]}
            for b, p in steps.items()})


def spike_flips(torch, model, plain, batch) -> list:
    """One eager step of ``model`` and of ``plain`` (same tree, plain
    versions): for each LIF in forward order, its name, the spike bits
    that differ between the two and the plain step's spikes. A readout,
    not a gate: it shows how close the f32 sums sit to the threshold, and
    where a logits gate failure begins."""
    got, want = ([(n, o) for n, o in recorded_step(m, batch)[1]
                  if n in LIFS] for m in (model, plain))
    pop = torch.tensor([bin(i).count("1") for i in range(256)],
                       device=batch.device)
    return [(name, int(pop[(a ^ b).long()].sum()), int(pop[b.long()].sum()))
            for (name, a), (_, b) in zip(got, want)]


def packed_default_f32_phase(torch, dev, cfg, folded, batch) -> dict:
    """The reference's default plan, ``ExecutionPlan()`` with backend
    ``packed`` (the port's ``ExecutionPlan()`` names ``packed_cuda``,
    which runs the same kernels), on the f32 gained tree: bucket 8,
    graphed. Under the 16 MiB table cap conv0-2 gather and conv3, the SSA
    linears, fc1 and fc2 run the f32 grouped unpack dot
    (``csrc/unpack_dot.cu``, on the bf16 tensor cores over each layer's
    ``kernel_bf16x3`` split, built once by the planner: the wrappers'
    count of splits built per call must stay 0). One step's launches are
    gated at the plan's per-step counts; its logits are bit-identical to
    the eager step's and, the f32 unpack dot summing in another order than
    the plain matmul (held to a tolerance, as the reference's Pallas
    unpack route is), give ``packed_plain``'s labels with logits within
    atol 1e-3 + rtol 1e-3. The spike bits of each LIF that differ from
    ``packed_plain``'s in one eager step are read out (``spike_flips``).
    Then the step is profiled graphed, and the unpack dot timed alone at
    each of its layer shapes over a prebuilt split (CUDA events around a
    captured graph of 20 calls, as the library calls are timed)."""
    from repro_torch.core.spike import pack_timesteps, unpack_timesteps
    from repro_torch.infer import ExecutionPlan, compile
    from repro_torch.infer.quant import map_folded_layers
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spike_matmul import (bf16x3_weights,
                                                  spike_matmul_grouped)

    t0 = time.perf_counter()
    model = compile(folded, cfg, ExecutionPlan(backend="packed"),
                    folded=True, device=dev)
    compile_s = time.perf_counter() - t0
    routes = model.plan.routes
    check(model.weight_dtype == "float32" and model.buckets == (BATCH,)
          and model.backend.pallas, "the default plan is not f32, bucket 8, "
          "on the kernels")
    want_routes = {p: "lut" if p in ("scs/conv0", "scs/conv1", "scs/conv2")
                   else "unpack" for p in routes}
    check(routes == want_routes,
          f"the default f32 plan's routes differ from the cap's: {routes}")
    layers = {}

    def note(path, layer):
        layers[path] = layer
        return layer

    map_folded_layers(model.folded, note)
    split_layers = sorted(p for p, l in layers.items()
                          if "kernel_bf16x3" in l)
    check(split_layers == sorted(p for p, r in routes.items()
                                 if r == "unpack"),
          f"default f32 plan: kernel_bf16x3 on {split_layers}")
    # the planner's splits, built again and timed on their own
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in split_layers:
        bf16x3_weights(layers[p]["kernel"], name=p)
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    per_step = per_step_launches(cfg, routes, "float32")
    with cpu_branch_calls() as calls:
        spike_matmul_grouped.split_builds = 0
        warmup_s = model.warmup()
        split_builds = spike_matmul_grouped.split_builds
        reset_counts(model)
        logits = model.step(batch)
        launches = read_counts(torch, model)
        split_builds += spike_matmul_grouped.split_builds
    check(not calls, f"default f32 plan: the CPU branch ran: {calls}")
    check(split_builds == 0, f"default f32 plan: {split_builds} weight "
          "splits built per call")
    check_step_launches(launches, per_step, 1)
    graph = check_graph_logits(torch, model, batch, "default f32 plan")
    check(torch.equal(graph, logits), "default f32 plan: two replays differ")
    plain = compile(model.folded, cfg, dataclasses.replace(
        model.plan, backend="packed_plain"), folded=True, device=dev,
        jit=False)
    want = plain.step(batch)
    flips = spike_flips(torch, model, plain, batch)
    ops.reset_launch_counts()     # the readout's eager launches do not count
    torch.cuda.synchronize()
    del plain
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(logits).all()) and bool((logits != 0).any()),
          "default f32 plan: logits non-finite or all zero")
    err = float((logits - want).abs().max())
    check(bool(((logits - want).abs() <= 1e-3 + 1e-3 * want.abs()).all())
          and torch.equal(logits.argmax(-1), want.argmax(-1)),
          f"default f32 plan: logits off packed_plain's by {err}; spike "
          f"flips by LIF: {[(i, f) for i, (_, f, _) in enumerate(flips) if f]}")
    final_occ, _ = final_firing(model, batch)
    prof = profile_phase(torch, model.step, batch)
    # the unpack dot alone at each layer shape of the step (comparison
    # launches, after the gated window)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t, tokens, dim = cfg.timesteps, cfg.tokens, cfg.dim
    by_shape = {}
    for name, rows, k_in, n_out, layers in (
            ("conv3", BATCH * tokens, 4 * cfg.scs_channels[2], dim, 1),
            ("q/k/v/wo", BATCH * tokens, dim, dim, 4 * cfg.depth),
            ("fc1", BATCH * tokens, dim, 4 * dim, cfg.depth),
            ("fc2", BATCH * tokens, 4 * dim, dim, cfg.depth)):
        x = pack_timesteps((torch.rand((t, rows, k_in), generator=gen,
                                       device=dev) < FIRING_RATE).to(
            torch.uint8))
        w = torch.randn((k_in, n_out), generator=gen, device=dev)
        w3 = bf16x3_weights(w)
        got = spike_matmul_grouped(x, w, t=t, w_bf16x3=w3)
        ref_out = ref.spike_matmul_ref(x, w, t=t)
        shape_err = float((got - ref_out).abs().max())
        check(bool(((got - ref_out).abs() <= 1e-3 + 1e-5 * ref_out.abs())
                   .all()), f"unpack_dot at {name} off its plain version by "
              f"{shape_err}")
        ms = graph_ms(torch, lambda: spike_matmul_grouped(
            x, w, t=t, w_bf16x3=w3), kernel="unpack_dot")
        prof_ms, seen = profiled_ms(
            torch, lambda: spike_matmul_grouped(x, w, t=t, w_bf16x3=w3),
            "unpack_dot_kernel")
        b_ms, b_by = unpack_dot_bound_ms(x, w, got)
        f32_ms, f32_by = bound_ms(x.numel() + w.numel() * 4 + got.numel() * 4,
                                  2 * t * rows * k_in * n_out, F32_OPS_PER_S)
        planes = unpack_timesteps(x, t).reshape(t * rows, k_in)
        by_shape[name] = dict(
            shape=f"x {tuple(x.shape)} u8, w ({k_in}, {n_out}) f32 as its "
                  f"bf16 split, t={t}",
            ms=ms, profiler_ms=prof_ms, profiler_seen=seen,
            layers_per_step=layers, ms_per_step=ms * layers,
            max_abs_err=shape_err, bound_ms=b_ms, bound_by=b_by,
            bound_ms_f32_units=f32_ms, bound_by_f32_units=f32_by,
            library_ms=graph_ms(torch, lambda: torch.matmul(planes, w)))
        del x, w, w3, got, ref_out, planes
    ops.reset_launch_counts()     # comparison launches do not count
    unpack_rows = [r for r in prof["by_kernel"]
                   if "unpack_dot_kernel" in r["kernel"]]
    return dict(
        config="SpikformerConfig() V2-8-512; the reference's default plan "
               "ExecutionPlan(): packed, float32, bucket 8, jit=True",
        compile_s=compile_s, warmup_s=warmup_s, routes=routes,
        split_layers=len(split_layers), plan_split_s=split_s,
        split_builds_per_call=split_builds,
        per_step_launches=per_step, steps=1, launches=launches,
        max_abs_logit_err_vs_plain=err, labels=logits.argmax(-1).tolist(),
        spike_flips_total=sum(f for _, f, _ in flips),
        spike_flips_by_lif=[(i, n, f, sp) for i, (n, f, sp) in
                            enumerate(flips)],
        final_residual_occupancy=final_occ,
        wall_ms=prof["wall_ms_per_step"],
        device_ms=prof["device_ms_per_step"], idle_share=prof["idle_share"],
        unpack_dot_ms_per_step_in_graph=sum(r["ms_per_step"]
                                            for r in unpack_rows),
        unpack_dot_launches_per_step_in_graph=sum(
            r["launches_per_step"] for r in unpack_rows),
        unpack_dot_by_shape=by_shape, profile=prof)


SERVE_TRACE = ROOT / "build" / "serve_trace.jsonl"


def graph_counts(torch, models) -> tuple:
    """``(eager, graphed)`` launch counts since ``reset_counts``: the
    wrappers' counters, and the sum over ``models`` of each captured
    graph's launches times its replays."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    graphed: dict = {}
    for m in models:
        for k, v in m.graph_launch_counts().items():
            graphed[k] = graphed.get(k, 0) + v
    return ops.launch_counts(), graphed


def example_launches(torch, models) -> dict:
    """Launches since ``ops.reset_launch_counts`` of an example whose
    compiled ``models`` (and LM engines) were all made inside it, so that
    their replays count from 0: the wrappers' counters (eager runs and
    captures) plus each captured graph's launches times its replays. Each
    graphed packed Spikformer model's replays must have launched its
    plan's per-step launches each."""
    from repro_torch.infer.compile import CompiledModel
    eager, graphed = graph_counts(torch, models)
    for m in models:
        if (isinstance(m, CompiledModel) and m.jit
                and m.plan.backend == "packed"):
            mine = m.graph_launch_counts()
            check_step_launches(
                {k: mine.get(k, 0) for k in eager},
                per_step_launches(m.cfg, m.plan.routes, m.weight_dtype),
                graph_replays(m))
    total = {k: eager.get(k, 0) + graphed.get(k, 0)
             for k in {*eager, *graphed}}
    return {k: v for k, v in sorted(total.items()) if v}


def check_served_labels(torch, model, summary, make_images) -> int:
    """Every completed request's labels equal ``model.classify`` of its
    images, regenerated from the run's image stream (with no rejection,
    arrival k is request k); returns the number of distinct labels, or
    None where admission control rejected requests (rids then skip
    arrivals). An accepted request never goes unanswered."""
    import numpy as np
    trace, client = summary["trace"], summary["client"]
    check(summary["requests_dropped"] == 0,
          f"accepted requests were dropped: {summary}")
    if summary["requests_rejected"]:
        return None
    images = [make_images(k, a.n_images) for k, a in enumerate(trace)]
    want = model.classify(np.concatenate(images)).tolist()
    by_rid = {r.rid: r.labels for r in client.done}
    check(sorted(by_rid) == list(range(len(trace))),
          "a request of the trace did not complete")
    i = 0
    for k, imgs in enumerate(images):
        check(by_rid[k] == want[i:i + len(imgs)],
              f"request {k}: served labels {by_rid[k]} != classify "
              f"{want[i:i + len(imgs)]}")
        i += len(imgs)
    return len(set(want))


def open_loop_row(summary) -> dict:
    """The open-loop numbers a serving run reports."""
    keys = ("requests_offered", "requests_rejected", "requests_dropped",
            "offered_rps", "elapsed_s", "images_completed", "completed_fps",
            "goodput_fps", "slo_ms", "slo_attainment", "latency_p50_s",
            "latency_p95_s", "latency_p99_s", "dispersion_index")
    rt = summary["runtime"]
    return {**{k: summary.get(k) for k in keys},
            "batches": rt["batches"], "pad_waste": rt["pad_waste"],
            "step_fps": rt["fps"], "queue_depth_peak": rt["queue_depth_peak"],
            # host-clock share of the run spent inside model steps (summed
            # over replicas): an upper bound on the card's busy share
            "step_share": summary["client"].acct.busy_s
            / summary["elapsed_s"]}


def serving_stack_phase(torch, dev, cfg, folded) -> dict:
    """The serving stack through ``repro_torch.launch.serve_spikformer``'s
    entry points, on the int8 default plan at V2-8-512, graphed, buckets
    (1, 8), serving the gained tree:

    - the closed loop (``main_closed``: 12 requests of 3 images);
    - ``--async`` with the reference's defaults (Poisson, rps 60, 1-3
      images a request, 3 s, SLO 100 ms, max wait 10 ms) under the
      reference's ``--smoke`` contract, then rps 150 and 300 ungated;
    - ``--async --replicas 2 --trace-out build/serve_trace.jsonl`` under
      the smoke contract (goodput >= 60 images/s, no replica failure), the
      span file read back with the port's ``load_spans_jsonl``;
    - a fleet of two serving the rps-60 trace while ``swap`` rolls a fresh
      compile of the same tree across it.

    Labels equal ``model.classify`` in every run. Launch gates, the swap
    run's too: a graphed run launches nothing eagerly but the fleet
    replicas' own warm-ups (each bucket of each replica, and of each swap
    candidate: one eager run and one capture, each one step's launches,
    then one replay), and the replays' launches equal the plan's per-step
    counts times the steps."""
    import numpy as np
    from repro_torch.infer import ExecutionPlan, compile
    from repro_torch.launch import serve_spikformer as cli
    from repro_torch.obs import load_spans_jsonl
    from repro_torch.serve import ServeFleet, ServePolicy, image_maker
    from repro_torch.serve import poisson_trace, run_open_loop

    t0 = time.perf_counter()
    model = compile(folded, cfg, ExecutionPlan(
        backend="packed_cuda", weight_dtype="int8", batch_buckets=(1, BATCH)),
        folded=True, device=dev)
    compile_s = time.perf_counter() - t0 + model.warmup()
    per_step = per_step_launches(cfg, model.plan.routes)
    buckets = ["--buckets", f"1,{BATCH}"]
    shape = model.input_shape()[1:]
    total: dict = {}

    def gate(models, steps, captures=0):
        eager, graphed = graph_counts(torch, models)
        want_eager = {k: per_step.get(k, 0) * captures for k in eager}
        check(eager == want_eager,
              f"eager launches {eager} != {captures} capture steps x "
              f"{per_step}: a graphed replica launched eagerly")
        check_step_launches({k: graphed.get(k, 0) for k in eager}, per_step,
                            steps)
        for k in eager:
            total[k] = total.get(k, 0) + eager[k] + graphed.get(k, 0)
        return {k: eager[k] + graphed.get(k, 0) for k in eager if
                eager[k] + graphed.get(k, 0)}

    out = {"config": "SpikformerConfig() V2-8-512; int8 default plan, "
                     "packed_cuda, jit=True, buckets (1, 8)",
           "compile_and_warmup_s": compile_s, "per_step_launches": per_step}

    # the closed loop
    args = cli.parse_args(buckets + ["--requests", "12",
                                     "--images-per-request", "3", "--smoke"])
    reset_counts(model)
    closed = cli.main_closed(model, args, compile_s)
    eng = closed["client"]
    launches = gate([model], eng.acct.batches)
    rng = np.random.default_rng(args.seed + 1)
    images = [rng.integers(0, 256, (3, *shape), dtype=np.uint8)
              for _ in range(12)]
    want = model.classify(np.concatenate(images)).tolist()
    got = [lab for r in sorted(eng.done, key=lambda r: r.rid)
           for lab in r.labels]
    check(got == want, "closed loop: served labels differ from classify")
    out["closed"] = {k: closed[k] for k in (
        "requests", "images", "batches", "fps", "pad_waste",
        "latency_p50_s", "latency_p99_s")}
    out["closed"].update(launches=launches, distinct_labels=len(set(want)))

    # the open loop, one runtime, rps 60 (gated) then 150 and 300
    out["async"] = []
    for rps in (60, 150, 300):
        args = cli.parse_args(buckets + ["--async", "--rps", str(rps)]
                              + (["--smoke"] if rps == 60 else []))
        reset_counts(model)
        summary = cli.main_async(model, args, compile_s)
        launches = gate([model], summary["runtime"]["batches"])
        distinct = check_served_labels(torch, model, summary, image_maker(
            shape, seed=args.seed + 2))
        check(rps != 60 or distinct is not None,
              "the rps-60 run rejected requests")
        out["async"].append({"rps": rps, "gated": rps == 60,
                             **open_loop_row(summary), "launches": launches,
                             "distinct_labels": distinct})

    # a fleet of two thread-backed replicas on the one card, traced
    SERVE_TRACE.parent.mkdir(exist_ok=True)
    args = cli.parse_args(buckets + ["--async", "--replicas", "2", "--smoke",
                                     "--trace-out", str(SERVE_TRACE)])
    reset_counts(model)
    summary = cli.main_async(model, args, compile_s)
    fleet = summary["client"]
    reps = [r.model for r in fleet.replicas]
    check(all(m.folded is model.folded and m._fwd is not model._fwd
              for m in reps), "fleet replicas must share the tree, not the "
          "graphed step")
    warm = len(model.buckets)            # warm-up replays a replica
    launches = gate(reps, summary["runtime"]["batches"] + warm * len(reps),
                    captures=2 * warm * len(reps))
    for rep in fleet.replicas:
        counts = rep.model.graph_launch_counts()
        check(counts == {k: v * (rep.steps + warm)
                         for k, v in per_step.items()},
              f"replica {rep.idx}: replays {counts} != {rep.steps} steps "
              f"+ {warm} warm-up replays x {per_step}")
    health = summary["health"]
    check(all(r["failures"] == 0 for r in health["replicas"]),
          f"a replica failed: {health}")
    distinct = check_served_labels(torch, model, summary, image_maker(
        shape, seed=args.seed + 2))
    check(distinct is not None, "the fleet run rejected requests")
    header, spans = load_spans_jsonl(SERVE_TRACE)
    chains: dict = {}
    for s in spans:
        if s.category == "request":
            chains.setdefault(s.rid, []).append(s.name)
    check(header["dropped_spans"] == 0 and sorted(chains) ==
          sorted(r.rid for r in fleet.done) and all(
              c == ["admit", "queue", "complete"] for c in chains.values()),
          "the span trace lacks a request's admit -> queue -> complete")
    step_rows = sum(s.value for s in spans if s.name == "step")
    check(step_rows == summary["images_completed"],
          f"step spans carry {step_rows} rows, {summary['images_completed']}"
          " images completed")
    out["fleet"] = {**open_loop_row(summary), "launches": launches,
                    "distinct_labels": distinct,
                    "replica_stats": summary["runtime"]["replica_stats"],
                    "trace": {"path": str(SERVE_TRACE.relative_to(ROOT)),
                              "spans": len(spans),
                              "requests": len(chains),
                              "dropped_spans": header["dropped_spans"]}}

    # a hot swap under the same load: a fresh compile of the same tree
    new = compile(folded, cfg, model.plan, folded=True, device=dev)
    new.warmup()
    trace = poisson_trace(rps=60.0, duration_s=3.0, seed=SEED + 1,
                          images_per_request=(1, 3))
    swapped = {}

    def swap_midway(fleet):
        time.sleep(1.0)
        t = time.perf_counter()
        fleet.swap(new, timeout=120)
        swapped["s"] = time.perf_counter() - t

    import threading
    reset_counts(model)
    with ServeFleet(model, replicas=2, policy=ServePolicy(
            max_wait_ms=10.0, slo_ms=100.0)) as fleet:
        old = [r.model for r in fleet.replicas]
        th = threading.Thread(target=swap_midway, args=(fleet,))
        th.start()
        metrics = run_open_loop(fleet, trace, image_maker(shape, seed=SEED
                                                          + 2), slo_ms=100.0)
        th.join(timeout=180)
        health = fleet.health()
    check("s" in swapped and fleet.swaps == 1, "the swap did not finish")
    check(metrics["requests_dropped"] == 0
          and metrics["requests_rejected"] == 0
          and fleet.stats()["requests_failed"] == 0
          and all(r["failures"] == 0 and r["swaps"] == 1
                  for r in health["replicas"]),
          f"the swap under load lost requests: {metrics} {health}")
    distinct = check_served_labels(torch, model, {
        **metrics, "trace": trace, "client": fleet},
        image_maker(shape, seed=SEED + 2))
    check(distinct is not None, "the swap run rejected requests")
    # each replica served on its old graphs, then on the candidate's: both
    # warmed as a fleet replica is (one eager run and one capture a bucket,
    # then one replay), and nothing else launched eagerly
    cand = [r.model for r in fleet.replicas]
    check(all(m.folded is new.folded and m._fwd is not new._fwd
              and m not in old for m in cand),
          "swapped replicas must share the new tree, not its graphed step")
    steps = sum(r.steps for r in fleet.replicas)
    launches = gate(old + cand, steps + 2 * warm * len(cand),
                    captures=4 * warm * len(cand))
    for rep, before in zip(fleet.replicas, old):
        counts = {k: v + rep.model.graph_launch_counts().get(k, 0)
                  for k, v in before.graph_launch_counts().items()}
        check(counts == {k: v * (rep.steps + 2 * warm)
                         for k, v in per_step.items()},
              f"replica {rep.idx}: replays {counts} across the swap != "
              f"{rep.steps} steps + {2 * warm} warm-up replays x {per_step}")
    out["swap"] = {**{k: metrics[k] for k in (
        "requests_offered", "requests_dropped", "requests_rejected",
        "goodput_fps", "slo_attainment", "latency_p99_s")},
        "swap_s": swapped["s"], "distinct_labels": distinct,
        "launches": launches}
    out["launches"] = total
    del new, model
    return out


def lm_prompts(vocab: int) -> list:
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, n).tolist() for n in LM_PROMPTS]


def lm_pass(torch, eng, prompts) -> dict:
    """The 8 LM requests (LM_PROMPTS tokens, 32 new tokens each) served by
    ``eng`` at once, the launch counters (the wrappers', which eager runs
    and captures tick, and the engine's captured launches x replays) set
    to 0 just before and read just after. Returns the host-clock serving
    figures, peak memory (allocated, which graph replays do not touch, and
    reserved, which holds the graph pool), the launches, the graphs
    captured during the pass and each request's tokens."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, summary

    reqs = [Request(rid=i, prompt=p, max_new=LM_MAX_NEW)
            for i, p in enumerate(prompts)]
    eng.done, eng.decode_step_s = [], []
    before = set(eng.graphs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    eng.reset_graph_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    eager, replayed = ops.launch_counts(), eng.graph_launch_counts()
    check(len(done) == len(reqs)
          and all(len(r.out) == LM_MAX_NEW and r.t_done for r in reqs),
          "an LM request did not complete with its 32 tokens")
    check(all(0 <= t < eng.cfg.padded_vocab for r in reqs for t in r.out),
          "an LM request holds a token outside the vocabulary")
    return dict(stats=summary(done, wall_s, eng.decode_step_s),
                peak_mem_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
                peak_reserved_mib=torch.cuda.max_memory_reserved() / 2 ** 20,
                launches_eager=eager, launches_replayed=replayed,
                captured=sorted(set(eng.graphs) - before),
                graphs=len(eng.graphs),
                ttft_s={r.rid: r.t_first - r.t_arrival for r in reqs},
                tokens={r.rid: r.out for r in reqs})


def check_lm_launches(eng, run: dict, what: str) -> dict:
    """The launch gate of one pass: one tensor-core flash launch a layer
    and prefill, on the wrappers' counters when eager and as captured
    launches x replays when graphed; a graphed pass launches nothing
    eagerly beyond each new graph's warm-up run and capture (twice its
    captured launches). Returns the pass's launches, eager plus
    replayed."""
    eager, replayed = run["launches_eager"], run["launches_replayed"]
    flash = {"flash_attention_tc": eng.cfg.n_layers * len(LM_PROMPTS)}
    if not eng.graphed:
        check(replayed == {} and run["captured"] == [],
              f"{what}: an eager engine replayed {replayed}")
        want_eager = {**dict.fromkeys(eager, 0), **flash}
    else:
        check(replayed == flash,
              f"{what}: replayed launches {replayed} != {flash}")
        want_eager = dict.fromkeys(eager, 0)
        for key in run["captured"]:
            for name, n in eng.graphs[key].launches.items():
                want_eager[name] += 2 * n
    check(eager == want_eager,
          f"{what}: eager launch counts {eager} != {want_eager}")
    return {k: eager[k] + replayed.get(k, 0) for k in eager}


def lm_serve_phase(torch, dev) -> tuple:
    """The LM path: smollm-360m at full width (32 layers, d_model 960, 15
    heads over 5 KV heads, vocab 49152) from a seeded ``init_model``,
    served by ``Engine(slots=4, cache_len=4096)`` in bf16 in three passes
    of the same 8 requests (LM_PROMPTS tokens, 32 new tokens each) over
    the same weights: (a) an eager engine (``jit=False``), after one short
    warm-up request; (b) a graphed engine (``jit=True``), cold: its
    warm-up request captures decode, and the pass captures its 8 prompt
    lengths; (c) the same engine, warm: every prefill and decode a
    replay. Gates: each request's 32 tokens identical across the passes,
    and each pass's launches (``check_lm_launches``). Profiles the
    2048-token prefill and a four-slot decode step eager (on (a)'s engine,
    freed after) and graphed. Returns the report and the graphed
    engine."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine, Request
    from repro_torch.nn.module import param_bytes, param_count

    cfg = get_config(LM_ARCH)
    check((cfg.n_heads, cfg.head_dim) == (LM_HEADS, LM_HEAD_DIM),
          f"{LM_ARCH} has {cfg.n_heads} heads of {cfg.head_dim}")
    prompts = lm_prompts(cfg.vocab)

    def engine(jit, params=None):
        t0 = time.perf_counter()
        eng = Engine(cfg, slots=LM_SLOTS, cache_len=LM_CACHE_LEN, seed=SEED,
                     params=params, device=dev, jit=jit)
        eng.submit(Request(rid=-1, prompt=prompts[0][:16], max_new=2))
        eng.run()                                     # warm-up
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t0

    def profiles(eng, suffix):
        reqs = sorted(eng.done, key=lambda r: r.rid)[:LM_SLOTS]
        tokens = [r.out[-1] for r in reqs]
        positions = [len(r.prompt) + LM_MAX_NEW for r in reqs]
        return {
            f"profile_prefill_2048{suffix}": profile_fn(
                torch, lambda: eng.prefill(prompts[-1]), steps=2),
            f"profile_decode{suffix}": profile_fn(
                torch, lambda: eng.decode(tokens, positions), steps=4)}

    eng, init_s = engine(jit=False)
    params = eng.params
    runs, launches, report = {}, {}, {}
    runs["eager"] = lm_pass(torch, eng, prompts)
    launches["eager"] = check_lm_launches(eng, runs["eager"], "eager pass")
    report.update(profiles(eng, "_eager"))
    del eng
    torch.cuda.empty_cache()

    eng, warm_s = engine(jit=True, params=params)
    check(sorted(eng.graphs) == [("decode", LM_SLOTS), ("prefill", 16)],
          f"the warm-up request captured {sorted(eng.graphs)}")
    for name in ("cold", "warm"):
        runs[name] = lm_pass(torch, eng, prompts)
        launches[name] = check_lm_launches(eng, runs[name], f"{name} pass")
    check(runs["cold"]["captured"] == sorted(("prefill", n)
                                             for n in LM_PROMPTS)
          and runs["warm"]["captured"] == [],
          f"captured {runs['cold']['captured']} cold, "
          f"{runs['warm']['captured']} warm")
    for rid, want in runs["eager"]["tokens"].items():
        check(runs["cold"]["tokens"][rid] == want
              and runs["warm"]["tokens"][rid] == want,
              f"LM request {rid}: graphed tokens differ from the eager "
              "engine's")
    report.update(profiles(eng, ""))
    total = {k: sum(run[k] for run in launches.values())
             for k in launches["eager"]}
    return dict(
        config=f"{LM_ARCH}: 32 layers, d_model 960, 15 heads over 5 KV heads,"
               " head_dim 64, d_ff 2560, vocab 49152, tied embeddings; "
               "seeded init_model, f32 params, bf16 compute and cache",
        params=param_count(params), param_mib=param_bytes(params) / 2 ** 20,
        init_s=init_s, prompts=list(LM_PROMPTS), max_new=LM_MAX_NEW,
        slots=LM_SLOTS, cache_len=LM_CACHE_LEN, launches=total,
        launches_by_pass=launches, tokens_identical=True,
        passes=runs, graphed_warmup_s=warm_s,
        first_tokens=[runs["eager"]["tokens"][i][:8]
                      for i in range(len(prompts))],
        **report), eng


def graphed_flash_ms(prof: dict):
    """Kernel 7's device ms a launch inside the graphed 2048-token prefill
    (its ``torch.profiler`` row over its launches), or "not measured"."""
    rows = [r for r in prof["by_kernel"] if "flash_tc_kernel" in r["kernel"]]
    if not rows:
        return "not measured"
    return (sum(r["ms_per_step"] for r in rows)
            / sum(r["launches_per_step"] for r in rows))


def lm_gate_phase(torch, dev, eng) -> dict:
    """One f32 prefill of the 1000-token prompt through the flash route
    and through the plain route (the reference's chunked softmax) on the
    card, with the served model's weights: last-position logits within
    atol = rtol = LM_LOGITS_TOL. The counters are set to 0 just before the
    flash-route prefill and read just after it: one f32 flash launch a
    layer. Then 8 greedy tokens of both routes in f32 and in bf16, printed;
    the bf16 tokens are not gated."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Engine, Request
    from repro_torch.nn import transformer as T

    cfg, params = eng.cfg, eng.params
    prompt = lm_prompts(cfg.vocab)[LM_PROMPTS.index(LM_GATE_LEN)]
    tokens = torch.tensor([prompt], device=dev)
    logits = {}
    for flash in (True, False):
        cache = T.init_cache(cfg, 1, LM_GATE_LEN, dtype=torch.float32,
                             device=dev)
        ops.reset_launch_counts()
        logits[flash], _, _ = T.model_apply(
            params, {"tokens": tokens, "cache_pos": 0}, cfg, mode="prefill",
            cache=cache, compute_dtype=torch.float32, flash=flash)
        torch.cuda.synchronize()
        if flash:
            launches = ops.launch_counts()
    expect = dict.fromkeys(launches, 0)
    expect["flash_attention_f32"] = cfg.n_layers
    check(launches == expect,
          f"f32 gate launch counts {launches} != {expect} (one f32 flash "
          "launch per layer)")
    got, want = logits[True], logits[False]
    torch.cuda.synchronize()
    check(got.shape == (1, 1, cfg.padded_vocab)
          and bool(torch.isfinite(got).all()),
          f"LM prefill logits: shape {tuple(got.shape)} or non-finite")
    err = max_abs_err(got, want)
    check(bool(((got - want).abs() <= LM_LOGITS_TOL
                + LM_LOGITS_TOL * want.abs()).all()),
          f"f32 prefill logits, flash route against plain: off by {err}")
    greedy = {}
    for dt in (torch.float32, torch.bfloat16):
        for flash in (True, False):
            e = Engine(cfg, slots=1, cache_len=LM_GATE_LEN + 8, params=params,
                       compute_dtype=dt, cache_dtype=dt, device=dev,
                       flash=flash, jit=False)
            e.submit(Request(rid=0, prompt=prompt, max_new=8))
            greedy[f"{str(dt).removeprefix('torch.')}/"
                   f"{'flash' if flash else 'plain'}"] = e.run()[0].out
    ops.reset_launch_counts()
    return dict(prompt_len=LM_GATE_LEN, launches=launches, max_abs_err=err,
                tolerance=f"atol = rtol = {LM_LOGITS_TOL}",
                logits_absmax=float(want.abs().max()), greedy=greedy,
                greedy_agree={dt: greedy[f"{dt}/flash"] == greedy[f"{dt}/plain"]
                              for dt in ("float32", "bfloat16")})


# ---------------------------------------------------------------------------
# Spikformer training: surrogate-gradient BPTT, train-mode BN, AdamW
# ---------------------------------------------------------------------------

TRAIN_BATCH = 16
TRAIN_STEPS = 5
# image_batch's class-conditional level is 20 * label + 30, which clips to
# white past label 11: at 1000 classes nearly every image is flat 255, the
# batch statistics of conv0 vanish and no LIF fires. The data therefore
# draws 10 classes (labels 0-9 of the 1000-class head).
TRAIN_DATA_CLASSES = 10
TRAIN_LOSS_RTOL = 1e-5     # the CPU tests' tolerances, card against CPU
TRAIN_GRAD_TOL = 1e-4      # of each gradient leaf's largest |g|
TRAIN_PARAM_TOL = 1e-4     # rtol and atol of the updated params


def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` takes argv)."""
    import importlib.util
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@contextlib.contextmanager
def recorded_lifs(out: list):
    """Appends every ``tflif`` output of the float graph (the Spikformer's
    and the SSA's), in call order, while the block runs."""
    from repro_torch.core import spikformer, ssa
    saved = [(m, m.tflif) for m in (spikformer, ssa)]

    def hook(fn):
        def lif(y, **kw):
            s = fn(y, **kw)
            out.append(s.detach())
            return s
        return lif

    for m, fn in saved:
        m.tflif = hook(fn)
    try:
        yield out
    finally:
        for m, fn in saved:
            m.tflif = fn


def image_batch_on(torch, dcfg, step: int, dev) -> dict:
    from repro_torch.data.pipeline import image_batch
    raw = image_batch(dcfg, step)
    return {"image": torch.from_numpy(raw["image"]).to(dev),
            "label": torch.from_numpy(raw["label"]).to(dev)}


def zeros_like_tree(torch, tree):
    if isinstance(tree, dict):
        return {k: zeros_like_tree(torch, v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def is_trainable(path: str) -> bool:
    """A leaf the optimizer trains: not a BN running mean or variance,
    which ``merge_bn_stats`` rewrites every step."""
    return not path.endswith(("/mean", "/var"))


def train_reduced_against_cpu(torch, dev) -> dict:
    """One reduced-config training step (value_and_grad, AdamW, the BN
    stats merged) on the card against the port's CPU run of the same step
    (same params and batch): loss within TRAIN_LOSS_RTOL, each gradient
    leaf within TRAIN_GRAD_TOL of its largest |g| (TF32 off, no fused op),
    every updated param within TRAIN_PARAM_TOL (rtol and atol), spike
    flips counted by LIF."""
    from repro_torch.core.spikformer import (SpikformerConfig, init,
                                             merge_bn_stats, value_and_grad)
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.infer.compile import to_device
    from repro_torch.optim import adamw
    cfg = SpikformerConfig().scaled(classes=4)
    ocfg = adamw.OptConfig(peak_lr=2e-3, warmup_steps=1, decay_steps=4)
    dcfg = DataConfig(global_batch=TRAIN_BATCH,
                      image_size=cfg.img_size, n_classes=4, seed=SEED)
    params = init(torch.Generator().manual_seed(SEED), cfg)
    runs = {}
    for where in ("cpu", "cuda"):
        d = torch.device(where)
        spikes: list = []
        p = to_device(params, d)
        with recorded_lifs(spikes):
            (loss, (acc, stats)), grads = value_and_grad(
                p, image_batch_on(torch, dcfg, 0, d), cfg)
        new, _, _ = adamw.update(grads, adamw.init(p, ocfg), p, ocfg)
        new = merge_bn_stats(new, stats)
        runs[where] = (float(loss), dict(tree_leaves(grads)),
                       dict(tree_leaves(new)), [s.cpu() for s in spikes])
    (l_cpu, g_cpu, p_cpu, s_cpu), (l_gpu, g_gpu, p_gpu, s_gpu) = (
        runs["cpu"], runs["cuda"])
    worst = 0.0
    for k, want in g_cpu.items():
        scale = float(want.abs().max())
        err = float((g_gpu[k].cpu() - want).abs().max())
        worst = max(worst, err / scale if scale > 0 else err)
    # elements of the updated params outside atol + rtol * |CPU value|
    param_misses = {}
    for k, want in p_cpu.items():
        miss = int(((p_gpu[k].cpu() - want).abs()
                    > TRAIN_PARAM_TOL + TRAIN_PARAM_TOL * want.abs()).sum())
        if miss:
            param_misses[k] = miss
    flips = [int((a != b).sum()) for a, b in zip(s_gpu, s_cpu)]
    out = {"loss_cpu": l_cpu, "loss_card": l_gpu,
           "loss_rel_err": abs(l_gpu - l_cpu) / abs(l_cpu),
           "grad_err_of_leaf_max": worst,
           "updated_param_leaves": len(p_cpu),
           "updated_param_misses": param_misses,
           "spike_flips_by_lif": flips, "lifs": len(flips)}
    check(len(s_gpu) == len(s_cpu), "card and CPU ran different LIF counts")
    check(out["loss_rel_err"] <= TRAIN_LOSS_RTOL,
          f"reduced training loss, card vs CPU: {out}")
    check(worst <= TRAIN_GRAD_TOL,
          f"reduced training gradients, card vs CPU: {out}")
    check(not param_misses,
          f"reduced training updated params, card vs CPU: {out}")
    return out


def spikformer_train_phase(torch, dev) -> dict:
    """The port's training path at full width: ``SpikformerConfig()``
    (V2-8-512, 224x224x3, T=4, 8 blocks, 1000 classes) from the seeded
    ``init``, TRAIN_STEPS AdamW steps at batch TRAIN_BATCH on seeded
    ``image_batch`` data, eager autograd through the float graph (atan
    surrogate at every LIF, BN on batch statistics), the BN stats merged
    after each step. Gates: every loss and gradient leaf finite, gradient
    norms > 0 at ``scs/conv0`` and in the last block; the first update
    moved a trainable leaf at ``scs/conv0`` and in the last block past
    where weight decay alone takes it (the same update from the same state
    with zero gradients); trainable leaves changed over the run; the last
    residual firing under train-mode BN. Then the reduced step on the card
    against the CPU, and ``examples/torch_classify_spikformer.py`` at its
    defaults (loss falls, accuracy above chance, ``packed`` equal to
    ``reference`` bit for bit), its launches counted with its graphs'
    replays."""
    import math
    from repro_torch.core import spikformer
    from repro_torch.core.spikformer import (SpikformerConfig, init,
                                             merge_bn_stats, value_and_grad)
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.infer.compile import to_device
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = SpikformerConfig()
    dcfg = DataConfig(global_batch=TRAIN_BATCH,
                      image_size=cfg.img_size, n_classes=TRAIN_DATA_CLASSES,
                      seed=SEED)
    params = to_device(init(torch.Generator().manual_seed(SEED), cfg), dev)
    first = {k: v.clone() for k, v in tree_leaves(params)}
    ocfg = adamw.OptConfig(peak_lr=2e-3, warmup_steps=1,
                           decay_steps=TRAIN_STEPS, weight_decay=0.01)
    opt = adamw.init(params, ocfg)
    batches = [image_batch_on(torch, dcfg, i, dev) for i in range(TRAIN_STEPS)]
    last_residual: list = []
    combine = spikformer._combine

    def recording_combine(new, res, mode):
        out = combine(new, res, mode)
        last_residual[:] = [out.detach()]
        return out

    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spikformer._combine = recording_combine
    try:
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            (loss, (acc, stats)), grads = value_and_grad(params, batch, cfg)
            leaves = dict(tree_leaves(grads))
            finite = all(bool(torch.isfinite(g).all())
                         for g in leaves.values())
            block = f"/blocks/b{cfg.depth - 1}/"
            conv0 = float(adamw.global_norm(grads["scs"]["conv0"]))
            last = float(adamw.global_norm(
                {k: g for k, g in leaves.items() if k.startswith(block)}))
            if i == 0:
                # zero moments: with zero gradients the update is the decay
                decayed = dict(tree_leaves(adamw.update(
                    zeros_like_tree(torch, grads), opt, params, ocfg)[0]))
            params, opt, metrics = adamw.update(grads, opt, params, ocfg)
            if i == 0:
                beyond = sorted(k for k, v in tree_leaves(params)
                                if is_trainable(k)
                                and not torch.equal(v, decayed[k]))
                del decayed
            params = merge_bn_stats(params, stats)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            firing = float(last_residual[0].mean())
            steps.append({"step": i, "loss": float(loss), "acc": float(acc),
                          "grad_norm": float(metrics["grad_norm"]),
                          "grad_norm_conv0": conv0,
                          "grad_norm_last_block": last,
                          "finite": finite and math.isfinite(float(loss)),
                          "final_residual_firing": firing, "ms": ms})
    finally:
        spikformer._combine = combine
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    changed = sum(int(not torch.equal(first[k], v))
                  for k, v in tree_leaves(params) if is_trainable(k))
    trainable = sum(map(is_trainable, first))
    # the first step builds the autograd graph's caches: time the rest
    ms = [s["ms"] for s in steps[1:]]
    out = {"config": "SpikformerConfig() (V2-8-512, 224x224x3, T=4, depth "
                     "8, 1000 classes), seeded init, AdamW(peak_lr 2e-3, "
                     "warmup 1, weight_decay 0.01), eager; image_batch "
                     f"of {TRAIN_DATA_CLASSES} classes",
           "batch": TRAIN_BATCH, "steps": steps,
           "ms_per_step": sum(ms) / len(ms),
           "images_per_s": TRAIN_BATCH * len(ms) / (sum(ms) / 1e3),
           "peak_mem_mib": peak, "trainable_leaves": trainable,
           "trainable_leaves_changed": changed,
           "trainable_leaves_past_decay_step0": len(beyond),
           "final_residual_firing": steps[-1]["final_residual_firing"]}
    check(all(s["finite"] for s in steps),
          f"a loss or gradient leaf is not finite: {steps}")
    check(all(s["grad_norm_conv0"] > 0 and s["grad_norm_last_block"] > 0
              for s in steps), f"a zero gradient norm: {steps}")
    check(any(k.startswith("/scs/conv0/") for k in beyond)
          and any(k.startswith(block) for k in beyond),
          f"the first update moved scs/conv0 or the last block only as "
          f"weight decay does: {beyond}")
    check(changed > 0, "training changed no trainable parameter")
    check(out["final_residual_firing"] > 0,
          "the final residual stream is silent under train-mode BN")
    del params, opt, grads, batches, first
    torch.cuda.empty_cache()

    out["reduced_vs_cpu"] = train_reduced_against_cpu(torch, dev)

    ops.reset_launch_counts()
    classify = load_example("torch_classify_spikformer").main([])
    out["launches"] = example_launches(
        torch, [classify["model"], classify["reference"]])
    out["classify"] = {k: classify[k] for k in (
        "eval_images", "accuracy", "chance", "fps", "latency_p95_s",
        "pad_waste", "packed_matches_reference_exactly")}
    out["classify"]["loss_first"] = classify["losses"][0]
    out["classify"]["loss_last"] = classify["losses"][-1]
    check(classify["losses"][-1] < classify["losses"][0],
          f"classify: the loss did not fall: {out['classify']}")
    check(classify["accuracy"] > classify["chance"],
          f"classify: accuracy not above chance: {out['classify']}")
    check(classify["packed_matches_reference_exactly"] is True,
          "classify: packed logits differ from reference")
    return out


def examples_phase(torch, dev, report: dict) -> dict:
    """The port's quickstart on the card, then short forms of the serving
    examples, the launch counts set to 0 just before and read just after
    (``example_launches``: eager launches and captures, and each graphed
    model's captured launches times its replays). Gates: the quickstart
    launched the f32 STDP, the f32 unpack dot (``per_plane``), the
    shift-sum and the TFLIF kernels; the serving examples completed every
    request and window and dropped none.
    Prints the analytic engine model's frames per second beside the card's
    measured serving rate."""
    from repro_torch.core import engine_model
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    quick = load_example("torch_quickstart").main([])
    launches = example_launches(torch, [quick.pop("model")])
    for k in ("stdp", "unpack_dot", "shift_sum", "tflif"):
        check(launches.get(k, 0) > 0,
              f"the quickstart did not launch {k}: {launches}")
    out = {"quickstart": quick, "quickstart_launches": dict(launches)}
    ops.reset_launch_counts()
    load = load_example("torch_serve_under_load").main(
        ["--rates", "40,160", "--duration", "1"])
    models = [load.pop("model")]
    load = load["rows"]
    check(all(r["dropped"] == 0 and r["rejected"] == 0 for r in load),
          f"serve_under_load dropped or rejected: {load}")
    events = load_example("torch_serve_events").main(["--duration-ms", "200"])
    check(events["session"]["windows_shed"] == 0
          and events["replay"]["labels_match_live_run"],
          f"serve_events: {events['session']}, {events['replay']}")
    models.append(events.pop("model"))
    lm = load_example("torch_serve_lm").main([])
    check(lm["requests"] == 12 and lm["new_tokens"] == 12 * 24,
          f"serve_lm: {lm}")
    serving = example_launches(torch, models + [lm["engine"]])
    for k, v in serving.items():
        launches[k] = launches.get(k, 0) + v
    out.update({"serve_under_load": load,
                "serve_events": {k: events[k] for k in ("stream", "encoding",
                                                        "session", "replay")},
                "serve_lm": {k: v for k, v in lm.items() if k != "engine"},
                "serving_launches": serving, "launches": launches})
    served = (report.get("int8_default_serve") or {}).get("stats") or {}
    out["engine_model"] = {
        "paper_engine_ideal_fps": engine_model.frames_per_second(),
        "paper_engine_calibrated_fps":
            engine_model.frames_per_second(calibrated=True),
        "card_int8_default_closed_loop_fps": served.get("fps")}
    return out


# readings beyond the contract's keys, kept in the kernels line
EXTRA_KEYS = ("library_int8_ms", "ms_int16_table", "ms_events",
              "ms_in_graph", "ms_conv0_stride0", "ms_index_entry",
              "ms_fc1_f32", "bound_ms_fc1_f32", "library_ms_fc1_f32",
              "ms_conv0_int16", "ms_conv0_f32", "ms_packed_default_f32")


def kernel_table(report: dict, paths) -> list:
    """One row per kernel: what it replaces, its launches on the driven
    paths, its error against its plain version and its times. Fails if a
    kernel of a path was launched on no path."""
    table = []
    for name, row in report["kernels"].items():
        source, replaces = SOURCES[name]
        launches = {p: report[p]["launches"].get(name, 0) for p in paths
                    if report[p]["launches"].get(name, 0)}
        check(bool(launches) != (name in OFF_PATH),
              f"{name} was launched on {launches or 'no path'}")
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces,
                      "launches": sum(launches.values()),
                      "launches_by_path": launches,
                      **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms")},
                      **{k: row[k] for k in EXTRA_KEYS if k in row},
                      "shape": row["shape"]})
    return table


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke test runs only on "
              "the card", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core.spikformer import SpikformerConfig
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build = _build.build_all()
    build_s = time.perf_counter() - t0
    kind = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"
    print(f"device: {kind}; build {build_s:.1f} s", flush=True)

    report = {"device": kind, "nvidia_smi": smi, "build_s": build_s,
              "versions": {"python": sys.version.split()[0],
                           "torch": torch.__version__,
                           "cuda": torch.version.cuda},
              "build_logs": {k: v["log"] for k, v in build.items()}}
    out_dir = ROOT / "build"
    paths = ("int8_default_serve", "f32_lut_serve", "int8_unpack_step",
             "int8_route_fit", "serving_stack", "events_cli",
             "events_full_width", "packed_default_f32", "lm_serve",
             "lm_gate", "spikformer_train", "examples")
    try:
        report["kernels"] = kernel_phase(torch, dev)
        for k, row in report["kernels"].items():
            row["profile_windows"] = PROFILE_WINDOWS.get(k, [])
        cfg = SpikformerConfig()
        folded = gained_tree(torch, cfg)
        requests = request_images(cfg)
        batch = torch.from_numpy(np.concatenate(requests)[:BATCH]).to(dev)
        report[paths[0]] = serve_phase(torch, dev, cfg, folded, requests,
                                       batch)
        int8_logits = report[paths[0]].pop("logits")
        torch.cuda.empty_cache()
        report[paths[1]] = lut_serve_phase(torch, dev, cfg, folded, requests,
                                           batch)
        torch.cuda.empty_cache()
        report[paths[2]] = unpack_step_phase(torch, dev, cfg, folded, batch,
                                             int8_logits)
        torch.cuda.empty_cache()
        report[paths[3]] = route_phase(torch, dev, cfg, folded, requests,
                                       batch, int8_logits)
        torch.cuda.empty_cache()
        report[paths[4]] = serving_stack_phase(torch, dev, cfg, folded)
        torch.cuda.empty_cache()
        report[paths[5]] = events_cli_phase(torch, dev)
        torch.cuda.empty_cache()
        report[paths[6]] = events_full_width_phase(torch, dev)
        torch.cuda.empty_cache()
        report[paths[7]] = packed_default_f32_phase(torch, dev, cfg, folded,
                                                    batch)
        report["kernels"]["unpack_dot"]["ms_packed_default_f32"] = {
            k: v["ms"] for k, v in
            report[paths[7]]["unpack_dot_by_shape"].items()}
        torch.cuda.empty_cache()
        report[paths[8]], lm_engine = lm_serve_phase(torch, dev)
        report["kernels"]["flash_attention_tc"]["ms_in_graph"] = \
            graphed_flash_ms(report[paths[8]]["profile_prefill_2048"])
        report[paths[9]] = lm_gate_phase(torch, dev, lm_engine)
        del lm_engine
        torch.cuda.empty_cache()
        report[paths[10]] = spikformer_train_phase(torch, dev)
        torch.cuda.empty_cache()
        report[paths[11]] = examples_phase(torch, dev, report)
        table = kernel_table(report, paths)
    except CheckFailed as e:
        print(f"chip_smoke.py: CHECK FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(
            json.dumps(report, indent=1, default=str))

    for p in paths[:3]:
        r = report[p]
        print(json.dumps({"path": p, "steps": r["steps"], "jit": r["jit"],
                          "serve": r.get("stats"),
                          "bucket8_labels": r["bucket8_labels"],
                          "final_residual_occupancy":
                              r["final_residual_occupancy"]}))
        for window in ("profile", "profile_eager"):
            prof = r[window]
            print(json.dumps({"path": p, window: {
                k: v for k, v in prof.items() if k != "by_kernel"},
                "top_kernels": [(k["kernel"][:48], round(k["ms_per_step"], 4))
                                for k in prof["by_kernel"][:8]]}))
    fit = report["int8_route_fit"]
    print(json.dumps({"route_fit": {
        k: fit[k] for k in ("fitted_keys", "fit_agreement", "fit_s",
                            "route_counts", "engine_host_ms")},
        "fitted_routes": fit["routes"]["fitted"]}))
    print(json.dumps({"route_cells": [
        {k: c[k] for k in ("constants", "jit", "device_ms", "wall_ms",
                           "idle_share", "images_per_s", "engine_ms_per_step",
                           "model_step_ms_per_step", "peak_mem_mib",
                           "per_step_launches", "profiled_launches_per_step",
                           "profile_step_s", "profile_step_routes")}
        for c in fit["cells"]]}))
    stack = report["serving_stack"]
    print(json.dumps({"serving_stack": {k: stack[k] for k in (
        "closed", "async", "fleet", "swap", "per_step_launches")}}))
    print(json.dumps({"events_cli": report["events_cli"]["runs"]}))
    print(json.dumps({"events_full_width": {
        k: v for k, v in report["events_full_width"].items()
        if k not in ("routes", "all_launches")}}))
    f32 = report["packed_default_f32"]
    print(json.dumps({"packed_default_f32": {
        k: f32[k] for k in (
            "per_step_launches", "launches", "max_abs_logit_err_vs_plain",
            "final_residual_occupancy", "wall_ms", "device_ms", "idle_share",
            "plan_split_s", "split_builds_per_call", "spike_flips_total",
            "spike_flips_by_lif", "unpack_dot_ms_per_step_in_graph",
            "unpack_dot_launches_per_step_in_graph", "unpack_dot_by_shape")},
        "top_kernels": [(k["kernel"][:48], round(k["ms_per_step"], 4))
                        for k in f32["profile"]["by_kernel"][:8]]}))
    lm = report["lm_serve"]
    for name in ("eager", "cold", "warm"):
        run = lm["passes"][name]
        print(json.dumps({"path": "lm_serve", "pass": name,
                          "serve": run["stats"],
                          "peak_mem_mib": run["peak_mem_mib"],
                          "peak_reserved_mib": run["peak_reserved_mib"],
                          "captured": len(run["captured"]),
                          "graphs": run["graphs"],
                          "launches": lm["launches_by_pass"][name]}))
    print(json.dumps({"path": "lm_serve",
                      "tokens_identical": lm["tokens_identical"],
                      "graphed_warmup_s": lm["graphed_warmup_s"]}))
    for window in ("profile_prefill_2048", "profile_prefill_2048_eager",
                   "profile_decode", "profile_decode_eager"):
        prof = lm[window]
        print(json.dumps({"path": "lm_serve", window: {
            k: v for k, v in prof.items() if k != "by_kernel"},
            "top_kernels": [(k["kernel"][:48], round(k["ms_per_step"], 4))
                            for k in prof["by_kernel"][:8]]}))
    print(json.dumps({"lm_gate": report["lm_gate"]}))
    print(json.dumps({"spikformer_train": report["spikformer_train"]}))
    ex = report["examples"]
    print(json.dumps({"examples": {k: ex[k] for k in (
        "quickstart_launches", "serving_launches", "serve_under_load",
        "serve_events", "serve_lm", "engine_model")}}))
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
