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
   prefill with its 15 heads over 5 KV heads read in place (and at
   hymba-1.5b's, 25 heads over 5, glm4-9b's, 32 over 2 at Dh 128,
   stablelm-12b's, 32 over 8 at Dh 160, qwen3-moe-30b-a3b's, 32 over
   4 at Dh 128, qwen2-vl-7b's, 28 over 4 at Dh 128, and whisper-large-v3's
   three layouts of a 4-row, 440-token prefill over 1500 frames: the
   encoder's and the cross-attention's non-causal, the decoder's causal),
   the f32 unpack
   dot on the bf16 tensor cores, and the f32 STDP (spikes, then real
   values) and f32 flash attention in split TF32 on the tensor cores, at
   (15, 2048, 64) and at stablelm-12b's prefill layout, Dh 160),
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
   (the f32 flash kernel, once a layer, handed the layer's q, k and v
   views at their own addresses) against the plain route; then the
   hybrid path, hymba-1.5b at full width (32 layers, d_model 1600, 25
   heads over 5 KV heads, a Mamba2 SSD mixer beside attention in every
   layer, sliding window 2048 over ring caches but in global layers
   0/15/31), the same three passes over 8 requests of 77 to 3000 tokens
   (2040 and 2048 wrap the rings in decode; 2500 and 3000 run kernel 7
   only in the 3 global layers, the windowed ones the plain windowed
   softmax), tokens identical, launches gated (198 a pass), profiled;
   its f32 prefill gate at 2048 and 3000 tokens (32 and 3 f32 flash
   launches, logits within 1e-4 of the plain route); and the SSM path,
   mamba2-130m at full width (24 SSD layers, no attention, no kernel),
   the same three passes and prompts, tokens identical;
5. trains ``SpikformerConfig()`` from the seeded ``init`` for 5 AdamW
   steps at batch 16 (eager surrogate-gradient BPTT, BN on batch
   statistics), gating finite losses and gradients, nonzero gradient
   norms at conv0 and in the last block, changed parameters and a firing
   last residual; holds the reduced training step on the card to the same
   step on the CPU; runs ``examples/torch_classify_spikformer.py`` at its
   defaults (loss falls, accuracy above chance, ``packed`` logits equal to
   ``reference``'s);
6. runs ``examples/torch_quickstart.py`` (launching the f32 STDP, the f32
   unpack dot, the shift-sum and TFLIF kernels), short forms of the
   three serving examples and ``examples/torch_train_lm_100m.py`` for 4
   steps, and prints the analytic engine model's frames per second beside
   the card's served rate;
7. drives the dense family's two large one-card configs at full width and
   depth, one at a time (each engine and its weights freed before the
   next): stablelm-12b (40 layers, d_model 5120, 32 heads over 8 KV heads
   at Dh 160, QK-norm, a quarter of each head rotated, layernorm; 12.1B
   params, 48.6 GB in f32) and glm4-9b (40 layers, d_model 4096, 32 heads
   over 2 at Dh 128, QKV bias, half rotary; 9.4B, 37.6 GB), each as the
   smollm path is driven (the same 8 requests and three passes, tokens
   identical, 40 bf16 flash launches a prefill, 320 a pass, profiles),
   its ``init_model`` timed and its peak memory gated to the parameters
   plus 1 GiB, then its f32 prefill gate at 2048 tokens (40 f32 flash
   launches, views in place, logits within 1e-4 of the plain route);
8. drives the MoE family the same way, last: qwen3-moe-30b-a3b at full
   width and depth (48 layers, d_model 2048, 32 heads over 4 KV heads at
   Dh 128, QK-norm, 128 experts top-8 of moe_d_ff 768 in every layer,
   vocab 151936; 30.5B params) in bf16 weights (61.1 GB; its config's f32
   params, 122 GB, do not fit the card), the router and norms in f32:
   the three passes (tokens identical, 48 bf16 flash launches a prefill,
   384 a pass), ``init_model``'s peak gated to the parameters plus 1 GiB,
   then its f32 prefill gate at 2048 tokens (48 f32 flash launches),
   reporting the (token, expert) choices each layer dropped past
   capacity in that prefill, in f32 and in bf16, and the tokens whose
   experts differ between the flash and plain routes;
9. trains smollm-360m at full width and depth through the port's
   ``launch.train.main`` (global batch 8 of 2048 tokens in microbatches of
   4, remat, 6 AdamW steps, a checkpoint every 3 steps), uninterrupted
   and again with a failure injected at step 4, the counters at 0 before
   and read after: finite losses and gradient norms, the loss falls,
   ``wq``/``wk``/``wv`` gradients nonzero in layers 0 and 31, the first
   update past weight decay alone in every (leaf, layer), no launch of
   kernel 7 (training runs the plain attention), the failed run restores
   the tree it saved bit for bit and then logs the uninterrupted run's
   losses within 1e-4, no ``.tmp`` left and at most 3 commits; reports ms
   a step, tokens/s, peak memory, the checkpoint seconds and a profiled
   step; then each ported family's reduced train step on the card against
   the CPU (f32 compute: loss, every gradient leaf, the updated params);
10. drives the encoder-decoder and VLM families at full width and depth,
   last, one large model alive at a time: whisper-large-v3 (32 encoder
   and 32 decoder layers, d_model 1280, 20 heads at Dh 64, 1500 seeded
   frame embeddings; the reference's Engine takes no frames, so each pass
   prefills 4 rows through ``model_apply`` and takes 32 greedy decode
   steps of ``make_serve_step``, one pass at each of 4, 64, 200 and 440
   tokens), 96 bf16 flash launches a prefill (the encoder's non-causal
   self-attention over the 1500 frames, each decoder layer's causal
   self-attention and its non-causal cross-attention) and none in decode,
   then its f32 gates (flash against plain within 1e-4 with 96 f32
   launches; prefill plus three decode steps within the reference's 5e-2
   of the train-mode forward); qwen2-vl-7b (28 layers, d_model 3584, 28
   heads over 4 at Dh 128, M-RoPE 16/24/24, f32 params) through the
   engine as a text model in the dense paths' three passes (28 flash
   launches a prefill), one image prompt (256 seeded image embeddings of
   a 16 x 16 patch grid, then 512 text tokens, with Qwen2-VL's 3-D
   positions) and 32 decode steps, and its f32 gates at 2048 text tokens
   and on the image prompt.

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
# the hybrid path: hymba-1.5b at full width (window 2048, global layers
# 0/15/31); 2040 and 2048 make decode wrap the windowed rings, 2500 and
# 3000 take the long-prompt branch (flash in the 3 global layers only)
HYBRID_ARCH = "hymba-1.5b"
HYBRID_HEADS, HYBRID_KV_HEADS = 25, 5
HYBRID_PROMPTS = (77, 300, 1000, 1536, 2040, 2048, 2500, 3000)
HYBRID_GATE_LENS = (2048, 3000)
PROFILE_LEN = 2048     # the prefill each LM path profiles
# the SSM path: mamba2-130m at full width, the hybrid path's prompts
SSM_ARCH = "mamba2-130m"
# the dense family's two large one-card paths at full width and depth, the
# smollm path's prompts: stablelm-12b (Dh 160, 32 heads over 8 KV heads,
# QK-norm, quarter rotary, layernorm) and glm4-9b (Dh 128, 32 over 2: group
# 16, QKV bias, half rotary); each f32 gate at 2048 tokens
DENSE12B_ARCH, DENSE9B_ARCH = "stablelm-12b", "glm4-9b"
DENSE_GATE_LENS = (2048,)
# the MoE path at full width and depth, the smollm path's prompts:
# qwen3-moe-30b-a3b (128 experts top-8, Dh 128, 32 heads over 4) in bf16
# weights, the only dtype in which it fits one card
MOE_ARCH, MOE_PARAM_DTYPE = "qwen3-moe-30b-a3b", "bfloat16"

# the encoder-decoder path: whisper-large-v3 at full width and depth, eager
# through model_apply and make_serve_step (the reference's Engine takes no
# frames): ENCDEC_ROWS rows a pass, each its own seeded 1500 frames and
# prompt, one pass a prompt length (448 is Whisper's decoder context)
ENCDEC_ARCH = "whisper-large-v3"
ENCDEC_HEADS, ENCDEC_HEAD_DIM, ENCDEC_FRAMES = 20, 64, 1500
ENCDEC_ROWS = 4
ENCDEC_PROMPTS = (4, 64, 200, 440)
ENCDEC_PROFILE_LEN = 440
ENCDEC_MAX_NEW = 32
ENCDEC_DECODE_TOL = 5e-2   # the reference's own prefill + decode bar
# the VLM path: qwen2-vl-7b at full width and depth served as the dense
# paths are, then one image prompt: a 16 x 16 patch grid (256 seeded image
# embeddings) and 512 text tokens
VLM_ARCH = "qwen2-vl-7b"
VLM_GRID = 16
VLM_TEXT = 512

# published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
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
        STDP_F32_TOL, stdp_attention, stdp_attention_packed,
        stdp_attention_packed_plain)
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

    # STDP at (T*B*heads, N, Dh) = (256, 196, 64): spikes bit for bit, then
    # real values within STDP_F32_TOL of the f32 sums' error scale
    bh, dh = t * BATCH * heads, dim // heads
    q, k, v = (spikes(bh, tokens, dh).to(torch.float32) for _ in range(3))
    got = stdp_attention(q, k, v, scale=0.125)
    want = ref.stdp_attention_ref(q, k, v, scale=0.125)
    check(torch.equal(got, want), "stdp kernel differs from its plain version")
    err = max_abs_err(got, want)
    v8 = v * 0.125
    check(torch.equal(torch.bmm(torch.bmm(q, k.mT), v8), want),
          "two bmms do not compute the STDP function")
    qr, kr, vr = (torch.randn((bh, tokens, dh), generator=gen, device=dev)
                  for _ in range(3))
    got = stdp_attention(qr, kr, vr, scale=0.125)
    want = ref.stdp_attention_ref(qr, kr, vr, scale=0.125)
    scale_r = ref.stdp_attention_ref(qr.abs(), kr.abs(), vr.abs(),
                                     scale=0.125)
    real_rel = float(((got - want).abs() / scale_r).max())
    check(real_rel <= STDP_F32_TOL,
          f"stdp kernel on real values off its plain version by {real_rel} "
          f"of (|Q| |K|^T) |V| * scale, over {STDP_F32_TOL}")
    # the f32 function: 3 TF32 products a product on the tensor cores
    ops_n = 4 * bh * tokens * tokens * dh
    nbytes = 4 * q.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 3 * ops_n, TF32_OPS_PER_S)
    out["stdp"] = dict(
        shape=f"q, k, v {tuple(q.shape)} f32 spikes; real values "
              "(randn) checked beside",
        max_abs_err=err, real_max_abs_err=max_abs_err(got, want),
        real_err_over_error_scale=real_rel,
        tolerance=f"spikes exact; real |err| <= {STDP_F32_TOL} x "
                  "(|Q| |K|^T) |V| x scale",
        bound_ms_f32_units=bound_ms(nbytes, ops_n, F32_OPS_PER_S)[0],
        bytes_bound_ms=bound_ms(nbytes, 0, F32_OPS_PER_S)[0],
        ms_real=device_ms(torch, lambda: stdp_attention(qr, kr, vr,
                                                        scale=0.125),
                          "stdp_kernel"),
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
    f32 in split TF32 on the tensor cores at (15, 2048, 64), the gate
    route. bf16 again at hymba-1.5b's 2048-token prefill (``at_hymba_shape``:
    25 heads over 5 KV heads, group 5), at glm4-9b's (``at_glm4_shape``: 32
    over 2, group 16, Dh 128) and at stablelm-12b's (``at_stablelm_shape``:
    32 over 8, Dh 160) and at qwen3-moe-30b-a3b's (``at_qwen3moe_shape``:
    32 over 4, Dh 128), laid out the same way; f32 again at
    stablelm-12b's, in that layout too (the gate route hands the kernel
    those views). bf16 again at whisper-large-v3's three layouts of a
    prefill of ENCDEC_ROWS rows of 440 tokens over 1500 frames (20 heads,
    Dh 64): the encoder's non-causal self-attention over the frames
    (``at_whisper_encoder_shape``: q, k, v transposed projections), the
    decoder's causal self-attention (``at_whisper_self_shape``: k, v
    slices of a cache 32 longer) and its non-causal cross-attention of the
    440 queries over the 1500 frames' keys (``at_whisper_cross_shape``),
    and at qwen2-vl-7b's 2048-token prefill (``at_qwen2vl_shape``: 28 over
    4, group 7, Dh 128) and qwen1.5-110b's (``at_qwen110b_shape``: 64 over
    8, group 8, Dh 128, the sharded path's); SDPA beside each with
    ``is_causal`` as the kernel's."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    kvh = 5
    h, s, dh = LM_HEADS, PROFILE_LEN, LM_HEAD_DIM
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

    def at(h, kvh, dh, model, dtype=torch.bfloat16, *, b=1, nq=s, nkv=s,
           causal=True, kv="cache", cache_len=None, what=None):
        """The kernel of ``dtype`` at one model's prefill layout (default:
        a 2048-token prefill): q transposed from (B, Nq, H, Dh); k and v
        the first Nkv rows of a (B, KV, ``cache_len``, Dh) cache (default
        2 Nkv) where ``kv="cache"``, else transposed from (B, Nkv, KV, Dh)
        projections; read in place; SDPA on KV expanded to the H heads
        beforehand, ``is_causal=causal``. The bound counts the (query,
        key) pairs the mask keeps; the f32 bound counts three TF32
        products (and gives the f32 units' beside it)."""
        scale = dh ** -0.5
        q = torch.randn((b, nq, h, dh), generator=gen, device=dev).to(
            dtype).transpose(1, 2)
        if kv == "cache":
            k, v = (torch.randn((b, kvh, cache_len or 2 * nkv, dh),
                                generator=gen, device=dev).to(dtype)[
                                    :, :, :nkv] for _ in range(2))
        else:
            k, v = (torch.randn((b, nkv, kvh, dh), generator=gen,
                                device=dev).to(dtype).transpose(1, 2)
                    for _ in range(2))
        name = str(dtype).removeprefix("torch.")
        err = held(flash_attention(q, k, v, scale=scale, causal=causal),
                   flash_attention_plain(q, k, v, scale=scale,
                                         causal=causal),
                   f"{name}, {model}")
        qc = q.contiguous()
        ke, ve = (z.repeat_interleave(h // kvh, dim=1).contiguous()
                  for z in (k, v))
        size = q.element_size()
        nbytes = (q.numel() + k.numel() + v.numel()) * size + q.numel() * 4
        kept = (nq * (nkv - nq) + nq * (nq + 1) // 2 if causal
                else nq * nkv)                # (query, key) pairs a head
        ops_h = 4 * b * h * kept * dh
        if dtype == torch.bfloat16:
            kernel = "flash_tc_kernel"
            b_ms, b_by = bound_ms(nbytes, ops_h, BF16_OPS_PER_S)
        else:
            kernel = "flash_attention_kernel"
            b_ms, b_by = bound_ms(nbytes, 3 * ops_h, TF32_OPS_PER_S)
        call = lambda: flash_attention(  # noqa: E731
            q, k, v, scale=scale, causal=causal)
        views = "cache slices" if kv == "cache" else "transposed views"
        what = what or f"{model}'s 2048-token prefill"
        row = dict(
            shape=f"q {tuple(q.shape)} {name} (transposed view) over k, v "
                  f"{tuple(k.shape)} {name} ({views}), "
                  f"{'causal' if causal else 'non-causal'}, scale {scale} "
                  f"({what}, one layer)",
            max_abs_err=err, tolerance=f"atol = rtol = {FLASH_TOL}",
            ms=device_ms(torch, call, kernel),
            ms_events=time_ms(torch, call),
            plain_ms=time_ms(torch, lambda: flash_attention_plain(
                q, k, v, scale=scale, causal=causal)),
            bound_ms=b_ms, bound_by=b_by,
            bytes_bound_ms=bound_ms(nbytes, 0, BF16_OPS_PER_S)[0],
            library_ms=graph_ms(torch, lambda: sdpa(
                qc, ke, ve, is_causal=causal, scale=scale)))
        if dtype == torch.float32:
            row["bound_ms_f32_units"] = bound_ms(nbytes, ops_h,
                                                 F32_OPS_PER_S)[0]
        row["ms_again"] = device_ms(torch, call, kernel)
        return row

    tc = at(h, kvh, dh, LM_ARCH)
    tc["at_hymba_shape"] = at(HYBRID_HEADS, HYBRID_KV_HEADS, dh, HYBRID_ARCH)
    tc["at_glm4_shape"] = at(32, 2, 128, DENSE9B_ARCH)
    tc["at_stablelm_shape"] = at(32, 8, 160, DENSE12B_ARCH)
    tc["at_qwen3moe_shape"] = at(32, 4, 128, MOE_ARCH)
    wh, wd, frames = ENCDEC_HEADS, ENCDEC_HEAD_DIM, ENCDEC_FRAMES
    rows, n = ENCDEC_ROWS, ENCDEC_PROFILE_LEN
    prefill = (f"{ENCDEC_ARCH}'s prefill of {rows} rows of {n} tokens over "
               f"{frames} frames")
    tc["at_whisper_encoder_shape"] = at(
        wh, wh, wd, ENCDEC_ARCH, b=rows, nq=frames, nkv=frames,
        causal=False, kv="projection", what=f"{prefill}: the encoder")
    tc["at_whisper_self_shape"] = at(
        wh, wh, wd, ENCDEC_ARCH, b=rows, nq=n, nkv=n,
        cache_len=n + ENCDEC_MAX_NEW,
        what=f"{prefill}: decoder self-attention")
    tc["at_whisper_cross_shape"] = at(
        wh, wh, wd, ENCDEC_ARCH, b=rows, nq=n, nkv=frames, causal=False,
        kv="projection", what=f"{prefill}: cross-attention")
    tc["at_qwen2vl_shape"] = at(28, 4, 128, VLM_ARCH)
    tc["at_qwen110b_shape"] = at(64, 8, 128, SHARDED_ARCH)

    scale = dh ** -0.5
    q3, k3, v3 = (torch.randn((h, s, dh), generator=gen, device=dev)
                  for _ in range(3))
    err = held(flash_attention(q3, k3, v3, scale=scale),
               flash_attention_plain(q3, k3, v3, scale=scale), "f32")
    nbytes = 4 * q3.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 3 * ops_n, TF32_OPS_PER_S)
    f32 = dict(
        shape=f"q, k, v {tuple(q3.shape)} f32, causal, scale {scale}",
        max_abs_err=err, tolerance=f"atol = rtol = {FLASH_TOL}",
        bound_ms_f32_units=bound_ms(nbytes, ops_n, F32_OPS_PER_S)[0],
        bytes_bound_ms=bound_ms(nbytes, 0, F32_OPS_PER_S)[0],
        ms=device_ms(torch, lambda: flash_attention(q3, k3, v3, scale=scale),
                     "flash_attention_kernel"),
        ms_events=time_ms(torch, lambda: flash_attention(q3, k3, v3,
                                                         scale=scale)),
        plain_ms=time_ms(torch, lambda: flash_attention_plain(
            q3, k3, v3, scale=scale)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(torch, lambda: sdpa(
            q3[None], k3[None], v3[None], is_causal=True, scale=scale)))
    f32["at_stablelm_shape"] = at(32, 8, 160, DENSE12B_ARCH, torch.float32)
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


@contextlib.contextmanager
def collector_passes():
    """Python's cyclic-collector passes during the block, each as
    (generation, ms) on the host clock (``gc.callbacks``): ROADMAP §3's
    open SLO miss of this phase was a host stall."""
    import gc
    passes, start = [], []

    def note(phase, info):
        if phase == "start":
            start[:] = [time.perf_counter()]
        elif start:
            passes.append((info["generation"],
                           (time.perf_counter() - start[0]) * 1e3))

    gc.callbacks.append(note)
    try:
        yield passes
    finally:
        gc.callbacks.remove(note)


def passes_summary(passes) -> dict:
    return {"count": len(passes),
            "full": sum(1 for g, _ in passes if g == 2),
            "max_ms": max((ms for _, ms in passes), default=0.0),
            "total_ms": sum(ms for _, ms in passes)}


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
        with cpu_branch_calls() as calls, collector_passes() as passes:
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
                raise CheckFailed(f"events CLI {flags}: smoke gate: {e}; "
                                  f"collector passes {passes_summary(passes)}")
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
              f"{what}: the smoke contract failed: " + json.dumps(
                  [{k: r.get(k) for k in (
                      "requests_rejected", "requests_dropped",
                      "slo_attainment", "latency_p50_s", "latency_p99_s",
                      "labels_sha")} for r in runs]))
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
            "cpu_branch_calls": sum(calls.values()),
            "collector_passes": passes_summary(passes)}
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


def lm_prompts(vocab: int, lengths=LM_PROMPTS) -> list:
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, n).tolist() for n in lengths]


def flash_per_prefill(cfg, n: int) -> int:
    """Kernel 7's launches in one prefill of ``n`` tokens: one a layer
    whose window cuts no key (no window, a global layer, or ``n`` within
    the window), none in an SSM layer."""
    if cfg.family == "ssm":
        return 0
    if cfg.sliding_window is None or n <= cfg.sliding_window:
        return cfg.n_layers
    return len(cfg.global_layers)


def lm_pass(torch, eng, prompts) -> dict:
    """The 8 LM requests (``prompts``, 32 new tokens each) served by
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


def check_lm_launches(eng, run: dict, lengths, what: str) -> dict:
    """The launch gate of one pass: kernel 7's tensor-core flash launches
    of each prefill (``flash_per_prefill``), on the wrappers' counters when
    eager and as captured launches x replays when graphed; a graphed pass
    launches nothing eagerly beyond each new graph's warm-up run and
    capture (twice its captured launches). Returns the pass's launches,
    eager plus replayed."""
    eager, replayed = run["launches_eager"], run["launches_replayed"]
    n = sum(flash_per_prefill(eng.cfg, m) for m in lengths)
    flash = {"flash_attention_tc": n} if n else {}
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


def describe(cfg) -> str:
    """One line of a config's widths, for the report."""
    parts = [f"{cfg.n_layers} layers", f"d_model {cfg.d_model}"]
    if cfg.family != "ssm":
        parts.append(f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, "
                     f"head_dim {cfg.head_dim}")
    if cfg.n_experts:
        parts.append(f"{cfg.n_experts} experts top-{cfg.top_k} of moe_d_ff "
                     f"{cfg.moe_d_ff}, capacity factor "
                     f"{cfg.moe_capacity_factor}")
    if cfg.d_ff:
        parts.append(f"d_ff {cfg.d_ff}"
                     + (" beside the experts" if cfg.dense_parallel else ""))
    for flag, what in ((cfg.qk_norm, "QK-norm"), (cfg.qkv_bias, "QKV bias"),
                       (cfg.rotary_frac < 1, f"rotary fraction "
                                             f"{cfg.rotary_frac}"),
                       (cfg.norm != "rmsnorm", cfg.norm)):
        if flag:
            parts.append(what)
    if cfg.family in ("ssm", "hybrid"):
        parts.append(f"SSM state {cfg.ssm_state}, "
                     f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} "
                     f"heads of {cfg.ssm_head_dim}")
    if cfg.sliding_window:
        parts.append(f"window {cfg.sliding_window}, global layers "
                     f"{'/'.join(map(str, cfg.global_layers))}")
    parts.append(f"vocab {cfg.vocab}")
    if cfg.tie_embeddings:
        parts.append("tied embeddings")
    params = {"float32": "f32", "bfloat16": "bf16"}[cfg.param_dtype]
    params += " params" + (" (router and norms f32)" if cfg.n_experts
                           and cfg.param_dtype != "float32" else "")
    return (f"{cfg.name} [{cfg.family}]: {', '.join(parts)}; seeded "
            f"init_model, {params}, bf16 compute and cache")


def init_timed(torch, cfg, dev) -> tuple:
    """``init_model`` of a generator on the card seeded with SEED: the
    params, its seconds and its peak allocated memory above what was
    allocated before, gated to the parameters' bytes plus 1 GiB."""
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import param_bytes

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_model(torch.Generator(device=dev).manual_seed(SEED), cfg,
                          device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    check(peak <= param_bytes(params) + 2 ** 30,
          f"{cfg.name} init_model peaked at {peak} B, over its "
          f"{param_bytes(params)} B of parameters plus 1 GiB")
    return params, init_s, peak


def lm_serve_phase(torch, dev, arch: str = LM_ARCH,
                   lengths=LM_PROMPTS, param_dtype: str | None = None
                   ) -> tuple:
    """An LM path at full width from a seeded ``init_model``, served by
    ``Engine(slots=4, cache_len=4096)`` in bf16 in three passes of the
    same 8 requests (``lengths`` tokens, 32 new tokens each) over the same
    weights: (a) an eager engine (``jit=False``), after one short warm-up
    request; (b) a graphed engine (``jit=True``), cold: its warm-up request
    captures decode, and the pass captures its 8 prompt lengths; (c) the
    same engine, warm: every prefill and decode a replay. Gates: each
    request's 32 tokens identical across the passes, and each pass's
    launches (``check_lm_launches``). Profiles the 2048-token prefill and
    a four-slot decode step eager (on (a)'s engine, freed after) and
    graphed. The weights are ``init_model`` of a generator on the card
    seeded with SEED (the engines' own default), drawn first: its time
    (``init_s``) and peak allocated memory above what was allocated
    before (``init_peak_mib``, gated to the parameters' bytes plus 1 GiB:
    each layer is drawn into the stacked leaves). ``param_dtype`` replaces
    the config's (qwen3-moe's bf16 weights). Returns the report and the
    graphed engine."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine, Request
    from repro_torch.nn.module import param_bytes, param_count

    cfg = get_config(arch)
    if param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    prompts = lm_prompts(cfg.vocab, lengths)
    profiled = prompts[lengths.index(PROFILE_LEN)]
    params, init_s, init_peak = init_timed(torch, cfg, dev)

    def engine(jit):
        t0 = time.perf_counter()
        eng = Engine(cfg, slots=LM_SLOTS, cache_len=LM_CACHE_LEN,
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
            f"profile_prefill_{PROFILE_LEN}{suffix}": profile_fn(
                torch, lambda: eng.prefill(profiled), steps=2),
            f"profile_decode{suffix}": profile_fn(
                torch, lambda: eng.decode(tokens, positions), steps=4)}

    eng, eager_warm_s = engine(jit=False)
    runs, launches, report = {}, {}, {}
    runs["eager"] = lm_pass(torch, eng, prompts)
    launches["eager"] = check_lm_launches(eng, runs["eager"], lengths,
                                          "eager pass")
    report.update(profiles(eng, "_eager"))
    del eng
    torch.cuda.empty_cache()

    eng, warm_s = engine(jit=True)
    check(sorted(eng.graphs) == [("decode", LM_SLOTS), ("prefill", 16)],
          f"the warm-up request captured {sorted(eng.graphs)}")
    for name in ("cold", "warm"):
        runs[name] = lm_pass(torch, eng, prompts)
        launches[name] = check_lm_launches(eng, runs[name], lengths,
                                           f"{name} pass")
    check(runs["cold"]["captured"] == sorted(("prefill", n)
                                             for n in lengths)
          and runs["warm"]["captured"] == [],
          f"captured {runs['cold']['captured']} cold, "
          f"{runs['warm']['captured']} warm")
    for rid, want in runs["eager"]["tokens"].items():
        check(runs["cold"]["tokens"][rid] == want
              and runs["warm"]["tokens"][rid] == want,
              f"{arch} request {rid}: graphed tokens differ from the eager "
              "engine's")
    report.update(profiles(eng, ""))
    total = {k: sum(run[k] for run in launches.values())
             for k in launches["eager"]}
    return dict(
        config=describe(cfg),
        params=param_count(params), param_mib=param_bytes(params) / 2 ** 20,
        init_s=init_s, init_peak_mib=init_peak / 2 ** 20,
        eager_warmup_s=eager_warm_s, prompts=list(lengths),
        max_new=LM_MAX_NEW,
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


@contextlib.contextmanager
def operand_addresses(ops, build):
    """Records the (q, k, v) addresses each ``ops.flash_attention`` call
    receives (``called``) and those each flash kernel launch is handed
    (``launched``): equal lists mean no operand was copied on the way."""
    seen = {"called": [], "launched": []}
    entry, kernel_function = ops.flash_attention, build.kernel_function

    def call(q, k, v, **kw):
        seen["called"].append((q.data_ptr(), k.data_ptr(), v.data_ptr()))
        return entry(q, k, v, **kw)

    def bind(name, symbol, argtypes):
        fn = kernel_function(name, symbol, argtypes)
        if not name.startswith("flash_attention"):
            return fn

        def launch(*args):
            seen["launched"].append(tuple(args[:3]))
            return fn(*args)
        return launch

    ops.flash_attention, build.kernel_function = call, bind
    try:
        yield seen
    finally:
        ops.flash_attention, build.kernel_function = entry, kernel_function


def bf16_dropped(torch, cfg, params, tokens, n: int) -> list:
    """The (token, expert) choices each MoE layer drops past capacity in
    one eager bf16 prefill of ``tokens`` (n of them), as the engine serves
    it."""
    from repro_torch.nn import moe
    from repro_torch.nn import transformer as T

    cache = T.init_cache(cfg, 1, n, dtype=torch.bfloat16,
                         device=tokens.device)
    with recorded_routing(moe) as routes:
        T.model_apply(params, {"tokens": tokens, "cache_pos": 0}, cfg,
                      mode="prefill", cache=cache,
                      compute_dtype=torch.bfloat16)
    return [int(r.dropped()) for r in routes]


@contextlib.contextmanager
def recorded_routing(moe):
    """Every ``moe.route`` call's ``Routing`` in call order (one an MoE
    layer), kept while the block runs."""
    seen, route = [], moe.route
    moe.route = lambda *a: seen.append(route(*a)) or seen[-1]
    try:
        yield seen
    finally:
        moe.route = route


def routing_report(torch, flash_routes, plain_routes) -> dict:
    """An MoE prefill's routing on the flash and plain routes: the (token,
    expert) choices each layer dropped past capacity, and the tokens of
    each layer whose chosen experts differ between the routes."""
    def expert_sets(r):
        return torch.sort(r.idx, dim=-1).values
    dropped = [int(r.dropped()) for r in flash_routes]
    flips = [int((expert_sets(a) != expert_sets(b)).any(-1).sum())
             for a, b in zip(flash_routes, plain_routes)]
    r = flash_routes[0]
    return dict(choices_per_layer=r.idx.numel(),
                slots_per_layer=r.valid.numel(),
                dropped_by_layer=dropped, dropped_total=sum(dropped),
                dropped_plain_total=sum(int(p.dropped())
                                        for p in plain_routes),
                routing_flips_by_layer=flips, routing_flips=sum(flips))


def f32_prefill_routes(torch, cfg, params, batch, length: int, dev,
                       keep_cache: bool = False) -> dict:
    """One f32 prefill of ``batch`` (at cache_pos 0) into a fresh cache of
    ``length`` on the flash route and then on the plain route (the
    reference's chunked softmax), on the card. The counters are set to 0
    just before the flash route and read just after it. Returns the
    last-position ``logits`` by route (True: flash), the flash route's
    ``launches``, whether its kernel was handed each layer's q, k, v views
    at their own addresses (``in_place``), every ``moe.route`` call's
    ``Routing`` by route (``routes``), and with ``keep_cache`` the flash
    route's ``cache``."""
    from repro_torch.kernels import _build, ops
    from repro_torch.nn import moe
    from repro_torch.nn import transformer as T

    rows = batch["tokens"].shape[0]
    out = {"logits": {}, "routes": {}}
    for flash in (True, False):
        cache = T.init_cache(cfg, rows, length, dtype=torch.float32,
                             device=dev)
        ops.reset_launch_counts()
        with operand_addresses(ops, _build) as addresses, \
                recorded_routing(moe) as out["routes"][flash]:
            out["logits"][flash], _, _ = T.model_apply(
                params, dict(batch, cache_pos=0), cfg, mode="prefill",
                cache=cache, compute_dtype=torch.float32, flash=flash)
            torch.cuda.synchronize()
        if flash:
            out["launches"] = ops.launch_counts()
            out["in_place"] = bool(addresses["called"]) and (
                addresses["called"] == addresses["launched"])
            if keep_cache:
                out["cache"] = cache
        del cache
    return out


def check_f32_gate(torch, cfg, run: dict, f32_launches: int, what: str,
                   detail=None) -> float:
    """The f32 gate of one ``f32_prefill_routes`` run: the flash route
    launched the f32 flash kernel ``f32_launches`` times and nothing else,
    each handed its views in place, and its logits are finite and within
    atol = rtol = LM_LOGITS_TOL of the plain route's (``detail()`` adds
    to that failure's message). Returns the largest difference."""
    launches = run["launches"]
    expect = {**dict.fromkeys(launches, 0),
              "flash_attention_f32": f32_launches}
    check(launches == expect,
          f"{cfg.name} f32 gate {what}: launch counts {launches} != "
          f"{expect}")
    check(run["in_place"], f"{cfg.name} f32 gate {what}: the f32 flash "
          "kernel was not handed the layers' q, k, v views at their own "
          "addresses (a copy came first)")
    got, want = run["logits"][True], run["logits"][False]
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(got.shape[1:] == (1, cfg.padded_vocab) == want.shape[1:]
          and bool(torch.isfinite(got).all())
          and bool(((got - want).abs() <= LM_LOGITS_TOL
                    + LM_LOGITS_TOL * want.abs()).all()),
          f"{cfg.name} f32 prefill logits {what}, flash route against "
          f"plain: off by {err}" + (f"; {detail()}" if detail else ""))
    return err


def lm_gate_phase(torch, dev, eng, lengths=(LM_GATE_LEN,),
                  prompt_lengths=LM_PROMPTS, greedy: bool = True) -> dict:
    """For each of ``lengths``, one f32 prefill of that prompt (of the
    served ones) through the flash route and through the plain route (the
    reference's chunked softmax) on the card, with the served model's
    weights, into a cache as long as the prompt: last-position logits
    within atol = rtol = LM_LOGITS_TOL. The counters are set to 0 just
    before each flash-route prefill and read just after it: one f32 flash
    launch a layer whose window cuts no key (``flash_per_prefill``), each
    handed the layer's q, k, v views at their own addresses. With
    ``greedy``, then 8 greedy tokens of both routes in f32 and in bf16 for
    the first length, printed; the bf16 tokens are not gated. An MoE
    config also reports each prefill's routing (``routing_report``) and
    the choices one bf16 prefill, as served, dropped past capacity."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Engine, Request

    cfg, params = eng.cfg, eng.params
    prompts = lm_prompts(cfg.vocab, prompt_lengths)
    by_length, total = {}, {}
    for n in lengths:
        tokens = torch.tensor([prompts[prompt_lengths.index(n)]], device=dev)
        run = f32_prefill_routes(torch, cfg, params, {"tokens": tokens}, n,
                                 dev)
        routes = run["routes"]
        routing = (routing_report(torch, routes[True], routes[False])
                   if cfg.n_experts else None)
        err = check_f32_gate(
            torch, cfg, run, flash_per_prefill(cfg, n), f"at {n}",
            (lambda: f"routing {routing}") if routing else None)
        launches = run["launches"]
        by_length[n] = dict(launches=launches, max_abs_err=err,
                            operands_in_place=run["in_place"],
                            logits_absmax=float(
                                run["logits"][False].abs().max()))
        if routing:
            by_length[n]["routing"] = routing
            by_length[n]["bf16_dropped_by_layer"] = bf16_dropped(
                torch, cfg, params, tokens, n)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del run, routes
        torch.cuda.empty_cache()
    out = dict(prompt_lens=list(lengths), launches=total,
               max_abs_err=max(r["max_abs_err"] for r in by_length.values()),
               operands_in_place=all(r["operands_in_place"]
                                     for r in by_length.values()),
               tolerance=f"atol = rtol = {LM_LOGITS_TOL}",
               by_length=by_length)
    if greedy:
        prompt = prompts[prompt_lengths.index(lengths[0])]
        tokens = {}
        for dt in (torch.float32, torch.bfloat16):
            for flash in (True, False):
                e = Engine(cfg, slots=1, cache_len=lengths[0] + 8,
                           params=params, compute_dtype=dt, cache_dtype=dt,
                           device=dev, flash=flash, jit=False)
                e.submit(Request(rid=0, prompt=prompt, max_new=8))
                tokens[f"{str(dt).removeprefix('torch.')}/"
                       f"{'flash' if flash else 'plain'}"] = e.run()[0].out
        out["greedy"] = tokens
        out["greedy_agree"] = {
            dt: tokens[f"{dt}/flash"] == tokens[f"{dt}/plain"]
            for dt in ("float32", "bfloat16")}
    ops.reset_launch_counts()
    return out


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


def train_lm_100m_example(torch) -> dict:
    """``examples/torch_train_lm_100m.py`` for 4 steps (its ``lm-100m``:
    16 layers, d_model 768, its own batch 8 of 256 tokens, microbatches
    of 4), checkpointing into a directory under ``build/``: it completes
    with finite losses and launches no kernel (training runs the plain
    attention)."""
    import io
    import math
    import tempfile
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    (ROOT / "build").mkdir(exist_ok=True)
    out = io.StringIO()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ck, \
            contextlib.redirect_stdout(out):
        log = load_example("torch_train_lm_100m").main(
            ["--steps", "4", "--ckpt-dir", ck])
    got = {"log": log, "wall_s": time.perf_counter() - t0,
           "result": json.loads(out.getvalue().splitlines()[-1])["result"],
           "launches": {k: v for k, v in ops.launch_counts().items() if v}}
    check(got["result"] == {"restarts": 0, "completed": True}
          and log and all(math.isfinite(r["loss"]) for r in log)
          and not got["launches"], f"train_lm_100m: {got}")
    return got


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
    out["train_lm_100m"] = train_lm_100m_example(torch)
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


LM_TRAIN_ARCH = "smollm-360m"
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 2048       # smollm's context
LM_TRAIN_STEPS = 6
LM_TRAIN_CKPT_EVERY = 3
LM_TRAIN_FAIL_AT = 4
LM_TRAIN_KEEP = 3                            # the Checkpointer's default
LM_TRAIN_ARGS = ("--arch", LM_TRAIN_ARCH, "--steps", str(LM_TRAIN_STEPS),
                 "--global-batch", str(LM_TRAIN_BATCH),
                 "--seq", str(LM_TRAIN_SEQ), "--microbatch", "4",
                 "--lr", "3e-4", "--warmup", "2",
                 "--ckpt-every", str(LM_TRAIN_CKPT_EVERY),
                 "--log-every", "1", "--seed", str(SEED))
LM_TRAIN_RESTORE_RTOL = 1e-4   # losses after the restore vs uninterrupted
# the reduced step of each ported family, card against CPU (arch,
# reduced() overrides); the bars are TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL and
# TRAIN_PARAM_TOL
LM_TRAIN_FAMILIES = (("smollm-360m", {}), ("qwen3-moe-30b-a3b", {}),
                     ("mamba2-130m", {}), ("hymba-1.5b", {"n_layers": 3}),
                     ("whisper-large-v3", {}), ("qwen2-vl-7b", {}))
FLASH_KERNELS = ("flash_attention_tc", "flash_attention_f32")

# the sharded phase: the sharded entry points on a (1, 1) mesh over NCCL
SHARDED_ARCH = "qwen1.5-110b"
SHARDED_LAYERS = 16          # of its 80: 2.72 GB a layer in bf16
SHARDED_ROWS, SHARDED_LEN = 4, 2048
SHARDED_MAX_NEW = 32
SHARDED_TRAIN_STEPS = 2
# the sharded engine: more requests than slots, prompts of other lengths
SHARDED_ENGINE_PROMPTS = (2048, 77, 1000, 300, 1536, 512)
SHARDED_ENGINE_SLOTS = 4
DRYRUN_DEMO = ("qwen3-moe-30b-a3b", "train_4k")   # 2x16x16, the demo's cell
DRYRUN_DEMO_TIMEOUT_S = 240    # a subprocess: ~54 s of trace, ~67 in all


def lm_grads(torch, params, batch, cfg):
    """(loss, {path: gradient}) of ``lm_loss`` (the plain attention) by
    autograd, every leaf's gradient (zeros where unused)."""
    from repro_torch.nn import module
    from repro_torch.nn import transformer as T
    leaves = {p: t.detach().requires_grad_()
              for p, t in module.tree_paths(params)}
    loss, _ = T.lm_loss(module.map_with_path(lambda p, _: leaves[p], params),
                        batch, cfg, flash=False)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return float(loss.detach()), {
        p: torch.zeros_like(t) if g is None else g
        for (p, t), g in zip(leaves.items(), grads)}


def stub_inputs(torch, cfg, b: int, s: int) -> dict:
    """A family's seeded modality inputs on the CPU: bf16 frames (B,
    n_frames, D) for an encoder-decoder; bf16 image embeddings (B,
    img_tokens, D) and distinct M-RoPE streams (3, B, S) for a VLM (so
    that the microbatch split of the positions is seen); else none."""
    g = torch.Generator().manual_seed(SEED + 11)
    if cfg.family == "encdec":
        return {"frames": torch.randn((b, cfg.n_frames, cfg.d_model),
                                      generator=g).to(torch.bfloat16)}
    if cfg.family == "vlm":
        return {"image_embeds": torch.randn(
                    (b, cfg.img_tokens, cfg.d_model),
                    generator=g).to(torch.bfloat16),
                "mrope_positions": torch.randint(0, 2 * s, (3, b, s),
                                                 generator=g)}
    return {}


def train_lm_reduced_against_cpu(torch, dev) -> dict:
    """Each ported family's reduced config in f32 compute, from one seeded
    CPU ``init_model`` and one ``synthetic_lm_batch``, on the card against
    the CPU: ``lm_loss`` and every gradient leaf, then one
    ``make_train_step`` (two microbatches of 2, AdamW): loss within
    TRAIN_LOSS_RTOL, each gradient leaf within TRAIN_GRAD_TOL of its
    largest |g|, the updated params within TRAIN_PARAM_TOL (rtol and
    atol), and the step's loss as the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batch
    from repro_torch.infer.compile import to_device
    from repro_torch.launch import steps
    from repro_torch.nn import module
    from repro_torch.nn import transformer as T
    from repro_torch.optim import adamw
    out = {}
    for arch, kw in LM_TRAIN_FAMILIES:
        cfg = dataclasses.replace(get_config(arch).reduced(**kw),
                                  compute_dtype="float32")
        params = T.init_model(torch.Generator().manual_seed(SEED), cfg,
                              device="cpu")
        raw = synthetic_lm_batch(DataConfig(seq=64, global_batch=4,
                                            vocab=cfg.padded_vocab,
                                            seed=SEED), 0)
        raw = {k: torch.from_numpy(v) for k, v in raw.items()}
        raw.update(stub_inputs(torch, cfg, 4, 64))
        ts = steps.TrainSettings(microbatch=2, opt=adamw.OptConfig(
            peak_lr=3e-4, warmup_steps=1, decay_steps=4))
        runs = {}
        for where in ("cpu", "cuda"):
            d = torch.device(where)
            p = to_device(params, d)
            batch = {k: v.to(d) for k, v in raw.items()}
            loss, grads = lm_grads(torch, p, batch, cfg)
            new, _, m = steps.make_train_step(cfg, ts)(
                p, adamw.init(p, steps.opt_config(cfg, ts)), batch)
            runs[where] = (loss, float(m["loss"]),
                           {k: g.cpu() for k, g in grads.items()},
                           {k: v.cpu() for k, v in module.tree_paths(new)})
        (l0, s0, g0, p0), (l1, s1, g1, p1) = runs["cpu"], runs["cuda"]
        worst = 0.0
        for k, want in g0.items():
            scale = float(want.abs().max())
            err = float((g1[k] - want).abs().max())
            worst = max(worst, err / scale if scale > 0 else err)
        misses = {k: int(((p1[k] - w).abs() > TRAIN_PARAM_TOL
                          + TRAIN_PARAM_TOL * w.abs()).sum())
                  for k, w in p0.items()}
        row = {"loss_cpu": l0, "loss_card": l1,
               "loss_rel_err": abs(l1 - l0) / abs(l0),
               "step_loss_rel_err": abs(s1 - s0) / abs(s0),
               "grad_err_of_leaf_max": worst, "leaves": len(g0),
               "updated_param_misses": {k: v for k, v in misses.items()
                                        if v}}
        out[arch] = row
        check(row["loss_rel_err"] <= TRAIN_LOSS_RTOL
              and row["step_loss_rel_err"] <= TRAIN_LOSS_RTOL,
              f"{arch}: reduced LM loss, card vs CPU: {row}")
        check(worst <= TRAIN_GRAD_TOL,
              f"{arch}: reduced LM gradients, card vs CPU: {row}")
        check(not row["updated_param_misses"],
              f"{arch}: reduced LM updated params, card vs CPU: {row}")
    return out


@contextlib.contextmanager
def recorded_training(torch, rec: dict):
    """While the block runs, ``launch.train`` builds its checkpointer, its
    train step and its AdamW update through recording wrappers (the real
    ones put back after):
      - each step's device-synced ms and its exact loss, gradient norm
        and learning rate (``rec["steps"]``);
      - the gradient norms of ``wq``, ``wk``, ``wv`` in the first and the
        last layer at every step (``rec["attn_grad_norms"]``);
      - at the first update, each (leaf, layer) whose update equals the
        update of zero gradients from the same state, i.e. what weight
        decay alone does (``rec["not_past_decay"]``);
      - each save's seconds (the call: the host copy, and the write too
        with ``block``) and each wait on a write in flight; at
        ``rec["snapshot_at"]`` a device copy of
        the saved tree, held against what ``restore`` returns
        (``rec["restores"]``: ``equal_to_saved``) and the restore's
        seconds."""
    from repro_torch.launch import steps, train
    from repro_torch.nn import module
    from repro_torch.optim import adamw
    real_make, real_update, real_ckpt = (steps.make_train_step,
                                         adamw.update, train.Checkpointer)
    rec.update(steps=[], attn_grad_norms=[], saves=[], waits=[],
               restores=[])

    class RecordingCheckpointer(real_ckpt):
        def save(self, step, tree, **kw):
            if step == rec.get("snapshot_at") and "snapshot" not in rec:
                rec["snapshot"] = {p: t.detach().clone()
                                   for p, t in module.tree_paths(tree)}
            t0 = time.perf_counter()
            super().save(step, tree, **kw)
            rec["saves"].append({"step": step,
                                 "block": bool(kw.get("block")),
                                 "s": time.perf_counter() - t0})

        def wait(self):
            # the seconds the caller blocks on a write still in flight
            busy = self._thread is not None
            t0 = time.perf_counter()
            super().wait()
            if busy:
                rec["waits"].append(time.perf_counter() - t0)

        def restore(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree, extra = super().restore(*a, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = dict(module.tree_paths(tree))
            snap = rec.pop("snapshot", {})
            rec["restores"].append({
                "step": extra["step"], "s": dt, "leaves": len(got),
                "equal_to_saved": sorted(snap) == sorted(got) and all(
                    t.dtype == got[p].dtype and torch.equal(t, got[p])
                    for p, t in snap.items())})
            return tree, extra

    def make_train_step(cfg, ts):
        step = real_make(cfg, ts)

        def timed(params, opt_state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, opt_state, batch)
            torch.cuda.synchronize()
            m = out[2]
            rec["steps"].append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "lr": float(m["lr"])})
            return out
        return timed

    def update(grads, state, params, cfg):
        a = grads["layers"]["attn"]
        last = a["wq"]["kernel"].shape[0] - 1
        rec["attn_grad_norms"].append({
            f"{w}_layer{i}": float(a[w]["kernel"][i].norm())
            for w in ("wq", "wk", "wv") for i in (0, last)})
        new = real_update(grads, state, params, cfg)
        if "not_past_decay" not in rec:
            decayed = dict(module.tree_paths(real_update(
                zeros_like_tree(torch, grads), state, params, cfg)[0]))
            stacked = [p for p in decayed if p.startswith("layers/")]
            rec["not_past_decay"] = [
                (p, i) for p, t in module.tree_paths(new[0])
                for i in (range(t.shape[0]) if p in stacked else [None])
                if torch.equal(t if i is None else t[i],
                               decayed[p] if i is None else decayed[p][i])]
            rec["leaves_checked"] = len(decayed)
            del decayed
        return new

    train.Checkpointer = RecordingCheckpointer
    steps.make_train_step = make_train_step
    adamw.update = update
    try:
        yield rec
    finally:
        train.Checkpointer = real_ckpt
        steps.make_train_step = real_make
        adamw.update = real_update


def lm_train_phase(torch, dev) -> dict:
    """The port's LM training at full width and depth: ``python -m
    repro_torch.launch.train`` (``train.main``) on smollm-360m (32 layers,
    d_model 960, 15 heads over 5 KV heads, d_ff 2560, vocab 49152, tied
    embeddings, f32 params, bf16 compute, remat), global batch 8 of 2048
    tokens in two microbatches of 4, 6 AdamW steps (lr 3e-4, warmup 2), a
    checkpoint every 3 steps into a directory under ``build/``; run
    uninterrupted, then again with a failure injected at step 4, which the
    supervisor recovers from step 3's checkpoint. Counters set to 0
    before the two runs and read after them. Gates: every loss and
    gradient norm finite; the last loss below the first; ``wq``, ``wk``,
    ``wv`` gradients nonzero in layers 0 and 31 at every step; the first
    update moved every (leaf, layer) past where weight decay alone takes
    it; no launch of kernel 7 (training runs the plain chunked softmax);
    the failed run restarted once and completed, restored exactly the
    tree it saved, and its losses after the restore are the uninterrupted
    run's within LM_TRAIN_RESTORE_RTOL; no ``.tmp`` directory left and at
    most LM_TRAIN_KEEP commits. Then each family's reduced step on the
    card against the CPU."""
    import io
    import math
    import shutil
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    root = ROOT / "build" / "lm_train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    runs = {}
    ops.reset_launch_counts()
    try:
        for name, extra in (("uninterrupted", []), ("failed", [
                "--inject-failure-at", str(LM_TRAIN_FAIL_AT)])):
            rec = {"snapshot_at": LM_TRAIN_CKPT_EVERY if extra else None}
            out = io.StringIO()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with recorded_training(torch, rec), \
                    contextlib.redirect_stdout(out):
                train.main(list(LM_TRAIN_ARGS)
                           + ["--ckpt-dir", str(root / name)] + extra)
            lines = out.getvalue().splitlines()
            ms = [s["ms"] for s in rec["steps"][1:]]
            runs[name] = {
                "wall_s": time.perf_counter() - t0,
                "result": json.loads(lines[-1])["result"],
                "restore_lines": [x for x in lines
                                  if x.startswith("[restore]")],
                "steps": rec["steps"],
                "ms_per_step": sum(ms) / len(ms),
                "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ
                * len(ms) / (sum(ms) / 1e3),
                "peak_mem_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
                "attn_grad_norms": rec["attn_grad_norms"],
                "saves": rec["saves"], "waits_s": rec["waits"],
                "restores": rec["restores"],
                "ckpt_dirs": sorted(p.name for p in (root / name).iterdir())}
            if name == "uninterrupted":
                runs[name]["not_past_decay"] = rec["not_past_decay"]
                runs[name]["leaves_checked_past_decay"] = rec["leaves_checked"]
            del rec
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    clean, failed = runs["uninterrupted"], runs["failed"]
    # the failed run's steps 0-3, then 3-5 again from step 3's checkpoint
    after = failed["steps"][LM_TRAIN_FAIL_AT:]
    want = clean["steps"][LM_TRAIN_CKPT_EVERY:]
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
           for a, b in zip(after, want)]
    out = {"config": f"{LM_TRAIN_ARCH} at full width and depth, f32 params, "
                     "bf16 compute, remat; train.main "
                     + " ".join(LM_TRAIN_ARGS),
           "runs": runs, "launches": launches,
           "losses_after_restore_rel_err": rel,
           "losses_after_restore_bit_for_bit": all(
               a["loss"] == b["loss"] for a, b in zip(after, want))}
    for name, r in runs.items():
        check(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                  for s in r["steps"]),
              f"{name}: a loss or gradient norm is not finite: {r['steps']}")
        check(all(v > 0 for n in r["attn_grad_norms"] for v in n.values()),
              f"{name}: a zero attention gradient: {r['attn_grad_norms']}")
        check(not any(d.endswith(".tmp") for d in r["ckpt_dirs"])
              and len(r["ckpt_dirs"]) <= LM_TRAIN_KEEP,
              f"{name}: checkpoint directories left: {r['ckpt_dirs']}")
    check(len(clean["steps"]) == LM_TRAIN_STEPS
          and clean["result"] == {"restarts": 0, "completed": True},
          f"uninterrupted run: {clean['result']}, {len(clean['steps'])} "
          "steps")
    check(clean["steps"][-1]["loss"] < clean["steps"][0]["loss"],
          f"the loss did not fall: {clean['steps']}")
    check(not clean["not_past_decay"],
          "the first update moved these (leaf, layer) only as weight decay "
          f"does: {clean['not_past_decay']}")
    check(all(launches.get(k, 0) == 0 for k in FLASH_KERNELS),
          f"training launched the flash kernel: {launches}")
    check(failed["result"] == {"restarts": 1, "completed": True}
          and len(failed["restore_lines"]) == 1
          and [r["step"] for r in failed["restores"]] == [LM_TRAIN_CKPT_EVERY]
          and failed["restores"][0]["equal_to_saved"],
          f"failed run: {failed['result']}, {failed['restore_lines']}, "
          f"{failed['restores']}")
    check(len(after) == len(want) == LM_TRAIN_STEPS - LM_TRAIN_CKPT_EVERY
          and max(rel) <= LM_TRAIN_RESTORE_RTOL,
          f"losses after the restore: {after} against {want}")
    out["profile_step"] = profile_train_step(torch, dev)
    out["reduced_vs_cpu"] = train_lm_reduced_against_cpu(torch, dev)
    return out


def profile_train_step(torch, dev) -> dict:
    """Where a full-width train step's time goes: the phase's step
    (smollm-360m, batch 8 x 2048 in microbatches of 4, remat, AdamW) from
    a seeded ``init_model`` on one synthetic batch, under ``profile_fn``
    (device ms by kernel, idle share, peak memory)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batch
    from repro_torch.launch import steps
    from repro_torch.nn import transformer as T
    from repro_torch.optim import adamw
    cfg = get_config(LM_TRAIN_ARCH)
    ts = steps.TrainSettings(microbatch=4, opt=adamw.OptConfig(
        peak_lr=3e-4, warmup_steps=2, decay_steps=LM_TRAIN_STEPS))
    params = T.init_model(torch.Generator(device=dev).manual_seed(SEED), cfg,
                          device=dev)
    opt = adamw.init(params, steps.opt_config(cfg, ts))
    raw = synthetic_lm_batch(DataConfig(seq=LM_TRAIN_SEQ,
                                        global_batch=LM_TRAIN_BATCH,
                                        vocab=cfg.padded_vocab, seed=SEED), 0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    step = steps.make_train_step(cfg, ts)
    prof = profile_fn(torch, lambda: step(params, opt, batch), 1)
    del params, opt, batch
    torch.cuda.empty_cache()
    return prof


# ---------------------------------------------------------------------------
# the encoder-decoder and VLM families at full width and depth
# ---------------------------------------------------------------------------

def encdec_inputs(torch, cfg, n: int, dev) -> tuple:
    """ENCDEC_ROWS rows, each its own seeded prompt of ``n`` tokens and
    1500 frame embeddings (the audio frontend is a stub in the reference
    too): tokens (B, n) int64, frames (B, 1500, D) bf16."""
    toks, frames = [], []
    for row in range(ENCDEC_ROWS):
        g = torch.Generator(device=dev).manual_seed(SEED + 1000 * n + row)
        toks.append(torch.randint(0, cfg.vocab, (1, n), generator=g,
                                  device=dev))
        frames.append(torch.randn((1, cfg.n_frames, cfg.d_model),
                                  generator=g, device=dev).to(torch.bfloat16))
    return torch.cat(toks), torch.cat(frames)


def greedy_decode(torch, cfg, params, cache, tok, batch_at,
                  steps_n: int) -> tuple:
    """``steps_n`` greedy decode steps of ``steps.make_serve_step`` from
    ``tok`` (B,), step i's batch ``batch_at(i, tok)``: (tokens (B,
    steps_n) on the host, host ms a step, each synced by its tokens'
    read)."""
    from repro_torch.launch import steps
    serve_step = steps.make_serve_step(cfg)
    out, ms = [], []
    for i in range(steps_n):
        t0 = time.perf_counter()
        tok, cache = serve_step(params, cache, batch_at(i, tok))
        out.append(tok.tolist())
        ms.append((time.perf_counter() - t0) * 1e3)
    return torch.tensor(out).T, ms


def lm_encdec_phase(torch, dev) -> tuple:
    """whisper-large-v3 at full width and depth (32 encoder and 32 decoder
    layers, d_model 1280, 20 heads, Dh 64, 1500 frames) from a seeded
    ``init_model`` (f32 params, bf16 compute and cache), driven as the
    reference's own tests compose it (``tests/test_archs.py``: prefill
    through ``model_apply``, then ``make_serve_step``; the reference's
    Engine takes no frames): one pass a prompt length in ENCDEC_PROMPTS,
    ENCDEC_ROWS rows of it (``model_apply`` has no padding mask), each
    row its own seeded frames and prompt, prefilled into
    ``init_cache(cfg, B, S + 32)`` and then 32 greedy decode steps. The
    counters are set to 0 just before each prefill and read just after,
    then again around the decode steps: a prefill launches the bf16 flash
    kernel 96 times (the encoder's non-causal self-attention over the 1500
    frames, then each decoder layer's causal self-attention and its
    non-causal cross-attention over the frames' keys), a decode step never
    (its cross-attention reads the cached keys by the grouped softmax).
    Profiles a 440-token prefill and a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import param_bytes, param_count

    cfg = get_config(ENCDEC_ARCH)
    check(cfg.n_frames == ENCDEC_FRAMES and cfg.head_dim == ENCDEC_HEAD_DIM
          and cfg.n_heads == ENCDEC_HEADS, f"{cfg.name}: {describe(cfg)}")
    params, init_s, init_peak = init_timed(torch, cfg, dev)
    per_prefill = {"flash_attention_tc": cfg.encoder_layers
                   + 2 * cfg.n_layers}
    passes, launches = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for n in ENCDEC_PROMPTS:
        tokens, frames = encdec_inputs(torch, cfg, n, dev)
        cache = T.init_cache(cfg, ENCDEC_ROWS, n + ENCDEC_MAX_NEW,
                             device=dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _, _ = T.model_apply(
            params, {"tokens": tokens, "frames": frames, "cache_pos": 0},
            cfg, mode="prefill", cache=cache)
        first = logits[:, -1].argmax(-1)
        first_list = first.tolist()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        pre = ops.launch_counts()
        check(bool(torch.isfinite(logits).all())
              and logits.shape == (ENCDEC_ROWS, 1, cfg.padded_vocab),
              f"{cfg.name} prefill at {n}: logits {tuple(logits.shape)} "
              "or non-finite")
        check(pre == {**dict.fromkeys(pre, 0), **per_prefill},
              f"{cfg.name} prefill at {n}: launches {pre}, want "
              f"{per_prefill}")
        ops.reset_launch_counts()
        toks, step_ms = greedy_decode(
            torch, cfg, params, cache, first,
            lambda i, t: {"tokens": t[:, None].long(), "cache_pos": n + i},
            ENCDEC_MAX_NEW)
        dec = ops.launch_counts()
        check(not any(dec.values()),
              f"{cfg.name} decode at {n}: launched {dec}")
        toks = torch.cat([torch.tensor(first_list)[:, None], toks], dim=1)
        check(bool(((toks >= 0) & (toks < cfg.padded_vocab)).all()),
              f"{cfg.name} at {n}: a token outside the vocabulary")
        total_ms = prefill_ms + sum(step_ms)
        passes[n] = dict(
            prefill_ms=prefill_ms,
            decode_step_p50_ms=sorted(step_ms)[len(step_ms) // 2],
            tok_per_s=toks.numel() / total_ms * 1e3,
            tokens_first_row=toks[0].tolist())
        for k, v in pre.items():
            launches[k] = launches.get(k, 0) + v
        del cache, logits
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    n = ENCDEC_PROFILE_LEN
    tokens, frames = encdec_inputs(torch, cfg, n, dev)
    cache = T.init_cache(cfg, ENCDEC_ROWS, n + ENCDEC_MAX_NEW, device=dev)
    batch = {"tokens": tokens, "frames": frames, "cache_pos": 0}
    prof_prefill = profile_fn(torch, lambda: T.model_apply(
        params, batch, cfg, mode="prefill", cache=cache), steps=2)
    step = {"tokens": tokens[:, :1], "cache_pos": n}
    prof_decode = profile_fn(torch, lambda: T.model_apply(
        params, step, cfg, mode="decode", cache=cache), steps=4)
    del cache
    torch.cuda.empty_cache()
    report = dict(
        config=describe(cfg) + f", {cfg.encoder_layers} encoder layers over "
        f"{cfg.n_frames} seeded frame embeddings (frontend stubbed)",
        params=param_count(params), param_mib=param_bytes(params) / 2 ** 20,
        init_s=init_s, init_peak_mib=init_peak / 2 ** 20,
        init_peak_over_params_mib=(init_peak - param_bytes(params)) / 2 ** 20,
        rows=ENCDEC_ROWS, prompts=list(ENCDEC_PROMPTS),
        max_new=ENCDEC_MAX_NEW, passes=passes, peak_mem_mib=peak_mib,
        launches=launches, flash_tc_per_prefill=per_prefill,
        **{f"profile_prefill_{n}": prof_prefill,
           "profile_decode": prof_decode})
    return report, cfg, params


def lm_encdec_gate_phase(torch, dev, cfg, params) -> dict:
    """whisper-large-v3's f32 gates on the served weights, ENCDEC_ROWS rows
    of ENCDEC_PROFILE_LEN tokens: (1) the prefill's last-position logits on
    the flash route (the f32 kernel, 96 launches, counted from 0, handed
    each layer's q, k, v views at their own addresses) against the plain
    route, within atol = rtol = LM_LOGITS_TOL; (2) the logits of that
    prefill and three decode steps against the train-mode forward over the
    same tokens, within the reference's own ENCDEC_DECODE_TOL."""
    from repro_torch.kernels import ops
    from repro_torch.nn import transformer as T

    n, f32 = ENCDEC_PROFILE_LEN, torch.float32
    tokens, frames = encdec_inputs(torch, cfg, n + 3, dev)
    run = f32_prefill_routes(torch, cfg, params, {
        "tokens": tokens[:, :n], "frames": frames}, n + 3, dev,
        keep_cache=True)
    err = check_f32_gate(torch, cfg, run,
                         cfg.encoder_layers + 2 * cfg.n_layers,
                         f"at {ENCDEC_ROWS} x {n}")
    served = run.pop("cache")
    seq = [run["logits"][True][:, -1]]
    for i in range(3):
        logits, served, _ = T.model_apply(
            params, {"tokens": tokens[:, n + i:n + i + 1],
                     "cache_pos": n + i}, cfg, mode="decode", cache=served,
            compute_dtype=f32)
        seq.append(logits[:, -1])
    full, _, _ = T.model_apply(params, {"tokens": tokens, "frames": frames},
                               cfg, mode="train", compute_dtype=f32)
    seq, ref = torch.stack(seq, 1), full[:, n - 1:n + 3]
    dec_err = max_abs_err(seq, ref)
    check(bool(((seq - ref).abs() <= ENCDEC_DECODE_TOL
                + ENCDEC_DECODE_TOL * ref.abs()).all()),
          f"{cfg.name} f32 prefill + 3 decode steps off the train-mode "
          f"forward by {dec_err}")
    ops.reset_launch_counts()
    out = dict(rows=ENCDEC_ROWS, prompt_len=n, launches=run["launches"],
               operands_in_place=run["in_place"], max_abs_err=err,
               tolerance=f"atol = rtol = {LM_LOGITS_TOL}",
               logits_absmax=float(run["logits"][False].abs().max()),
               decode_vs_forward_max_abs_err=dec_err,
               decode_vs_forward_tolerance=f"atol = rtol = "
                                           f"{ENCDEC_DECODE_TOL}")
    del served, full, run
    torch.cuda.empty_cache()
    return out


def vlm_image_prompt(torch, cfg, dev) -> dict:
    """One image prompt as Qwen2-VL lays it out: a VLM_GRID x VLM_GRID
    patch grid of seeded image embeddings (bf16) at the front, then
    VLM_TEXT seeded text tokens. M-RoPE positions (3, 1, S): image token i
    at (0, i // 16, i % 16); text token j at 16 + j in all three
    streams."""
    n_img = VLM_GRID * VLM_GRID
    check(n_img == cfg.img_tokens, f"{cfg.name}: {cfg.img_tokens} image "
          f"tokens, not a {VLM_GRID} x {VLM_GRID} grid")
    s = n_img + VLM_TEXT
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    image = torch.randn((1, n_img, cfg.d_model), generator=g,
                        device=dev).to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (1, s), generator=g, device=dev)
    i = torch.arange(n_img, device=dev)
    text = VLM_GRID + torch.arange(VLM_TEXT, device=dev)
    pos = torch.stack([torch.cat([torch.zeros_like(i), text]),
                       torch.cat([i // VLM_GRID, text]),
                       torch.cat([i % VLM_GRID, text])])[:, None]
    return {"tokens": tokens, "image_embeds": image, "mrope_positions": pos}


def vlm_decode_batch(torch, tok, n: int, step: int) -> dict:
    """Decode step ``step`` after the image prompt of ``n`` positions: the
    sequence index for the cache, M-RoPE position 16 + 512 + step in all
    three streams."""
    p = VLM_GRID + VLM_TEXT + step
    return {"tokens": tok[:, None].long(), "cache_pos": n + step,
            "mrope_positions": torch.full((3, 1, 1), p, device=tok.device)}


def lm_vlm_phase(torch, dev) -> tuple:
    """qwen2-vl-7b at full width and depth (28 layers, d_model 3584, 28
    heads over 4 KV heads at Dh 128, QKV bias, M-RoPE sections 16/24/24;
    f32 params): the dense paths' three passes through ``Engine(slots=4,
    cache_len=4096)`` as a text model, as the reference's Engine serves it
    (``lm_serve_phase``: tokens identical, 28 bf16 flash launches a
    prefill), then one image prompt (``vlm_image_prompt``: 256 image
    embeddings and 512 text tokens) prefilled through ``model_apply`` with
    its M-RoPE positions (28 bf16 flash launches, counted from 0) and 32
    greedy decode steps; its TTFT, decode p50, and profiles of its prefill
    and of a decode step."""
    from repro_torch.kernels import ops
    from repro_torch.nn import transformer as T

    report, eng = lm_serve_phase(torch, dev, VLM_ARCH)
    cfg, params = eng.cfg, eng.params
    batch = vlm_image_prompt(torch, cfg, dev)
    n = batch["tokens"].shape[1]
    cache = T.init_cache(cfg, 1, n + LM_MAX_NEW, device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, _, _ = T.model_apply(params, dict(batch, cache_pos=0), cfg,
                                 mode="prefill", cache=cache)
    tok = logits[:, -1].argmax(-1)
    out = tok.tolist()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    pre = ops.launch_counts()
    want = {**dict.fromkeys(pre, 0), "flash_attention_tc": cfg.n_layers}
    check(pre == want, f"{cfg.name} image prefill: launches {pre} != {want}")
    check(bool(torch.isfinite(logits).all()),
          f"{cfg.name} image prefill: non-finite logits")
    toks, step_ms = greedy_decode(
        torch, cfg, params, cache, tok,
        lambda i, t: vlm_decode_batch(torch, t, n, i), LM_MAX_NEW)
    out += toks[0].tolist()
    check(all(0 <= t < cfg.padded_vocab for t in out),
          f"{cfg.name} image prompt: a token outside the vocabulary")
    prof_prefill = profile_fn(torch, lambda: T.model_apply(
        params, dict(batch, cache_pos=0), cfg, mode="prefill",
        cache=cache), steps=2)
    last = vlm_decode_batch(torch, toks[:, -1].to(dev), n, LM_MAX_NEW - 1)
    prof_decode = profile_fn(torch, lambda: T.model_apply(
        params, last, cfg, mode="decode", cache=cache), steps=4)
    for k, v in pre.items():
        report["launches"][k] = report["launches"].get(k, 0) + v
    report["image_prompt"] = dict(
        image_tokens=cfg.img_tokens, text_tokens=VLM_TEXT,
        launches=pre, ttft_ms=ttft_ms,
        decode_step_p50_ms=sorted(step_ms)[len(step_ms) // 2],
        tokens=out, profile_prefill=prof_prefill,
        profile_decode=prof_decode)
    del cache
    torch.cuda.empty_cache()
    return report, eng


def lm_vlm_gate_phase(torch, dev, eng) -> dict:
    """qwen2-vl-7b's f32 gates: the 2048-token text prefill
    (``lm_gate_phase``), then the image prompt with its M-RoPE positions:
    flash route (28 f32 launches, counted from 0, operands in place)
    against plain, last-position logits within LM_LOGITS_TOL."""
    from repro_torch.kernels import ops

    out = lm_gate_phase(torch, dev, eng, DENSE_GATE_LENS, LM_PROMPTS,
                        greedy=False)
    cfg, params = eng.cfg, eng.params
    batch = vlm_image_prompt(torch, cfg, dev)
    n = batch["tokens"].shape[1]
    run = f32_prefill_routes(torch, cfg, params, batch, n, dev)
    err = check_f32_gate(torch, cfg, run, cfg.n_layers, "on the image prompt")
    launches = run["launches"]
    out["image_prompt"] = dict(
        prompt_len=n, launches=launches, operands_in_place=run["in_place"],
        max_abs_err=err, logits_absmax=float(run["logits"][False].abs().max()))
    for k, v in launches.items():
        out["launches"][k] = out["launches"].get(k, 0) + v
    out["max_abs_err"] = max(out["max_abs_err"], err)
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the sharding layer: the sharded steps on a one-card mesh
# ---------------------------------------------------------------------------

def sharded_serve(torch, dev, mesh) -> dict:
    """qwen1.5-110b at full width (d_model 8192, 64 heads over 8 KV heads,
    Dh 128, d_ff 49152, vocab 152064, QKV bias, bf16 params), cut to
    SHARDED_LAYERS of its 80 layers, seeded: ``jit_prefill`` of
    SHARDED_ROWS rows of SHARDED_LEN tokens into a cache with room for
    SHARDED_MAX_NEW more, then SHARDED_MAX_NEW steps of ``jit_serve_step``,
    greedy, on the params placed by ``param_shardings``. Gates:
    ``init_model`` within the params' bytes + 1 GiB; the tokens equal,
    bit for bit, those of ``make_prefill`` / ``make_serve_step`` on the
    same params; kernel 7 launched once a layer in the sharded prefill
    and never in a decode step (counters set to 0 just before each and
    read just after). The sharded prefill and one decode step are then
    profiled (wall and device ms, idle share)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import param_bytes
    from repro_torch.sharding import rules

    cfg = dataclasses.replace(get_config(SHARDED_ARCH),
                              n_layers=SHARDED_LAYERS)
    params, init_s, init_peak = init_timed(torch, cfg, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab, (SHARDED_ROWS, SHARDED_LEN),
                           generator=g, device=dev)
    length = SHARDED_LEN + SHARDED_MAX_NEW

    def meta(shape, dtype=torch.int64):
        return torch.empty(shape, dtype=dtype, device="meta")

    def greedy(prefill, serve, params):
        """The prompt's next token, then SHARDED_MAX_NEW decode steps:
        (tokens (B, 1 + new), prefill launches, decode launches)."""
        with torch.no_grad():
            ops.reset_launch_counts()
            logits, cache = prefill(params, {"tokens": tokens})
            tok = torch.argmax(rules.full_value(logits)[:, -1], dim=-1)
            torch.cuda.synchronize()
            pre = {k: v for k, v in ops.launch_counts().items() if v}
            out = [tok]
            ops.reset_launch_counts()
            for i in range(SHARDED_MAX_NEW):
                tok, cache = serve(params, cache, {
                    "tokens": out[-1][:, None],
                    "cache_pos": SHARDED_LEN + i})
                out.append(rules.full_value(tok).to(torch.int64))
            torch.cuda.synchronize()
            dec = {k: v for k, v in ops.launch_counts().items() if v}
        return torch.stack(out, dim=1), pre, dec, cache

    # unsharded: the plain step builders on the plain params
    t0 = time.perf_counter()
    plain_tok, plain_pre, plain_dec, cache = greedy(
        steps.make_prefill(cfg, cache_len=length),
        steps.make_serve_step(cfg), params)
    plain_s = time.perf_counter() - t0
    del cache
    torch.cuda.empty_cache()

    # sharded: the same params placed on the mesh (one rank: no copy)
    b_shapes = {"tokens": meta((SHARDED_ROWS, SHARDED_LEN))}
    prefill, _, in_sh = steps.jit_prefill(cfg, mesh, b_shapes,
                                          cache_len=length)
    serve, _, _ = steps.jit_serve_step(
        cfg, mesh, T.init_cache(cfg, SHARDED_ROWS, length, device="meta"),
        {"tokens": meta((SHARDED_ROWS, 1)),
         "cache_pos": meta((), torch.int32)})
    placed = rules.place_tree(params, in_sh[0])
    check(all(t.to_local().data_ptr() == params_t.data_ptr()
              for (_, t), (_, params_t) in zip(tree_leaves(placed),
                                               tree_leaves(params))),
          "placing the params on a one-rank mesh copied a leaf")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh_tok, pre, dec, cache = greedy(prefill, serve, placed)
    sharded_s = time.perf_counter() - t0
    check(torch.equal(sh_tok, plain_tok),
          f"{SHARDED_ARCH}: the sharded tokens differ from the unsharded "
          f"steps' in {int((sh_tok != plain_tok).sum())} of "
          f"{sh_tok.numel()}")
    check(pre.get("flash_attention_tc", 0) == SHARDED_LAYERS
          and set(pre) == {"flash_attention_tc"},
          f"sharded prefill launched {pre}, not {SHARDED_LAYERS} x "
          "flash_attention_tc")
    check(not dec, f"sharded decode launched {dec}")
    launches = dict(pre)

    def one_prefill():
        prefill(placed, {"tokens": tokens})

    def one_decode():
        serve(placed, cache, {"tokens": sh_tok[:, -1:],
                              "cache_pos": length - 1})

    with torch.no_grad():
        prof_pre = profile_fn(torch, one_prefill, 1)
        prof_dec = profile_fn(torch, one_decode, 4)
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    p_bytes = param_bytes(params)
    cache_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                      for _, t in tree_leaves(cache))
    del placed, cache
    torch.cuda.empty_cache()
    engine = sharded_engine(torch, dev, mesh, cfg, params)
    del params
    torch.cuda.empty_cache()
    return {"config": describe(cfg) + f"; {SHARDED_LAYERS} of 80 layers",
            "params": n_params, "param_mib": p_bytes / 2 ** 20,
            "param_bytes": p_bytes, "cache_bytes": cache_bytes,
            "cache_shape": [SHARDED_ROWS, length], "engine": engine,
            "init_s": init_s, "init_peak_mib": init_peak / 2 ** 20,
            "prompt": [SHARDED_ROWS, SHARDED_LEN],
            "new_tokens": SHARDED_MAX_NEW,
            "tokens_identical": True,
            "launches_prefill": pre, "launches_decode": dec,
            "plain_launches_prefill": plain_pre,
            "plain_launches_decode": plain_dec,
            "plain_s": plain_s, "sharded_s": sharded_s,
            "launches": launches,
            "profile_prefill": prof_pre, "profile_decode": prof_dec}


def sharded_engine(torch, dev, mesh, cfg, params) -> dict:
    """Continuous batching over the mesh: ``Engine(slots=4)`` with a cache
    of 2048 + 32 slots, on the same params (qwen1.5-110b at full width,
    SHARDED_LAYERS layers) unsharded and then with ``mesh=`` (the params
    placed by ``param_shardings``: on one rank each leaf is the tensor
    itself, checked, so both share the params' 46 GB; the pool and the
    row cache made by ``cache_shardings``), each graphed. Six requests of
    SHARDED_ENGINE_PROMPTS tokens over 4 slots, 32 new tokens each
    (``lm_pass``): slots finish at different steps and new requests are
    spliced into them mid-run, so one decode step writes rows at
    different positions. Gates: the tokens of the two engines bit for
    bit; kernel 7 16 times a prefill and never in decode, eager or
    replayed (``check_lm_launches``); both engines graphed, so neither
    launches anything eagerly beyond each graph's warm-up run and capture.
    A capture that cannot hold under the mesh raises, names its op and
    fails the phase. Reported: each pass's serving
    figures and peak memory, and one decode step's wall and device ms
    (``profile_fn``)."""
    from repro_torch.launch.serve import Engine

    prompts = lm_prompts(cfg.vocab, SHARDED_ENGINE_PROMPTS)
    length = max(SHARDED_ENGINE_PROMPTS) + LM_MAX_NEW
    positions = [n - 1 for n in SHARDED_ENGINE_PROMPTS[:SHARDED_ENGINE_SLOTS]]
    out, tokens, launches = {}, {}, {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        eng = Engine(cfg, slots=SHARDED_ENGINE_SLOTS, cache_len=length,
                     params=params, device=dev, mesh=m)
        check(eng.graphed, f"the {name} engine is not graphed")
        if m is not None:
            check(all(t.to_local().data_ptr() == p.data_ptr() for (_, t), (
                _, p) in zip(tree_leaves(eng.params), tree_leaves(params))),
                  "the sharded engine's params are not the params' tensors")
        run = lm_pass(torch, eng, prompts)
        launches[name] = check_lm_launches(eng, run, SHARDED_ENGINE_PROMPTS,
                                           f"{name} engine")
        with torch.no_grad():
            prof = profile_fn(torch, lambda: eng.decode(
                [1] * SHARDED_ENGINE_SLOTS, positions), 4)
        tokens[name] = run["tokens"]
        out[name] = {"graphed": eng.graphed, "stats": run["stats"],
                     "peak_mem_mib": run["peak_mem_mib"],
                     "peak_reserved_mib": run["peak_reserved_mib"],
                     "graphs": run["graphs"], "launches": launches[name],
                     "profile_decode": {k: v for k, v in prof.items()
                                        if k != "by_kernel"},
                     "top_kernels_decode": [
                         (k["kernel"][:48], round(k["ms_per_step"], 4))
                         for k in prof["by_kernel"][:6]]}
        if m is not None:
            out[name]["pool_placements"] = [
                str(pl) for pl in next(t for n_, t in tree_leaves(eng.pool)
                                       if n_.endswith("/k")).placements]
        del eng
        torch.cuda.empty_cache()
    differ = [rid for rid in tokens["unsharded"]
              if tokens["sharded"][rid] != tokens["unsharded"][rid]]
    check(not differ, f"the sharded engine's tokens differ from the "
                      f"unsharded engine's in requests {differ}")
    out.update(prompts=list(SHARDED_ENGINE_PROMPTS),
               slots=SHARDED_ENGINE_SLOTS, cache_len=length,
               new_tokens=LM_MAX_NEW, tokens_identical=True,
               launches=launches["sharded"])
    return out


def sharded_train(torch, dev, mesh) -> dict:
    """smollm-360m at full width and depth: SHARDED_TRAIN_STEPS steps of
    ``jit_train_step`` on the mesh and of ``make_train_step`` from the
    same seeded params, moments and batches (8 x 2048 in microbatches of
    4). Gates: the loss, the gradient norm, the learning rate and every
    updated param and moment bit for bit. Then the sharded run's tree
    saved and restored elastically onto the mesh (``restore(...,
    shardings=...)``): bit for bit, each leaf a DTensor."""
    import shutil
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batch
    from repro_torch.launch import steps
    from repro_torch.nn import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules

    cfg = get_config(LM_TRAIN_ARCH)
    ts = steps.TrainSettings(microbatch=4, opt=adamw.OptConfig(
        peak_lr=3e-4, warmup_steps=1, decay_steps=4))
    params = T.init_model(torch.Generator(device=dev).manual_seed(SEED), cfg,
                          device=dev)
    opt = adamw.init(params, steps.opt_config(cfg, ts))
    dcfg = DataConfig(seq=LM_TRAIN_SEQ, global_batch=LM_TRAIN_BATCH,
                      vocab=cfg.padded_vocab, seed=SEED)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                synthetic_lm_batch(dcfg, i).items()}
               for i in range(SHARDED_TRAIN_STEPS)]
    shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in batches[0].items()}
    step, _, in_sh = steps.jit_train_step(cfg, mesh, ts, shapes)
    plain = steps.make_train_step(cfg, ts)
    p1, o1, p2, o2 = params, opt, params, opt
    rows, ms = [], {"plain": [], "sharded": []}
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p1, o1, m1 = plain(p1, o1, b)
        torch.cuda.synchronize()
        ms["plain"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        p2, o2, m2 = step(p2, o2, b)
        torch.cuda.synchronize()
        ms["sharded"].append((time.perf_counter() - t0) * 1e3)
        m2 = {k: rules.full_value(v) for k, v in m2.items()}
        rows.append({k: [float(m1[k]), float(m2[k])] for k in m1})
        check(all(torch.equal(m1[k], m2[k]) for k in m1),
              f"sharded train step {i}: metrics {rows[-1]}")
    want = dict(tree_leaves({"p": p1, "o": o1}))
    got = dict(tree_leaves({"p": p2, "o": o2}))
    differ = [k for k in want if not torch.equal(want[k], got[k].to_local())]
    check(not differ and len(got) == len(want),
          f"sharded train step: leaves differ from the unsharded step's: "
          f"{differ[:8]}")
    del p1, o1, want
    torch.cuda.empty_cache()

    root = ROOT / "build" / "sharded_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    try:
        ck = Checkpointer(str(root))
        t0 = time.perf_counter()
        ck.save(SHARDED_TRAIN_STEPS, {"params": p2, "opt": o2}, block=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree, _ = ck.restore(SHARDED_TRAIN_STEPS, shardings={
            "params": in_sh[0], "opt": in_sh[1]})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    back = dict(tree_leaves({"p": tree["params"], "o": tree["opt"]}))
    check(sorted(back) == sorted(got)
          and all(hasattr(t, "placements") for t in back.values())
          and all(back[k].dtype == got[k].dtype
                  and torch.equal(back[k].to_local(), got[k].to_local())
                  for k in got),
          "the checkpoint round trip on the mesh is not bit for bit")
    return {"config": f"{LM_TRAIN_ARCH} at full width and depth, f32 params, "
                      f"bf16 compute, remat; batch {LM_TRAIN_BATCH} x "
                      f"{LM_TRAIN_SEQ} in microbatches of 4",
            "steps": rows, "metrics_bit_for_bit": True,
            "leaves_bit_for_bit": len(got), "ms_per_step": ms,
            "checkpoint": {"leaves": len(back), "save_s": save_s,
                           "restore_s": restore_s, "bit_for_bit": True}}


def sharded_psum(torch, dev, mesh) -> dict:
    """``compressed_psum_int8`` over NCCL at world size 1 on each mesh
    axis: the reference's formula, quantise and then dequantise."""
    from repro_torch.optim.compression import compressed_psum_int8
    from repro_torch.sharding import set_mesh
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((4096,), generator=g, device=dev) * 3.0
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    want = torch.clamp(torch.round(x / scale), -127, 127) * scale
    out = {}
    with set_mesh(mesh):
        for axis in ("data", "model"):
            got = compressed_psum_int8(x, axis)
            out[axis] = max_abs_err(got, want)
            check(torch.equal(got, want),
                  f"compressed_psum_int8 over {axis}: off by {out[axis]}")
    return {"max_abs_err": out, "exact": True}


def sharded_phase(torch, dev) -> dict:
    """The sharding layer on the card: ``make_cpu_mesh`` on the card (a
    one-rank NCCL group through a ``HashStore``, a (1, 1) ``("data",
    "model")`` mesh), then ``sharded_serve``, ``sharded_train`` and
    ``sharded_psum`` on it; the group is destroyed after. On one rank
    every redistribution is the identity, so each gate is bit for bit."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_cpu_mesh
    check(not dist.is_initialized(), "a process group is already up")
    mesh = make_cpu_mesh(device=dev)
    try:
        out = {"mesh": {"shape": list(mesh.shape),
                        "names": list(mesh.mesh_dim_names),
                        "backend": dist.get_backend()}}
        out["serve"] = sharded_serve(torch, dev, mesh)
        torch.cuda.empty_cache()
        out["train"] = sharded_train(torch, dev, mesh)
        torch.cuda.empty_cache()
        out["psum"] = sharded_psum(torch, dev, mesh)
    finally:
        dist.destroy_process_group()
    out["launches"] = {k: out["serve"]["launches"].get(k, 0)
                       + out["serve"]["engine"]["launches"].get(k, 0)
                       for k in set(out["serve"]["launches"])
                       | set(out["serve"]["engine"]["launches"])}
    return out


def dryrun_phase(torch, dev, sharded: dict) -> dict:
    """The dry run (``launch/dryrun.py``) on the card's host, after the
    sharded phase's group is gone: the sharded phase's own prefill (4 x
    2048 into a cache of 2080) and decode step (4 rows at 2080) of
    qwen1.5-110b at SHARDED_LAYERS layers, traced on a fake (1, 1) world
    of meta tensors (a ``cuda`` mesh: NCCL's collectives). Gate: the
    predicted argument bytes of the params (prefill) and of the params
    and the cache (decode) equal exactly what the card allocated for
    them. Reported: the predicted peak beside ``max_memory_allocated`` of
    the profiled calls, and the predicted FLOPs and ``bound_s`` beside the
    measured device ms, each gap as a ratio. Then the demo's production
    cell (qwen3-moe-30b-a3b train_4k on 2x16x16) in a subprocess, its
    trace seconds reported: it must end within DRYRUN_DEMO_TIMEOUT_S, or
    the phase fails (the cell pins the reduction of mixed partials one
    mesh axis at a time, which only the card's torch refuses otherwise)."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    check(not dist.is_initialized(), "a process group is still up")
    cfg = dataclasses.replace(get_config(SHARDED_ARCH),
                              n_layers=SHARDED_LAYERS)
    serve = sharded["serve"]
    length = SHARDED_LEN + SHARDED_MAX_NEW
    out = {}
    for kind, shape, card_bytes, prof in (
            ("prefill", ShapeSpec("prefill", "prefill", SHARDED_LEN,
                                  SHARDED_ROWS),
             {"params": serve["param_bytes"]}, serve["profile_prefill"]),
            ("decode", ShapeSpec("decode", "decode", length, SHARDED_ROWS),
             {"params": serve["param_bytes"], "cache": serve["cache_bytes"]},
             serve["profile_decode"])):
        t0 = time.perf_counter()
        rec, _ = dryrun.dry_run(cfg, shape, (1, 1), ("data", "model"),
                                cache_len=length)
        seconds = time.perf_counter() - t0
        check(not dist.is_initialized(), "the fake world was left up")
        got = {k: rec["memory"]["argument_bytes_by_kind"][k]
               for k in card_bytes}
        check(got == card_bytes, f"dry run {kind}: predicted argument bytes "
                                 f"{got} != the card's {card_bytes}")
        peak = rec["memory"]["peak_gb_per_chip"] * 1e9
        measured_peak = prof["peak_mem_mib"] * 2 ** 20
        device_ms = prof["device_ms_per_step"]
        bound_ms = rec["roofline"]["bound_s"] * 1e3
        out[kind] = {
            "seconds": seconds, "compile_s": rec["compile_s"],
            "argument_bytes_by_kind": rec["memory"]["argument_bytes_by_kind"],
            "card_bytes": card_bytes, "argument_bytes_exact": True,
            "predicted_peak_bytes": peak, "card_max_allocated": measured_peak,
            "peak_ratio": peak / measured_peak,
            "predicted_flops": rec["cost"]["flops_per_chip"],
            "predicted_hbm_bytes": rec["cost"]["hbm_bytes_per_chip"],
            "roofline": {k: rec["roofline"][k] for k in (
                "compute_s", "memory_s", "collective_s", "dominant",
                "bound_s")},
            "device_ms": device_ms, "wall_ms": prof["wall_ms_per_step"],
            "bound_over_device": (bound_ms / device_ms
                                  if isinstance(device_ms, float) else None),
            "achieved_flops_per_s": (rec["cost"]["flops_per_chip"]
                                     / (device_ms / 1e3)
                                     if isinstance(device_ms, float)
                                     else None)}
    code = ("import json, sys, time; sys.path.insert(0, 'src'); "
            "from repro_torch.launch import dryrun; t0 = time.perf_counter(); "
            f"rec, _ = dryrun.lower_cell({DRYRUN_DEMO[0]!r}, "
            f"{DRYRUN_DEMO[1]!r}, multi_pod=True); "
            "print(json.dumps({'seconds': time.perf_counter() - t0, "
            "'compile_s': rec['compile_s'], 'lower_s': rec['lower_s'], "
            "'mesh_device_type': rec['mesh_device_type'], "
            "'peak_gb_per_chip': rec['memory']['peak_gb_per_chip'], "
            "'fits_80gb': rec['memory']['fits_80gb'], "
            "'roofline': rec['roofline'], 'cost': rec['cost'], "
            "'collectives': rec['collectives']}))")
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True,
                             timeout=DRYRUN_DEMO_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise CheckFailed(f"the demo cell's dry run did not end within "
                          f"{DRYRUN_DEMO_TIMEOUT_S} s") from None
    check(res.returncode == 0, f"the demo cell's dry run failed: "
                               f"{res.stderr[-1500:]}")
    demo = json.loads(res.stdout.strip().splitlines()[-1])
    demo["process_s"] = time.perf_counter() - t0
    out["production_cell"] = {"arch": DRYRUN_DEMO[0], "shape": DRYRUN_DEMO[1],
                              "mesh": "2x16x16", **demo}
    out["launches"] = {}
    return out


# readings beyond the contract's keys, kept in the kernels line
EXTRA_KEYS = ("library_int8_ms", "ms_int16_table", "ms_events",
              "ms_in_graph", "ms_conv0_stride0", "ms_index_entry",
              "ms_fc1_f32", "bound_ms_fc1_f32", "library_ms_fc1_f32",
              "ms_conv0_int16", "ms_conv0_f32", "ms_packed_default_f32",
              "at_hymba_shape", "at_glm4_shape", "at_stablelm_shape",
              "at_qwen3moe_shape", "at_whisper_encoder_shape",
              "at_whisper_self_shape", "at_whisper_cross_shape",
              "at_qwen2vl_shape", "at_qwen110b_shape")


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
             "lm_gate", "lm_hybrid_serve", "lm_hybrid_gate", "lm_ssm_serve",
             "spikformer_train", "examples", "lm_dense12b_serve",
             "lm_dense12b_gate", "lm_dense9b_serve", "lm_dense9b_gate",
             "lm_moe_serve", "lm_moe_gate", "lm_train", "lm_encdec",
             "lm_encdec_gate", "lm_vlm", "lm_vlm_gate", "sharded", "dryrun")
    phase_s = report["phase_s"] = {}     # wall seconds, build excluded
    t_phase = [time.perf_counter()]

    def timed(name):
        now = time.perf_counter()
        phase_s[name] = now - t_phase[0]
        t_phase[0] = now

    try:
        report["kernels"] = kernel_phase(torch, dev)
        timed("kernels")
        for k, row in report["kernels"].items():
            row["profile_windows"] = PROFILE_WINDOWS.get(k, [])
        cfg = SpikformerConfig()
        folded = gained_tree(torch, cfg)
        requests = request_images(cfg)
        batch = torch.from_numpy(np.concatenate(requests)[:BATCH]).to(dev)
        report[paths[0]] = serve_phase(torch, dev, cfg, folded, requests,
                                       batch)
        int8_logits = report[paths[0]].pop("logits")
        timed(paths[0])
        torch.cuda.empty_cache()
        report[paths[1]] = lut_serve_phase(torch, dev, cfg, folded, requests,
                                           batch)
        timed(paths[1])
        torch.cuda.empty_cache()
        report[paths[2]] = unpack_step_phase(torch, dev, cfg, folded, batch,
                                             int8_logits)
        timed(paths[2])
        torch.cuda.empty_cache()
        report[paths[3]] = route_phase(torch, dev, cfg, folded, requests,
                                       batch, int8_logits)
        timed(paths[3])
        torch.cuda.empty_cache()
        report[paths[4]] = serving_stack_phase(torch, dev, cfg, folded)
        timed(paths[4])
        torch.cuda.empty_cache()
        report[paths[5]] = events_cli_phase(torch, dev)
        timed(paths[5])
        torch.cuda.empty_cache()
        report[paths[6]] = events_full_width_phase(torch, dev)
        timed(paths[6])
        torch.cuda.empty_cache()
        report[paths[7]] = packed_default_f32_phase(torch, dev, cfg, folded,
                                                    batch)
        report["kernels"]["unpack_dot"]["ms_packed_default_f32"] = {
            k: v["ms"] for k, v in
            report[paths[7]]["unpack_dot_by_shape"].items()}
        timed(paths[7])
        torch.cuda.empty_cache()
        report[paths[8]], lm_engine = lm_serve_phase(torch, dev)
        report["kernels"]["flash_attention_tc"]["ms_in_graph"] = \
            graphed_flash_ms(
                report[paths[8]][f"profile_prefill_{PROFILE_LEN}"])
        timed(paths[8])
        report[paths[9]] = lm_gate_phase(torch, dev, lm_engine)
        timed(paths[9])
        del lm_engine
        torch.cuda.empty_cache()
        report[paths[10]], lm_engine = lm_serve_phase(
            torch, dev, HYBRID_ARCH, HYBRID_PROMPTS)
        report["kernels"]["flash_attention_tc"]["at_hymba_shape"][
            "ms_in_graph"] = graphed_flash_ms(
                report[paths[10]][f"profile_prefill_{PROFILE_LEN}"])
        timed(paths[10])
        report[paths[11]] = lm_gate_phase(
            torch, dev, lm_engine, HYBRID_GATE_LENS, HYBRID_PROMPTS,
            greedy=False)
        timed(paths[11])
        del lm_engine
        torch.cuda.empty_cache()
        report[paths[12]], lm_engine = lm_serve_phase(
            torch, dev, SSM_ARCH, HYBRID_PROMPTS)
        timed(paths[12])
        del lm_engine
        torch.cuda.empty_cache()
        report[paths[13]] = spikformer_train_phase(torch, dev)
        timed(paths[13])
        torch.cuda.empty_cache()
        report[paths[14]] = examples_phase(torch, dev, report)
        timed(paths[14])
        torch.cuda.empty_cache()
        # the two large dense paths and the MoE path last, so that every
        # earlier phase runs as it did without them; one large model alive
        # at a time: each engine (and its weights) is freed before the
        # next path draws its own
        for i, (arch, shape, dtype) in enumerate((
                (DENSE12B_ARCH, "at_stablelm_shape", None),
                (DENSE9B_ARCH, "at_glm4_shape", None),
                (MOE_ARCH, "at_qwen3moe_shape", MOE_PARAM_DTYPE))):
            serve_path, gate_path = paths[15 + 2 * i], paths[16 + 2 * i]
            report[serve_path], lm_engine = lm_serve_phase(
                torch, dev, arch, param_dtype=dtype)
            report["kernels"]["flash_attention_tc"][shape]["ms_in_graph"] = \
                graphed_flash_ms(
                    report[serve_path][f"profile_prefill_{PROFILE_LEN}"])
            timed(serve_path)
            report[gate_path] = lm_gate_phase(
                torch, dev, lm_engine, DENSE_GATE_LENS, LM_PROMPTS,
                greedy=False)
            timed(gate_path)
            del lm_engine
            torch.cuda.empty_cache()
        report[paths[21]] = lm_train_phase(torch, dev)
        timed(paths[21])
        torch.cuda.empty_cache()
        # the encoder-decoder and VLM paths after every earlier phase, one
        # large model alive at a time
        report[paths[22]], cfg_e, params_e = lm_encdec_phase(torch, dev)
        timed(paths[22])
        report[paths[23]] = lm_encdec_gate_phase(torch, dev, cfg_e,
                                                 params_e)
        timed(paths[23])
        del params_e
        torch.cuda.empty_cache()
        report[paths[24]], lm_engine = lm_vlm_phase(torch, dev)
        report["kernels"]["flash_attention_tc"]["at_qwen2vl_shape"][
            "ms_in_graph"] = graphed_flash_ms(
                report[paths[24]][f"profile_prefill_{PROFILE_LEN}"])
        timed(paths[24])
        report[paths[25]] = lm_vlm_gate_phase(torch, dev, lm_engine)
        timed(paths[25])
        del lm_engine
        torch.cuda.empty_cache()
        # the sharded entry points last, after every earlier phase
        report[paths[26]] = sharded_phase(torch, dev)
        timed(paths[26])
        torch.cuda.empty_cache()
        # the dry run after the sharded phase's group is destroyed
        report[paths[27]] = dryrun_phase(torch, dev, report[paths[26]])
        timed(paths[27])
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
    for path in ("lm_serve", "lm_hybrid_serve", "lm_ssm_serve",
                 "lm_dense12b_serve", "lm_dense9b_serve", "lm_moe_serve",
                 "lm_vlm"):
        lm = report[path]
        for name in ("eager", "cold", "warm"):
            run = lm["passes"][name]
            print(json.dumps({"path": path, "pass": name,
                              "serve": run["stats"],
                              "peak_mem_mib": run["peak_mem_mib"],
                              "peak_reserved_mib": run["peak_reserved_mib"],
                              "captured": len(run["captured"]),
                              "graphs": run["graphs"],
                              "launches": lm["launches_by_pass"][name]}))
        print(json.dumps({"path": path, "config": lm["config"],
                          "params": lm["params"], "init_s": lm["init_s"],
                          "init_peak_mib": lm["init_peak_mib"],
                          "param_mib": lm["param_mib"],
                          "tokens_identical": lm["tokens_identical"],
                          "graphed_warmup_s": lm["graphed_warmup_s"]}))
        for window in (f"profile_prefill_{PROFILE_LEN}",
                       f"profile_prefill_{PROFILE_LEN}_eager",
                       "profile_decode", "profile_decode_eager"):
            prof = lm[window]
            print(json.dumps({"path": path, window: {
                k: v for k, v in prof.items() if k != "by_kernel"},
                "top_kernels": [(k["kernel"][:48], round(k["ms_per_step"], 4))
                                for k in prof["by_kernel"][:8]]}))
    print(json.dumps({"lm_gate": report["lm_gate"]}))
    for gate in ("lm_hybrid_gate", "lm_dense12b_gate", "lm_dense9b_gate",
                 "lm_moe_gate", "lm_encdec_gate", "lm_vlm_gate"):
        print(json.dumps({gate: report[gate]}))
    print(json.dumps({"spikformer_train": report["spikformer_train"]}))
    ex = report["examples"]
    print(json.dumps({"examples": {k: ex[k] for k in (
        "quickstart_launches", "serving_launches", "serve_under_load",
        "serve_events", "serve_lm", "engine_model", "train_lm_100m")}}))
    lt = report["lm_train"]
    print(json.dumps({"lm_train": {
        **{k: lt[k] for k in ("config", "launches",
                              "losses_after_restore_rel_err",
                              "losses_after_restore_bit_for_bit",
                              "reduced_vs_cpu")},
        "runs": {name: {k: v for k, v in r.items()
                        if k not in ("attn_grad_norms", "not_past_decay")}
                 for name, r in lt["runs"].items()},
        "attn_grad_norms_step0": lt["runs"]["uninterrupted"][
            "attn_grad_norms"][0],
        "profile_step": {k: v for k, v in lt["profile_step"].items()
                         if k != "by_kernel"},
        "top_kernels": [(k["kernel"][:48], round(k["ms_per_step"], 2))
                        for k in lt["profile_step"]["by_kernel"][:10]]}}))
    ed = report["lm_encdec"]
    print(json.dumps({"lm_encdec": {
        **{k: v for k, v in ed.items() if not k.startswith("profile")},
        **{k: {"summary": {x: y for x, y in v.items() if x != "by_kernel"},
               "top_kernels": [(r["kernel"][:48], round(r["ms_per_step"], 4))
                               for r in v["by_kernel"][:8]]}
           for k, v in ed.items() if k.startswith("profile")}}}))
    img = report["lm_vlm"]["image_prompt"]
    print(json.dumps({"lm_vlm_image_prompt": {
        **{k: v for k, v in img.items() if not k.startswith("profile")},
        **{k: {x: y for x, y in v.items() if x != "by_kernel"}
           for k, v in img.items() if k.startswith("profile")}}}))
    sh = report["sharded"]
    print(json.dumps({"sharded": {
        "mesh": sh["mesh"],
        "serve": {k: v for k, v in sh["serve"].items()
                  if not k.startswith("profile")},
        **{f"serve_{k}": {x: y for x, y in v.items() if x != "by_kernel"}
           for k, v in sh["serve"].items() if k.startswith("profile")},
        "train": sh["train"], "psum": sh["psum"]}}))
    print(json.dumps({"dryrun": report["dryrun"]}))
    print(json.dumps({"phase_s": phase_s, "build_s": build_s}))
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
