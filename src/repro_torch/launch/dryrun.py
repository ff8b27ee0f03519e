"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture x input-shape) cell this runs the real step
program — ``steps.jit_train_step``, ``jit_prefill`` or ``jit_serve_step``
— over DTensors on the production mesh, 16x16 single-pod and 2x16x16
multi-pod, as a fake world of 256 or 512 ranks seen from rank 0
(``launch.mesh.fake_world``: ranks, groups and collectives with nothing
behind them), on meta tensors shaped by ``configs.base.
input_specs``: nothing is allocated and no byte moves. While the step
runs, ``hlo_analysis.OpTrace`` records the ops rank 0 dispatches beneath
DTensor. The record holds:

  * memory — per-rank argument bytes (the rank's shards of params,
    optimizer state, batch and cache), output bytes (the step's new
    tensors), and temp bytes: the peak of the storage the step makes,
    live at once above the arguments; ``fits_80gb``.
  * cost — per-rank FLOPs and bytes by ``hlo_analysis.analyze``. The
    reference's ``xla_*`` cross-check keys are gone: no XLA exists here.
  * collectives — per-rank payload bytes by kind, and by mesh axis.
  * roofline terms — compute / memory / collective seconds with the
    H100's constants below.

The port's kernels do not run in a trace: inside it only, kernel 7
(``kernels.ops.flash_attention``) is a stand-in that makes an empty
output of the kernel's shape and records one op with the kernel's FLOPs
and bytes (the formula of ``chip_smoke.py``'s kernel-7 bound). A train
step of more than two microbatches is traced over the forward and
backward of its first two (``steps.accumulate``); every later microbatch
repeats the second's ops exactly, so each adds the second's cost. Every
other op of the step, each microbatch's slice of the batch included, is
traced in full.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import (ARCH_IDS, SHAPES, ShapeSpec, cell_applicable,
                            get_config, input_specs)
from ..kernels import ops
from ..nn.module import tree_paths
from ..sharding import rules
from . import steps
from .hlo_analysis import OpTrace, analyze
from .mesh import fake_world, production_shape

# --- NVIDIA H100 SXM5 80GB hardware model, at its 700 W power limit ---------
POWER_LIMIT_W = 700     # the limit at which the data sheet's rates hold
PEAK_FLOPS = 989e12     # bf16 dense FLOP/s per card (NVIDIA H100 Tensor
#                         Core GPU data sheet, SXM; 1979e12 is with sparsity)
HBM_BW = 3.35e12        # HBM3 bytes/s per card (the same data sheet)
HBM_BYTES = 80e9        # HBM bytes per card (the same data sheet)
NVLINK_BW = 450e9       # bytes/s each way per card: 4th-generation NVLink,
#                         900 GB/s both ways (the same data sheet)
NET_BW = 50e9           # bytes/s each way per card between hosts: one
#                         400 Gb/s ConnectX-7 port a card (NVIDIA DGX H100
#                         data sheet: 8 ports for 8 cards)
HOST_CARDS = 8          # cards a host, joined all to all by NVLink (DGX H100)

TRACED_MICROBATCHES = 2


def axis_links(shape, names) -> dict:
    """Each mesh axis's per-card link rate: NVLink where the axis's ranks
    lie within one host of HOST_CARDS consecutive ranks (the axis's size
    times its stride at most HOST_CARDS), the network otherwise."""
    links = {}
    for i, name in enumerate(names):
        span = math.prod(shape[i:])
        links[name] = NVLINK_BW if span <= HOST_CARDS else NET_BW
    return links


def flash_cost(q, k, causal: bool) -> tuple[float, float]:
    """Kernel 7's FLOPs and bytes on (B, H, Nq, Dh) over (B, KV, Nkv,
    Dh): ``chip_smoke.py``'s bound, 4 B H Dh FLOPs a (query, key) pair the
    mask keeps; q, k, v read once and an f32-wide output written once."""
    b, h, nq, dh = q.shape
    nkv = k.shape[2]
    kept = nq * (nkv - nq) + nq * (nq + 1) // 2 if causal else nq * nkv
    size = q.element_size()
    nbytes = (q.numel() + 2 * k.numel()) * size + q.numel() * 4
    return 4.0 * b * h * kept * dh, float(nbytes)


@contextlib.contextmanager
def kernels_stood_in(trace: OpTrace, *, compute: bool = False):
    """Kernel 7 replaced, for the block, by a stand-in that records its
    cost in ``trace`` and returns an empty tensor of its output's shape
    and dtype, f32 (the kernel's pointers cannot be meta). ``compute=True``
    (a traced run on real tensors) returns the kernel's own result, its
    ops kept out of the trace, so that the trace is the dry run's."""
    real = ops.flash_attention

    def stand_in(q, k, v, *, scale=None, causal=True, **kw):
        with trace.paused():
            out = real(q, k, v, scale=scale, causal=causal, **kw) \
                if compute else torch.empty(q.shape, dtype=torch.float32,
                                            device=q.device)
        flops, nbytes = flash_cost(q, k, causal)
        trace.record("flash_attention", (q, k, v), (out,), flops=flops,
                     bytes_=nbytes)
        return out

    ops.flash_attention = stand_in
    try:
        yield
    finally:
        ops.flash_attention = real


@contextlib.contextmanager
def microbatches_cut(trace: OpTrace, keep: int, record: list):
    """``steps.accumulate`` run for the first ``keep`` microbatches only;
    each later one returns the last one's loss, unrun (a meta tensor of
    the same layout, so the step's sum of losses runs as it would). Appends
    each run microbatch's (first op, end op) in ``trace`` to ``record``
    and counts the skipped ones (``record``'s None entries)."""
    real = steps.accumulate
    last = []

    def cut(*args, **kwargs):
        if len(record) < keep:
            start = len(trace.ops)
            last[:] = [real(*args, **kwargs)]
            record.append((start, len(trace.ops)))
            return last[0]
        record.append(None)
        return last[0]

    steps.accumulate = cut
    try:
        yield
    finally:
        steps.accumulate = real


def _meta_shards(shapes, shardings):
    """The tree of ``shapes`` as DTensors laid out by ``shardings``, each
    rank's shard a meta tensor (nothing allocated)."""
    return rules.new_sharded(shapes, shardings, lambda _: 0, "meta")


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    seen, total = set(), 0
    for local in _locals(tree):
        st = local.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def _locals(tree) -> list:
    return [t.to_local() if isinstance(t, DTensor) else t
            for _, t in tree_paths(tree) if isinstance(t, torch.Tensor)]


def _train_settings(cfg, microbatch):
    # >=100B configs: bf16 grad accumulation + smaller microbatch, or
    # params + moments + grads + activations outgrow a card
    big = cfg.opt_state_dtype == "bfloat16"
    return steps.TrainSettings(microbatch=microbatch or (16 if big else 32),
                               accum_dtype=cfg.opt_state_dtype)


def trace_step(cfg, shape: ShapeSpec, mesh, *, microbatch=None,
               cache_len=None, cut_microbatches: bool = True):
    """Build ``shape``'s step for ``cfg`` over ``mesh``, place its
    arguments as meta shards and run it under an ``OpTrace``. Returns
    ``(trace, info)``: ``info`` holds the argument bytes by kind, the
    output bytes, the build and trace seconds, and, for a train step whose
    microbatches were cut, ``(per_micro_ops, skipped)``: the ops of the
    last run microbatch and how many were not run."""
    if shape.kind == "decode" and cache_len is not None:
        shape = dataclasses.replace(shape, seq=cache_len)   # the cache's
    spec = input_specs(cfg, shape)
    t0 = time.perf_counter()
    if shape.kind == "train":
        ts = _train_settings(cfg, microbatch)
        step, (p_abs, o_abs, _), in_sh = steps.jit_train_step(
            cfg, mesh, ts, spec["batch"])
        args = {"params": _meta_shards(p_abs, in_sh[0]),
                "opt_state": _meta_shards(o_abs, in_sh[1]),
                "batch": _meta_shards(spec["batch"], in_sh[2])}
        call = (args["params"], args["opt_state"], args["batch"])
    elif shape.kind == "prefill":
        step, (p_abs, _), in_sh = steps.jit_prefill(
            cfg, mesh, spec["batch"], cache_len=cache_len)
        args = {"params": _meta_shards(p_abs, in_sh[0]),
                "batch": _meta_shards(spec["batch"], in_sh[1])}
        call = (args["params"], args["batch"])
    else:
        step, (p_abs, c_abs, _), in_sh = steps.jit_serve_step(
            cfg, mesh, spec["cache"], spec["batch"])
        batch_spec = {k: v for k, v in spec["batch"].items()
                      if k != "cache_pos"}
        batch = _meta_shards(batch_spec, {k: in_sh[2][k] for k in batch_spec})
        # the reference's traced 0-d position, as the host int the port's
        # step takes: the cache's last slot
        batch["cache_pos"] = shape.seq - 1
        args = {"params": _meta_shards(p_abs, in_sh[0]),
                "cache": _meta_shards(c_abs, in_sh[1]), "batch": batch}
        call = (args["params"], args["cache"], args["batch"])
    build_s = time.perf_counter() - t0

    known = _locals(args)
    trace = OpTrace(known)
    record: list = []
    cut = (microbatches_cut(trace, TRACED_MICROBATCHES, record)
           if shape.kind == "train" and cut_microbatches
           else contextlib.nullcontext())
    t0 = time.perf_counter()
    with kernels_stood_in(trace), cut, trace:
        out = step(*call)
    trace_s = time.perf_counter() - t0
    keep = {id(t.untyped_storage()) for t in known}
    out_locals = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                  for t in _locals(out)
                  if id(t.untyped_storage()) not in keep}
    info = {"argument_bytes": {k: _local_bytes(v) for k, v in args.items()},
            "output_bytes": sum(out_locals.values()),
            "build_s": build_s, "trace_s": trace_s,
            "microbatches": None}
    run = [r for r in record if r is not None]
    skipped = len(record) - len(run)
    if skipped:
        start, end = run[-1]
        info["microbatches"] = {"run": len(run), "skipped": skipped,
                                "per_micro_ops": trace.ops[start:end]}
    return trace, info


def cost_of(trace: OpTrace, info: dict, axes: dict):
    """The step's whole cost: the trace's, plus the per-microbatch cost
    times the microbatches not run."""
    cost = analyze(trace, axes)
    mb = info["microbatches"]
    if mb:
        cost.add(analyze(mb["per_micro_ops"], axes), mult=mb["skipped"])
    return cost


def dry_run(cfg, shape: ShapeSpec, mesh_shape, axis_names, *,
            microbatch=None, cache_len=None, device_type=None,
            cut_microbatches: bool = True) -> tuple[dict, OpTrace]:
    """One cell on a fake world of ``mesh_shape`` (``axis_names``), seen
    from rank 0: the record (the reference's keys; see the module
    docstring) and the trace. ``device_type`` is the fake mesh's
    (``launch.mesh.fake_world``: ``cuda`` where torch sees a card, else
    ``cpu``); either way the collectives counted are NCCL's, an all-to-all
    as an all-to-all."""
    with fake_world(mesh_shape, axis_names, device_type=device_type) as mesh:
        trace, info = trace_step(cfg, shape, mesh, microbatch=microbatch,
                                 cache_len=cache_len,
                                 cut_microbatches=cut_microbatches)
        axes = {mesh.get_group(i).group_name: name
                for i, name in enumerate(axis_names)}
        device_type = mesh.device_type
    cost = cost_of(trace, info, axes)
    n_chips = math.prod(mesh_shape)
    links = axis_links(mesh_shape, axis_names)
    coll_s = sum(b / links.get(ax, NET_BW)
                 for ax, b in cost.coll_axis_bytes.items())
    terms = {"compute_s": cost.flops / PEAK_FLOPS,
             "memory_s": cost.bytes / HBM_BW,
             "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())

    tokens = shape.batch * (shape.seq if shape.kind in ("train", "prefill")
                            else 1)
    n_active = cfg.n_active_params()
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    hlo_flops_global = cost.flops * n_chips
    ideal_model_s = model_flops / (n_chips * PEAK_FLOPS)
    args = sum(info["argument_bytes"].values())
    temp = trace.peak_bytes
    peak = args + temp
    record = {
        "mesh": "x".join(map(str, mesh_shape)),
        "n_chips": int(n_chips),
        "kind": shape.kind,
        "mesh_device_type": device_type,
        "lower_s": round(info["build_s"], 2),
        "compile_s": round(info["trace_s"], 2),
        "microbatches": None if info["microbatches"] is None else {
            k: v for k, v in info["microbatches"].items()
            if k != "per_micro_ops"},
        "memory": {
            "argument_bytes": args,
            "argument_bytes_by_kind": info["argument_bytes"],
            "output_bytes": info["output_bytes"],
            "temp_bytes": temp,
            # the outputs are made during the step: within temp's peak
            "peak_gb_per_chip": round(peak / 1e9, 3),
            "fits_80gb": peak < HBM_BYTES,
        },
        "cost": {
            "flops_per_chip": cost.flops,
            "hbm_bytes_per_chip": cost.bytes,
        },
        "collectives": {
            "bytes": dict(cost.coll_bytes),
            "counts": dict(cost.coll_counts),
            "bytes_by_axis": dict(cost.coll_axis_bytes),
            "total_bytes": cost.collective_total,
        },
        "roofline": {
            **{k: round(v, 6) for k, v in terms.items()},
            "dominant": dominant,
            "bound_s": round(bound_s, 6),
            "links_bytes_per_s": links,
            "model_flops": model_flops,
            "hlo_flops_global": hlo_flops_global,
            # MODEL_FLOPS / traced FLOPs: <1 means remat, attention,
            # router or replicated overhead
            "useful_flops_ratio": round(
                model_flops / hlo_flops_global, 4) if hlo_flops_global else 0,
            # fraction of roofline: ideal model-compute time / bound time
            "roofline_frac": round(ideal_model_s / max(bound_s, 1e-12), 4),
        },
        "params": {"total": cfg.n_params(), "active": n_active},
        "hardware": {"card": "NVIDIA H100 SXM5 80GB",
                     "power_limit_w": POWER_LIMIT_W,
                     "peak_flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW},
    }
    return record, trace


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               microbatch: int | None = None, device_type=None):
    """Dry-run one cell. Returns ``(record, trace)`` (``trace`` None for a
    skipped cell)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}, None
    mesh_shape, names = production_shape(multi_pod=multi_pod)
    rec, trace = dry_run(cfg, shape, mesh_shape, names,
                         microbatch=microbatch, device_type=device_type)
    rec = {"arch": arch, "shape": shape_name,
           **dict(rec, mesh="2x16x16" if multi_pod else "16x16")}
    return rec, trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--microbatch", type=int, default=None)
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    arches = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    for arch in arches:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
                try:
                    rec, _ = lower_cell(arch, shape, multi_pod=mp,
                                        microbatch=args.microbatch)
                except Exception as e:  # a failure here is a bug in our system
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "error": f"{type(e).__name__}: {e}"}
                (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
                if "skipped" in rec:
                    print(f"[skip] {tag}: {rec['skipped']}", flush=True)
                elif "error" in rec:
                    print(f"[FAIL] {tag}: {rec['error'][:200]}", flush=True)
                else:
                    r = rec["roofline"]
                    m = rec["memory"]
                    print(f"[ok] {tag}: compile={rec['compile_s']}s "
                          f"peak={m['peak_gb_per_chip']}GB "
                          f"dom={r['dominant']} bound={r['bound_s']}s "
                          f"frac={r['roofline_frac']}", flush=True)


if __name__ == "__main__":
    main()
