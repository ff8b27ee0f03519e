"""Fit the route chooser's cost constants from timings (port of
``scripts/autotune_routes.py``).

The route chooser compares a cost model of the byte-LUT gather against the
unpack dot, in units of one dot FMA. ``choose_cuda_route`` (the card's)
reads

    lut_cost = t*M*C*N * pallas_gather_cost + G*M*K * transpose_cost
    dot_cost = t*M*K*N * pallas_dot_cost

and the reference's CPU ``choose_route`` the other keys. This script times
both routes of ``ops.spike_linear`` over a grid of (M, K, N, G) shapes,
solves the model's coefficients by least squares, and writes the result as
an ``ExecutionPlan`` JSON fragment:

    python -m repro_torch.launch.autotune_routes --cuda --weight-dtype int8 \\
        --out build/routes_int8.json
    plan = ExecutionPlan.from_json(open("build/routes_int8.json").read())
    model = compile(params, cfg, plan)

Only the decisions change: every route is bit-exact for int8 weights, so a
bad fit costs time, never correctness. The fragment holds only keys the
reference's ``ExecutionPlan`` has, so it loads in either package.

Without ``--cuda`` the grid times the two plain routes (the analogue of
the reference's CPU routes) on ``--device`` and ``fit_constants`` fits the
CPU chooser's keys, as the reference does. ``--firing-rates 0.1,0.2,0.3``
also times the CPU branch's dense gather against its zero-chunk-skipping
gather on channel-structured spikes (``core.spike.structured_spikes``) at
each rate and fits the sparse route's ``compact_cost``
(``fit_compact_cost``, the reference's fit). ``--cuda`` is the counterpart
of the reference's ``--pallas`` and differs from it in three ways:

- **The unit.** The reference takes its FMA unit from the CPU unpack route.
  On the card that route's counterpart is the plain torch version, no
  yardstick; the unit is the card's own grouped unpack kernel, its dot FMA,
  so ``pallas_dot_cost`` is 1 and the gather is fitted in that unit
  (``fit_cuda_constants``), with ``transpose_cost`` where the samples
  identify it.
- **The weight dtype.** An int8 layer gathers from an int16 table and runs
  its dot on the int8 tensor cores; an f32 layer gathers from an f32 table
  and runs the f32 dot. ``--weight-dtype`` times that dtype's kernels, and
  the fragment is that plan's ``route_constants`` (with its
  ``weight_dtype``): one fit per dtype, no new key.
- **The timing.** Device time: CUDA events around a captured graph of
  ``inner`` launches (``graph_time``). Events around Python calls would
  time the host's launch cost for kernels under ~0.06 ms.

Its grid is the paper config's own layer shapes at batch 8 (conv0-3,
q/k/v/wo, fc1, fc2; ``compile.layer_shape``) and a few neighbours, so the
least squares is identified.

``--profile`` compiles the reduced Spikformer and prints
``CompiledModel.profile_step``'s per-layer table and per-route sums.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..core.spike import num_plane_groups, structured_spikes
from ..core.spikformer import SpikformerConfig, init
from ..device import borrowed_stream, resolve_device
from ..infer.backends import chunk_occupancy
from ..infer.compile import (ExecutionPlan, compile as infer_compile,
                             layer_shape, linear_layer_paths)
from ..kernels import lut_matmul as lut
from ..kernels import ops
from ..kernels.lut_matmul import (RouteConstants, choose_cuda_route,
                                  choose_route)
from ..kernels.spike_matmul import bf16x3_weights, kmajor_weights

# (m, k, n, g) grid of the plain-route fit: the reference's, small shapes
# spanning conv-stem rows x small K through encoder linears; t = 8*g
GRID = [
    (64, 32, 16, 1), (64, 64, 64, 1), (256, 32, 64, 1), (256, 64, 16, 1),
    (512, 32, 32, 1), (512, 64, 64, 1), (1024, 12, 8, 1), (1024, 64, 32, 2),
    (2048, 32, 16, 1), (256, 128, 128, 1),
]
FAST_GRID = GRID[:5]
CUDA_BATCH = 8          # the bucket the paper config's routes are planned at


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_call(fn, *args, repeats: int = 3, inner: int = 4,
              device="cpu") -> float:
    """Best-of-``repeats`` host time of ``inner`` back-to-back calls, each
    batch ended by a barrier on ``device``; one untimed call first."""
    fn(*args)
    _sync(device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn(*args)
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


def graph_time(fn, *, inner: int = 10, repeats: int = 3) -> float:
    """Device seconds per call of ``fn`` (no arguments, on the card): one
    eager call on a borrowed side stream, then ``inner`` calls captured in
    one CUDA graph, replayed ``repeats`` times between two CUDA events; the
    best replay over ``inner``. The host's launch cost stays out. The graph
    is replayed and freed before the stream goes back to the pool."""
    stream = torch.cuda.current_stream()
    with borrowed_stream(stream.device) as side:
        side.wait_stream(stream)
        fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(inner):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        best = float("inf")
        for _ in range(repeats):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / inner)
        stream.wait_stream(side)
        del graph
    return best


def _packed_input(rng, g: int, t: int, m: int, k: int, device):
    """(G, M, K) uint8 plane groups, random bits on the t live planes."""
    x = rng.integers(0, 256, (g, m, k), dtype=np.uint8)
    dead = 8 * g - t
    if dead:
        x[-1] &= np.uint8(0xFF >> dead)
    return torch.from_numpy(x).to(device)


def measure_point(m: int, k: int, n: int, g: int, *, repeats: int = 3,
                  seed: int = 0, device="cpu") -> dict:
    """Host time of the two plain routes (``plain=True``) of one
    (M, K, N, G) shape, f32 weights. Returns a sample."""
    t = 8 * g
    rng = np.random.default_rng(seed)
    x = _packed_input(rng, g, t, m, k, device)
    w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(
        device)
    table = lut.build_lut(w)

    def unpack(xx):
        return ops.spike_linear(xx, w, t=t, route="unpack", plain=True)

    def gather(xx):
        return ops.spike_linear(xx, w, t=t, route="lut", table=table,
                                plain=True)

    return {
        "m": m, "k": k, "n": n, "g": g, "t": t,
        "c": lut.num_k_chunks(k),
        "table_bytes": lut.table_bytes(k, n, False),
        "unpack_s": time_call(unpack, x, repeats=repeats, device=device),
        "lut_s": time_call(gather, x, repeats=repeats, device=device),
    }


def measure_grid(grid=GRID, *, repeats: int = 3, seed: int = 0,
                 device="cpu") -> list:
    samples = []
    for m, k, n, g in grid:
        s = measure_point(m, k, n, g, repeats=repeats, seed=seed,
                          device=device)
        print(json.dumps(s))
        samples.append(s)
    return samples


def measure_sparse_point(m: int, k: int, n: int, g: int, rate: float, *,
                         repeats: int = 3, seed: int = 0,
                         device="cpu") -> dict | None:
    """Host time of the CPU branch's dense gather against its
    zero-chunk-skipping gather on channel-structured spikes at firing rate
    ``rate``. None where the measured chunk occupancy leaves no budget
    headroom (the sparse route would be the dense gather)."""
    t = 8 * g
    gen = torch.Generator(device=device).manual_seed(seed + 1000)
    x = structured_spikes(gen, t=t, shape=(m, k), rate=rate)
    rng = np.random.default_rng(seed + 1)
    w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(
        device)
    table = lut.build_lut(w)
    c = lut.num_k_chunks(k)
    occ = chunk_occupancy(x, t)
    budget = lut.sparse_budget(c, occ)
    if budget >= c:
        return None

    def dense(xx):
        return ops.spike_linear(xx, w, t=t, route="lut", table=table,
                                cpu_branch=True)

    def sparse(xx):
        return ops.spike_linear(xx, w, t=t, route="lut_sparse", table=table,
                                occupancy=occ, cpu_branch=True)

    return {
        "m": m, "k": k, "n": n, "g": g, "t": t, "c": c,
        "rate": rate, "occupancy": round(occ, 4), "budget": budget,
        "table_bytes": lut.table_bytes(k, n, False),
        "lut_s": time_call(dense, x, repeats=repeats, device=device),
        "sparse_s": time_call(sparse, x, repeats=repeats, device=device),
    }


def measure_sparse_grid(grid=GRID, rates=(0.1, 0.2, 0.3), *,
                        repeats: int = 3, seed: int = 0,
                        device="cpu") -> list:
    samples = []
    for m, k, n, g in grid:
        if k % 8:                      # structured spikes need whole chunks
            continue
        for rate in rates:
            s = measure_sparse_point(m, k, n, g, rate, repeats=repeats,
                                     seed=seed, device=device)
            if s is not None:
                print(json.dumps(s))
                samples.append(s)
    return samples


def _lstsq(X, y):
    """Raw least-squares coefficients; callers check signs themselves (a
    negative unit cost means the samples cannot identify the model, and the
    answer is the defaults, not a clamp)."""
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    return coef


def fit_constants(samples: list, *,
                  base: RouteConstants = RouteConstants()) -> RouteConstants:
    """The reference's CPU fit: (gather_cost, transpose_cost, unpack_cost)
    from the plain routes' times, cache constants only when the grid spans
    the cache knee.

    unpack_s ~ alpha*(t*m*k*n) + alpha*unpack_cost*(t*m*k) gives the FMA
    unit ``alpha`` and the unpack write cost; lut_s ~ alpha*gather*(t*m*c*n)
    + alpha*transpose*(g*m*k) reuses the unit. Falls back to ``base`` for
    anything the samples cannot identify."""
    sm = [s for s in samples if s["unpack_s"] > 0 and s["lut_s"] > 0]
    if len(sm) < 3:
        return base

    fma = np.array([s["t"] * s["m"] * s["k"] * s["n"] for s in sm], float)
    wr = np.array([s["t"] * s["m"] * s["k"] for s in sm], float)
    uy = np.array([s["unpack_s"] for s in sm], float)
    a, b = _lstsq(np.stack([fma, wr], 1), uy)
    if not np.isfinite(a) or a <= 0:
        return base
    unpack_cost = float(b / a)

    small = [s for s in sm if s["table_bytes"] <= base.cache_bytes]
    large = [s for s in sm if s["table_bytes"] > base.cache_bytes]

    def fit_lut(subset):
        gath = np.array([s["t"] * s["m"] * s["c"] * s["n"] for s in subset],
                        float)
        tr = np.array([s["g"] * s["m"] * s["k"] for s in subset], float)
        ly = np.array([s["lut_s"] for s in subset], float)
        gc, tc = _lstsq(np.stack([gath, tr], 1), ly)
        return float(gc / a), float(tc / a)

    gather_cost, transpose_cost = fit_lut(small if len(small) >= 2 else sm)
    cache_penalty = base.cache_penalty
    if len(large) >= 2 and len(small) >= 2:
        g_large, _ = fit_lut(large)
        if gather_cost > 0:
            cache_penalty = float(np.clip(g_large / gather_cost, 1.0, 16.0))

    def clip(v, lo, hi, dflt):
        return float(np.clip(v, lo, hi)) if np.isfinite(v) and v > 0 else dflt

    return dataclasses.replace(
        base,
        gather_cost=clip(gather_cost, 0.1, 64.0, base.gather_cost),
        transpose_cost=clip(transpose_cost, 0.1, 64.0, base.transpose_cost),
        unpack_cost=clip(unpack_cost, 0.1, 256.0, base.unpack_cost),
        cache_penalty=cache_penalty)


def fit_compact_cost(samples: list, sparse_samples: list, *,
                     base: RouteConstants) -> RouteConstants:
    """The reference's fit of the sparse route's per-(index byte x slot)
    compaction cost, every other constant pinned by ``base`` (the dense
    fit):

        sparse_s ~ alpha * [t*m*budget*n*gather_cost*cache_penalty
                            + g*m*k*transpose_cost + t*m*c*budget*compact]

    with the FMA unit ``alpha`` re-derived from the unpack samples as in
    ``fit_constants``; the residual over the compaction volume is a
    one-coefficient least squares. Falls back to ``base`` where the
    samples cannot identify a positive cost."""
    sm = [s for s in samples if s["unpack_s"] > 0 and s["lut_s"] > 0]
    if len(sparse_samples) < 2 or len(sm) < 3:
        return base
    fma = np.array([s["t"] * s["m"] * s["k"] * s["n"] for s in sm], float)
    wr = np.array([s["t"] * s["m"] * s["k"] for s in sm], float)
    uy = np.array([s["unpack_s"] for s in sm], float)
    alpha, _ = _lstsq(np.stack([fma, wr], 1), uy)
    if not np.isfinite(alpha) or alpha <= 0:
        return base
    resid, vol = [], []
    for s in sparse_samples:
        pen = (1.0 if s["table_bytes"] <= base.cache_bytes
               else base.cache_penalty)
        gather = (s["t"] * s["m"] * s["budget"] * s["n"]
                  * base.gather_cost * pen)
        transpose = s["g"] * s["m"] * s["k"] * base.transpose_cost
        resid.append(s["sparse_s"] / alpha - gather - transpose)
        vol.append(s["t"] * s["m"] * s["c"] * s["budget"])
    compact, = _lstsq(np.array(vol, float)[:, None], np.array(resid, float))
    if not np.isfinite(compact) or compact <= 0:
        return base
    return dataclasses.replace(
        base, compact_cost=float(np.clip(compact, 1.0, 256.0)))


def sparse_agreement(samples: list, constants: RouteConstants) -> str:
    """How many sparse samples ``choose_route`` sends to the faster of the
    dense and the sparse gather."""
    agree = sum((choose_route(m=s["m"], k=s["k"], n=s["n"], g=s["g"],
                              t=s["t"], constants=constants,
                              occupancy=s["occupancy"]) == "lut_sparse")
                == (s["sparse_s"] < s["lut_s"]) for s in samples)
    return f"{agree}/{len(samples)}"


def layer_dims(cfg: SpikformerConfig, path: str) -> tuple:
    """(K, N) of the folded kernel at ``path``."""
    if path.startswith("scs/conv"):
        i = int(path.removeprefix("scs/conv"))
        cin = cfg.in_channels if i == 0 else cfg.scs_channels[i - 1]
        return 4 * cin, cfg.scs_channels[i]
    hidden = cfg.dim * cfg.mlp_ratio
    return {"fc1": (cfg.dim, hidden), "fc2": (hidden, cfg.dim)}.get(
        path.rsplit("/", 1)[-1], (cfg.dim, cfg.dim))


def cuda_grid(cfg: SpikformerConfig | None = None, *,
              batch: int = CUDA_BATCH, fast: bool = False) -> list:
    """(m, k, n, g, t) points: the distinct layer shapes of one forward of
    ``cfg`` (default: the paper config) at ``batch`` (every block has
    block 0's), then, unless ``fast``, neighbours that vary M, K and N
    apart so the least squares is identified."""
    cfg = SpikformerConfig() if cfg is None else cfg
    points = []
    for path in linear_layer_paths(cfg):
        if path.startswith("blocks/") and not path.startswith("blocks/b0/"):
            continue
        m, t, g = layer_shape(cfg, path, batch)
        p = (m, *layer_dims(cfg, path), g, t)
        if p not in points:
            points.append(p)
    if not fast:
        m, d, t = batch * cfg.tokens, cfg.dim, cfg.timesteps
        g = num_plane_groups(t)
        points += [(m // 2, d, d, g, t), (2 * m, d // 2, d, g, t),
                   (m, d, d // 4, g, t), (m, d // 4, d, g, t),
                   (m, 2 * d, 2 * d, g, t)]
    return points


def measure_cuda_point(m: int, k: int, n: int, g: int, t: int, *,
                       weight_dtype: str = "int8", repeats: int = 3,
                       inner: int = 10, seed: int = 0) -> dict:
    """Device time of the card's two routes for one shape: the gather
    kernel over the layer's table (int16 for int8 weights, f32 for f32)
    and the grouped unpack dot (the int8 tensor-core kernel over the
    K-major copy the planner makes, or the bf16 one over the f32 weights'
    three-term split), both through
    ``ops.spike_linear`` as the step calls them."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    x = _packed_input(rng, g, t, m, k, dev)
    if weight_dtype == "int8":
        w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    else:
        w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
    w = w.to(dev)
    table = lut.build_lut(w)
    # the unpack dot's B operand as the planner builds it
    kmajor = kmajor_weights(w) if weight_dtype == "int8" else None
    split = None if weight_dtype == "int8" else bf16x3_weights(w)
    lut_s = graph_time(lambda: ops.spike_linear(
        x, w, t=t, route="lut", table=table), inner=inner, repeats=repeats)
    dot_s = graph_time(lambda: ops.spike_linear(
        x, w, t=t, route="unpack", w_kmajor=kmajor, w_bf16x3=split),
        inner=inner, repeats=repeats)
    return {"m": m, "k": k, "n": n, "g": g, "t": t,
            "c": lut.num_k_chunks(k), "weight_dtype": weight_dtype,
            "table_bytes": lut.table_bytes(k, n, weight_dtype == "int8"),
            "cuda_lut_s": lut_s, "cuda_dot_s": dot_s}


def measure_cuda_grid(grid, *, weight_dtype: str = "int8", repeats: int = 3,
                      inner: int = 10, seed: int = 0) -> list:
    samples = []
    for m, k, n, g, t in grid:
        s = measure_cuda_point(m, k, n, g, t, weight_dtype=weight_dtype,
                               repeats=repeats, inner=inner, seed=seed)
        print(json.dumps(s), flush=True)
        samples.append(s)
    return samples


def fit_cuda_constants(samples: list, *,
                       base: RouteConstants = RouteConstants()
                       ) -> RouteConstants:
    """``choose_cuda_route``'s constants from the card's kernel times, in
    the unit of the grouped unpack kernel's dot FMA: ``alpha`` (seconds per
    FMA) from ``cuda_dot_s ~ alpha*(t*m*k*n)``, so ``pallas_dot_cost`` is
    1; then ``cuda_lut_s / alpha ~ pallas_gather_cost*(t*m*c*n) +
    transpose_cost*(g*m*k)``. Where that two-term fit gives a non-positive
    term, ``transpose_cost`` stays ``base``'s and the gather is a
    one-coefficient fit of the rest. Falls back to ``base`` where the
    samples cannot identify a positive unit."""
    sm = [s for s in samples if s["cuda_lut_s"] > 0 and s["cuda_dot_s"] > 0]
    if len(sm) < 2:
        return base
    dvol = np.array([s["t"] * s["m"] * s["k"] * s["n"] for s in sm], float)
    dy = np.array([s["cuda_dot_s"] for s in sm], float)
    alpha, = _lstsq(dvol[:, None], dy)
    if not np.isfinite(alpha) or alpha <= 0:
        return base
    gvol = np.array([s["t"] * s["m"] * s["c"] * s["n"] for s in sm], float)
    tvol = np.array([s["g"] * s["m"] * s["k"] for s in sm], float)
    ly = np.array([s["cuda_lut_s"] for s in sm], float) / alpha
    gc, tc = (_lstsq(np.stack([gvol, tvol], 1), ly) if len(sm) >= 3
              else (np.nan, np.nan))
    if not (np.isfinite(gc) and np.isfinite(tc) and gc > 0 and tc > 0):
        tc = base.transpose_cost
        gc, = _lstsq(gvol[:, None], ly - tvol * tc)

    def clip(v, dflt):
        return (float(np.clip(v, 0.05, 4096.0)) if np.isfinite(v) and v > 0
                else dflt)

    return dataclasses.replace(
        base, pallas_gather_cost=clip(gc, base.pallas_gather_cost),
        pallas_dot_cost=1.0,
        transpose_cost=clip(tc, base.transpose_cost))


def cuda_agreement(samples: list, constants: RouteConstants) -> str:
    """How many samples the fitted chooser sends to the faster route."""
    agree = sum((choose_cuda_route(m=s["m"], k=s["k"], n=s["n"], g=s["g"],
                                   t=s["t"], constants=constants) == "lut")
                == (s["cuda_lut_s"] < s["cuda_dot_s"]) for s in samples)
    return f"{agree}/{len(samples)}"


def route_sums(rows: list) -> dict:
    """``profile_step`` rows summed by route: layers, seconds, share."""
    total = sum(r["seconds"] for r in rows) or 1.0
    sums: dict = {}
    for r in rows:
        agg = sums.setdefault(r["route"], {"layers": 0, "seconds": 0.0})
        agg["layers"] += 1
        agg["seconds"] += r["seconds"]
    for agg in sums.values():
        agg["share"] = agg["seconds"] / total
    return dict(sorted(sums.items()))


def plan_fragment(constants: RouteConstants,
                  weight_dtype: str | None = None) -> dict:
    """The committable result: an ``ExecutionPlan`` fragment of the fitted
    constants (and, for a ``--cuda`` fit, the weight dtype they were
    fitted for), which ``ExecutionPlan.from_json`` of either package
    accepts."""
    fragment = {"route_constants": constants.to_dict()}
    if weight_dtype is not None:
        fragment["weight_dtype"] = weight_dtype
    return fragment


def profile_model(*, batch: int = 2, seed: int = 0, device=None,
                  weight_dtype: str = "int8") -> list:
    """Compile the reduced Spikformer (seeded ``init``) on ``device`` and
    print ``profile_step``'s per-layer table and per-route sums. Returns
    the rows."""
    cfg = SpikformerConfig().scaled()
    params = init(torch.Generator().manual_seed(seed), cfg)
    model = infer_compile(params, cfg, ExecutionPlan(
        batch_buckets=(batch,), weight_dtype=weight_dtype), device=device,
        jit=False)
    rows = model.profile_step()
    for r in rows:
        print(json.dumps(r))
    print(json.dumps({"profile_batch": batch, "layers": len(rows),
                      "device": str(model.device),
                      "total_s": sum(r["seconds"] for r in rows),
                      "per_route": route_sums(rows)}, indent=1))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--fast", action="store_true",
                    help="a smaller grid and fewer repeats (smoke runs)")
    ap.add_argument("--profile", action="store_true",
                    help="print CompiledModel.profile_step's per-layer table "
                         "of the reduced model instead of fitting")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cuda", action="store_true",
                    help="time the card's kernel pair and fit "
                         "choose_cuda_route's constants (needs the card)")
    ap.add_argument("--weight-dtype", choices=("int8", "float32"),
                    default="int8",
                    help="with --cuda: whose kernels to time")
    ap.add_argument("--device", default=None,
                    help="where the plain-route fit and --profile run "
                         "(default: the card)")
    ap.add_argument("--firing-rates", default=None,
                    help="comma-separated firing rates (e.g. 0.1,0.2,0.3): "
                         "also time the zero-chunk-skipping gather on "
                         "structured spikes and fit compact_cost (not with "
                         "--cuda: the card's gather is dense)")
    ap.add_argument("--out", default=None,
                    help="write the ExecutionPlan JSON fragment here "
                         "(stdout always gets it)")
    args = ap.parse_args(argv)
    repeats = args.repeats or (2 if args.fast else 3)

    if args.profile:
        return profile_model(seed=args.seed, device=args.device)

    if args.cuda:
        resolve_device("cuda")
        grid = cuda_grid(fast=args.fast)
        samples = measure_cuda_grid(grid, weight_dtype=args.weight_dtype,
                                    repeats=repeats,
                                    inner=5 if args.fast else 10,
                                    seed=args.seed)
        constants = fit_cuda_constants(samples)
        fragment = plan_fragment(constants, args.weight_dtype)
        summary = {"cuda_points": len(samples),
                   "cuda_agreement": cuda_agreement(samples, constants),
                   "device": torch.cuda.get_device_name()}
    else:
        device = resolve_device(args.device)
        grid = FAST_GRID if args.fast else GRID
        samples = measure_grid(grid, repeats=repeats, seed=args.seed,
                               device=device)
        constants = fit_constants(samples)
        summary = {"grid_points": len(samples), "device": str(device)}
        if args.firing_rates:
            rates = tuple(float(r) for r in args.firing_rates.split(","))
            sparse = measure_sparse_grid(grid, rates, repeats=repeats,
                                         seed=args.seed, device=device)
            constants = fit_compact_cost(samples, sparse, base=constants)
            summary.update(sparse_points=len(sparse),
                           sparse_agreement=sparse_agreement(sparse,
                                                             constants))
        fragment = plan_fragment(constants)

    text = json.dumps(fragment, indent=1, sort_keys=True)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(json.dumps(summary))
    return constants


if __name__ == "__main__":
    main()
