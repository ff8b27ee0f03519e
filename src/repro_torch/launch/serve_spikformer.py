"""Spikformer image-classification serving driver (port of
``repro.launch.serve_spikformer``) — a thin CLI over the compile/serve
split: ``repro_torch.infer.compile`` builds the multi-bucket
``CompiledModel`` on the card (one CUDA graph a bucket), then either
``MicroBatchEngine`` drains a closed-loop request queue through it
(default) or — with ``--async`` — ``repro_torch.serve.AsyncServeRuntime``
(or a ``ServeFleet`` of ``--replicas``) serves an OPEN-LOOP Poisson arrival
process at ``--rps`` for ``--duration`` seconds under an ``--slo-ms``
latency target. VESTA sustains ~30 fps on Spikformer V2; the closed loop
reports achieved fps against that target, the open loop what a drain
cannot — goodput, p99 latency and SLO attainment under live load.

  python -m repro_torch.launch.serve_spikformer --requests 12 --buckets 1,8

  python -m repro_torch.launch.serve_spikformer --async --rps 60 \\
      --duration 3 --slo-ms 100 --weight-dtype int8

  PYTHONPATH=src python -m repro_torch.launch.serve_spikformer --reduce \\
      --device cpu --smoke
      # the smoke gate: a handful of requests, asserts all complete with
      # labels in range; with --async, asserts the open loop sustains
      # >= 30 fps with zero dropped-but-accepted requests

The weights are the port's seeded ``init``: untrained, so the logits are
all zero and every label is 0 (the IAND residual stream falls silent, as
under the reference's ``init``). ``main_closed`` and ``main_async`` take a
prebuilt model, for callers that serve weights of their own.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..core.spikformer import SpikformerConfig, init as spik_init
from ..infer import ExecutionPlan, MicroBatchEngine, PAPER_FPS, compile
from ..infer.engine import Request
from ..obs import Tracer, write_chrome_trace, write_spans_jsonl
from ..serve import (AsyncServeRuntime, ServeFleet, ServePolicy,
                     image_maker, poisson_trace, run_open_loop)

# the engine's Request, under the driver's historical name
ImageRequest = Request

EVENTS_NOT_PORTED = (
    "--events and --trace serve the event-stream workload, which is not "
    "ported yet (ROADMAP.md, section 1: Events)")


def make_tracer(args):
    """One ``Tracer`` when ``--trace-out`` asks for a trace, else None —
    clients built with ``tracer=None`` run the NULL_TRACER fast path."""
    return Tracer() if args.trace_out else None


def dump_trace(tracer, path, *, meta=None):
    """Write the span JSONL plus the Perfetto sibling (``.perfetto.json``
    next to the JSONL); prints where they landed and how lossy the ring
    was. Returns the summary row."""
    n = write_spans_jsonl(path, tracer, meta=meta)
    perfetto = (path[:-len(".jsonl")] + ".perfetto.json"
                if path.endswith(".jsonl") else path + ".perfetto.json")
    write_chrome_trace(perfetto, tracer)
    row = {"trace_out": path, "perfetto": perfetto, "spans": n,
           "dropped_spans": tracer.dropped_spans}
    print(json.dumps(row))
    return row


def parse_args(argv=None) -> argparse.Namespace:
    """The driver's flags, unclamped (``main`` applies ``--smoke``'s
    limits)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reduce", action="store_true",
                    help="reduced config (32x32, dim 64, depth 2)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; fails without "
                         "one); 'cpu' runs the kernels' plain versions")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--images-per-request", type=int, default=3)
    ap.add_argument("--buckets", default=None,
                    help="comma-separated static batch buckets (default "
                         "2,8); the engine picks the cheapest per step")
    ap.add_argument("--backend", default=None,
                    choices=["packed_cuda", "packed_plain", "reference"],
                    help="default packed_cuda")
    ap.add_argument("--weight-dtype", default=None,
                    choices=["float32", "int8"])
    ap.add_argument("--plan", default=None,
                    help="load a committed ExecutionPlan JSON, the port's or "
                         "the reference's (backend/buckets flags still "
                         "override)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="serve an open-loop Poisson arrival process through "
                         "AsyncServeRuntime instead of the closed-loop drain")
    ap.add_argument("--rps", type=float, default=60.0,
                    help="async: offered arrival rate, requests/second")
    ap.add_argument("--duration", type=float, default=3.0,
                    help="async: seconds of open-loop arrivals")
    ap.add_argument("--slo-ms", type=float, default=100.0,
                    help="async: per-request latency target")
    ap.add_argument("--max-wait-ms", type=float, default=10.0,
                    help="async: continuous-batching window")
    ap.add_argument("--queue-depth", type=int, default=512,
                    help="async: admission bound, queued images")
    ap.add_argument("--replicas", type=int, default=1,
                    help="async: serve through a ServeFleet of this many "
                         "replicas (one per card on a multi-card host, "
                         "thread-backed otherwise); 1 = single runtime")
    ap.add_argument("--pace-fps", type=float, default=None,
                    help="fleet: model each replica as a fixed-rate core "
                         "at this many images/second (labels stay real)")
    ap.add_argument("--events", action="store_true",
                    help="the event-stream workload (not ported yet)")
    ap.add_argument("--trace", default=None,
                    help="events: a recorded event trace (not ported yet)")
    ap.add_argument("--trace-out", default=None,
                    help="write the request-lifecycle trace here as span "
                         "JSONL (a Perfetto-loadable .perfetto.json lands "
                         "next to it); works in every mode")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke gate: few requests, assert completion")
    return ap.parse_args(argv)


def build_model(args):
    """The seeded model under the plan the flags give, warmed (every
    bucket's graph captured); returns ``(model, warmup seconds)``."""
    cfg = SpikformerConfig()
    if args.reduce:
        cfg = cfg.scaled()
    params = spik_init(torch.Generator().manual_seed(args.seed), cfg)
    # a committed --plan replays as-is; explicit flags (only) override it
    if args.plan:
        with open(args.plan) as f:
            plan = ExecutionPlan.from_json(f.read())
    else:
        plan = ExecutionPlan(batch_buckets=(2, 8))
    over = {}
    if args.backend is not None:
        over["backend"] = args.backend
    if args.buckets is not None:
        over["batch_buckets"] = tuple(int(b) for b in args.buckets.split(","))
    if args.weight_dtype is not None:
        over["weight_dtype"] = args.weight_dtype
    if over:
        plan = dataclasses.replace(plan, **over)
    model = compile(params, cfg, plan, device=args.device)
    return model, model.warmup()


def main(argv=None):
    args = parse_args(argv)
    if args.events or args.trace:
        raise NotImplementedError(EVENTS_NOT_PORTED)
    if args.smoke:
        args.requests = min(args.requests, 5)
        args.images_per_request = min(args.images_per_request, 2)
        args.rps = min(args.rps, 60.0)
        args.duration = min(args.duration, 1.5)
    model, compile_s = build_model(args)
    if args.use_async:
        return main_async(model, args, compile_s)
    return main_closed(model, args, compile_s)


def main_closed(model, args, compile_s: float):
    """Closed loop: ``--requests`` requests of ``--images-per-request``
    seeded images each, drained through ``MicroBatchEngine``. Returns the
    printed summary plus the engine under ``client``."""
    tracer = make_tracer(args)
    eng = MicroBatchEngine(model, tracer=tracer)
    cfg = model.cfg
    rng = np.random.default_rng(args.seed + 1)
    for i in range(args.requests):
        imgs = rng.integers(0, 256, (args.images_per_request, cfg.img_size,
                                     cfg.img_size, cfg.in_channels),
                            dtype=np.uint8)
        eng.submit(ImageRequest(rid=i, images=imgs))

    done = eng.run()
    stats = eng.stats()
    if tracer is not None:
        dump_trace(tracer, args.trace_out, meta={"mode": "sync"})
    summary = {
        "backend": model.plan.backend,
        "weight_dtype": model.weight_dtype,
        "compile_s": round(compile_s, 3),
        **stats,
    }
    print(json.dumps(summary))

    if args.smoke:
        # the smoke contract: every request completed, every label
        # well-formed
        assert len(done) == args.requests, (len(done), args.requests)
        for req in done:
            assert len(req.labels) == len(req.images)
            assert all(isinstance(lab, int)
                       and 0 <= lab < cfg.num_classes for lab in req.labels)
        assert stats["images"] == args.requests * args.images_per_request
        print(json.dumps({"smoke": "ok", "requests": len(done),
                          "pad_waste": stats["pad_waste"]}))
    summary["client"] = eng
    return summary


def main_async(model, args, compile_s: float):
    """Open-loop serving: Poisson arrivals at --rps for --duration seconds
    through ``AsyncServeRuntime`` (or a ``ServeFleet`` of ``--replicas``),
    measured by ``repro_torch.serve.loadgen``. Returns the printed
    summary plus the closed client under ``client`` and the arrival trace
    under ``trace``."""
    policy = ServePolicy(max_wait_ms=args.max_wait_ms, slo_ms=args.slo_ms,
                         max_queue_images=args.queue_depth)
    trace = poisson_trace(rps=args.rps, duration_s=args.duration,
                          seed=args.seed + 1,
                          images_per_request=(1, args.images_per_request))
    tracer = make_tracer(args)
    if args.replicas > 1:
        client = ServeFleet(model, replicas=args.replicas, policy=policy,
                            pace_fps=args.pace_fps, tracer=tracer)
    else:
        client = AsyncServeRuntime(model, policy=policy, tracer=tracer)
    with client:
        metrics = run_open_loop(
            client, trace, image_maker(model.input_shape()[1:],
                                       seed=args.seed + 2),
            slo_ms=args.slo_ms)
    if tracer is not None:
        dump_trace(tracer, args.trace_out,
                   meta={"mode": "fleet" if args.replicas > 1 else "async",
                         "replicas": args.replicas})
    summary = {
        "backend": model.plan.backend,
        "weight_dtype": model.weight_dtype,
        "compile_s": round(compile_s, 3),
        "mode": ("fleet_open_loop" if args.replicas > 1
                 else "async_open_loop"),
        "replicas": args.replicas,
        "paper_fps": PAPER_FPS,
        **metrics,
        "runtime": client.stats(),
    }
    if args.replicas > 1:
        summary["health"] = client.health()
    print(json.dumps(summary))

    if args.smoke:
        # the open loop's smoke contract: an accepted request is a promise
        # (zero dropped), labels are well-formed, and the paper's real-time
        # rate is sustained at the smoke arrival rate
        assert metrics["requests_dropped"] == 0, metrics
        assert metrics["requests_offered"] == len(trace)
        # smoke offers at most rps*duration requests against a 512-image
        # admission bound: a rejection here is a real bug
        assert metrics["requests_rejected"] == 0, metrics
        n_classes = model.cfg.num_classes
        for req in client.done:
            assert len(req.labels) == len(req.images)
            assert all(isinstance(lab, int) and 0 <= lab < n_classes
                       for lab in req.labels)
        assert metrics["completed_fps"] >= PAPER_FPS, metrics
        if args.replicas > 1:
            # fleet floor: N replicas sustain N x the single-replica
            # real-time rate, and the fleet kept every promise
            assert metrics["goodput_fps"] >= args.replicas * PAPER_FPS, \
                metrics
            health = client.health()
            assert all(r["failures"] == 0 for r in health["replicas"]), \
                health
        print(json.dumps({"smoke": "ok", "mode": summary["mode"],
                          "replicas": args.replicas,
                          "completed_fps": metrics["completed_fps"],
                          "goodput_fps": metrics["goodput_fps"],
                          "slo_attainment": metrics["slo_attainment"]}))
    summary["client"] = client
    summary["trace"] = trace
    return summary


if __name__ == "__main__":
    main()
