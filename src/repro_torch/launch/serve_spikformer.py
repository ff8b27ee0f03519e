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

  python -m repro_torch.launch.serve_spikformer --events --smoke \\
      [--trace benchmarks/traces/dvs_synth_mini.jsonl]
      # the event-stream workload: a DVS trace's windows replayed as count
      # frames at their recorded times through the runtime (or a fleet);
      # --smoke replays it twice and gates zero sheds, SLO attainment 1.0
      # and equal labels

The weights are the port's seeded ``init``: untrained, so the logits are
all zero and every label is 0 (the IAND residual stream falls silent, as
under the reference's ``init``). ``main_closed``, ``main_async`` and
``main_events`` take a prebuilt model, for callers that serve weights of
their own. Every mode runs the reference's default plan unless the flags
say otherwise: backend ``packed``, which runs the kernels on the card and
the reference's CPU branch on the CPU.
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


class SpikformerEngine(MicroBatchEngine):
    """Micro-batching classifier built straight from training params: the
    reference's pre-split constructor, now ``compile`` + ``MicroBatchEngine``
    on ``device`` (default: the card)."""

    def __init__(self, params, cfg: SpikformerConfig, *, batch_size: int = 8,
                 buckets=None, backend: str = "packed",
                 weight_dtype: str | None = None, device=None):
        plan = ExecutionPlan(backend=backend, weight_dtype=weight_dtype,
                             batch_buckets=buckets or (batch_size,))
        super().__init__(compile(params, cfg, plan, device=device))

    @property
    def session(self):
        """The compiled model (named for the pre-split attribute)."""
        return self.model


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
                    choices=["packed", "packed_cuda", "packed_plain",
                             "reference"],
                    help="default packed, the reference's default: the "
                         "kernels on the card, the reference's CPU branch "
                         "on the CPU")
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
                    help="serve the event-stream workload: replay a DVS "
                         "trace (--trace, or a synthesized one) through "
                         "the serving stack as per-window count frames")
    ap.add_argument("--trace", default=None,
                    help="events: path to a recorded JSONL event trace "
                         "(the events.trace format); the model is compiled "
                         "to the trace header's sensor shape")
    ap.add_argument("--trace-out", default=None,
                    help="write the request-lifecycle trace here as span "
                         "JSONL (a Perfetto-loadable .perfetto.json lands "
                         "next to it); works in every mode")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke gate: few requests, assert completion")
    return ap.parse_args(argv)


def plan_from_args(args) -> ExecutionPlan:
    """A committed ``--plan`` as it is, else the reference's default plan
    (backend ``packed``, buckets (2, 8)); explicit flags (only) override
    either."""
    if args.plan:
        with open(args.plan) as f:
            plan = ExecutionPlan.from_json(f.read())
    else:
        plan = ExecutionPlan(backend="packed", batch_buckets=(2, 8))
    over = {}
    if args.backend is not None:
        over["backend"] = args.backend
    if args.buckets is not None:
        over["batch_buckets"] = tuple(int(b) for b in args.buckets.split(","))
    if args.weight_dtype is not None:
        over["weight_dtype"] = args.weight_dtype
    return dataclasses.replace(plan, **over) if over else plan


def build_model(args, cfg: SpikformerConfig | None = None):
    """The seeded model of ``cfg`` (default: the paper's, or the reduced
    one under ``--reduce``) under the plan the flags give, warmed (every
    bucket's graph captured); returns ``(model, warmup seconds)``."""
    if cfg is None:
        cfg = SpikformerConfig()
        if args.reduce:
            cfg = cfg.scaled()
    params = spik_init(torch.Generator().manual_seed(args.seed), cfg)
    model = compile(params, cfg, plan_from_args(args),
                    device=args.device)
    return model, model.warmup()


def main(argv=None):
    args = parse_args(argv)
    if args.smoke:
        args.requests = min(args.requests, 5)
        args.images_per_request = min(args.images_per_request, 2)
        args.rps = min(args.rps, 60.0)
        args.duration = min(args.duration, 1.5)
    if args.events or args.trace:
        return main_events(args)
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


def synth_event_trace(*, seed: int, height: int = 16, width: int = 16):
    """A deterministic in-memory trace when no --trace is given: a moving
    edge plus flicker bursts, windowed exactly as
    ``launch/record_event_trace.py`` commits its fixture."""
    from ..events import (EventTrace, TraceArrival, flicker_burst_events,
                          merge_streams, moving_edge_events)
    window_us = 20_000
    duration_us = 800_000
    stream = merge_streams(
        moving_edge_events(height=height, width=width,
                           duration_us=duration_us // 4, seed=seed),
        flicker_burst_events(height=height, width=width,
                             duration_us=duration_us, seed=seed + 1,
                             bursts=3))
    arrivals = []
    for w in range(duration_us // window_us):
        ev = stream.slice_time(w * window_us, (w + 1) * window_us)
        if len(ev):
            arrivals.append(TraceArrival(
                t_s=(w + 1) * window_us / 1e6, window=w,
                events=ev.shift_time(-w * window_us)))
    return EventTrace(height=height, width=width, window_us=window_us,
                      bins=8, payload="events", arrivals=tuple(arrivals))


def event_trace(args):
    """The trace ``--trace`` names, else the synthetic one of ``--seed``."""
    from ..events import load_trace
    return (load_trace(args.trace) if args.trace
            else synth_event_trace(seed=args.seed))


def event_config(trace) -> SpikformerConfig:
    """The reference's event config for ``trace``'s sensor:
    ``scaled(img_size=H, dim=32, depth=1)`` with the trace's channels."""
    if trace.height != trace.width:
        raise SystemExit(
            f"trace sensor is {trace.height}x{trace.width}; the Spikformer "
            f"front end serves square inputs — re-record or crop")
    return dataclasses.replace(
        SpikformerConfig().scaled(img_size=trace.height, dim=32, depth=1),
        in_channels=trace.channels)


def main_events(args, model=None, compile_s: float = 0.0):
    """Event-stream serving: replay a DVS trace's windows (count frames at
    the recorded arrival times) through the runtime or fleet, on
    ``model``, or else the seeded model of ``event_config(trace)`` under
    the flags' plan (by default the reference's: backend ``packed``,
    buckets (2, 8)); in --smoke, replay it TWICE and assert the labels are
    bit-identical (the trace-replay determinism contract). Returns the
    printed summary plus the per-arrival ``labels``, every run's metrics
    under ``runs`` and the model under ``model``."""
    from ..events import replay_trace
    trace = event_trace(args)
    cfg = event_config(trace)
    if model is None:
        model, compile_s = build_model(args, cfg)
    elif model.input_shape()[1:] != (trace.height, trace.width,
                                     trace.channels):
        raise ValueError(f"the model takes {model.input_shape()[1:]}, the "
                         f"trace's sensor is {trace.height}x{trace.width}"
                         f"x{trace.channels}")
    policy = ServePolicy(max_wait_ms=args.max_wait_ms, slo_ms=args.slo_ms,
                         max_queue_images=args.queue_depth)

    def run_once(tracer=None):
        if args.replicas > 1:
            client = ServeFleet(model, replicas=args.replicas, policy=policy,
                                pace_fps=args.pace_fps, tracer=tracer)
        else:
            client = AsyncServeRuntime(model, policy=policy, tracer=tracer)
        with client:
            metrics = replay_trace(trace, client, slo_ms=args.slo_ms)
        metrics["runtime"] = client.stats()
        return metrics

    tracer = make_tracer(args)
    metrics = run_once(tracer)
    if tracer is not None:
        dump_trace(tracer, args.trace_out,
                   meta={"mode": "events", "replicas": args.replicas})
    summary = {
        "backend": model.plan.backend,
        "weight_dtype": model.weight_dtype,
        "compile_s": round(compile_s, 3),
        "mode": "event_replay",
        "trace": args.trace or "synthetic",
        "sensor": [trace.height, trace.width, trace.channels],
        "window_us": trace.window_us,
        "replicas": args.replicas,
        **{k: v for k, v in metrics.items() if k != "labels"},
    }
    print(json.dumps(summary))
    runs = [metrics]

    if args.smoke:
        # the event-serving smoke contract: every window served (zero
        # drops, zero shed at smoke rates), on time, and deterministically
        assert metrics["requests_dropped"] == 0, summary
        assert metrics["requests_rejected"] == 0, summary
        assert metrics["slo_attainment"] == 1.0, summary
        n_classes = model.cfg.num_classes
        for labs in metrics["labels"]:
            assert labs is not None and len(labs) == 1, labs
            assert 0 <= labs[0] < n_classes, labs
        replay = run_once()
        runs.append(replay)
        assert replay["labels_sha"] == metrics["labels_sha"], (
            "trace replay is not deterministic",
            replay["labels_sha"], metrics["labels_sha"])
        print(json.dumps({"smoke": "ok", "mode": "event_replay",
                          "windows": metrics["windows"],
                          "replicas": args.replicas,
                          "labels_sha": metrics["labels_sha"],
                          "slo_attainment": metrics["slo_attainment"],
                          "dispersion_index": metrics["dispersion_index"]}))
    summary.update(labels=metrics["labels"], runs=runs, model=model)
    return summary


if __name__ == "__main__":
    main()
