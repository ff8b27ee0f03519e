"""Where the events CLI's SLO misses come from: ``serve_spikformer``'s
event replay (``--events --smoke``: the synthetic trace and the committed
fixture, the reference's event config on the ``packed`` plan, buckets
(2, 8), graphed), run many times in one process, each window's latency
logged beside a timeline of model builds, graph captures and Python's
cyclic-collector passes (``gc.callbacks``).

    python3 scripts/events_slo_probe.py [--runs 12] [--ballast 0,4000000]
        [--device cpu]

Each run builds the model as the CLI does (``build_model``: compile, then
a capture a bucket) and replays the trace twice, as ``--smoke`` does,
through a fresh ``AsyncServeRuntime``. ``--ballast N`` holds up to N
long-lived Python objects (dicts in a list), a share more before each
run, as the smoke's earlier phases grow its heap, so that the collector's
full passes come and take as long as they do there; each value is one
round of runs. Prints the card's name and
power limit, then one JSON line a run: SLO attainment, p50/p99/max
window latency, the windows over the SLO with every collector pass and
capture that overlaps them, and the collector passes inside the replay
(count, total and longest ms, by generation); then a summary line a
ballast. Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import device as device_mod  # noqa: E402
from repro_torch.events import trace_to_load  # noqa: E402
from repro_torch.launch import serve_spikformer as cli  # noqa: E402
from repro_torch.serve import AsyncServeRuntime, ServePolicy  # noqa: E402
from repro_torch.serve.loadgen import run_open_loop  # noqa: E402

TRACE = ROOT / "benchmarks" / "traces" / "dvs_synth_mini.jsonl"


class Timeline:
    """Collector passes (``gc.callbacks``) and graph captures
    (``device.GraphCapturer.__call__``), each as (kind, t0, t1, info)."""

    def __init__(self):
        self.events: list = []
        self._gc_t0 = None
        self._real_capture = device_mod.GraphCapturer.__call__

    def _gc(self, phase, info):
        now = time.perf_counter()
        if phase == "start":
            self._gc_t0 = now
        elif self._gc_t0 is not None:
            self.events.append(("gc", self._gc_t0, now,
                                {"generation": info["generation"],
                                 "collected": info["collected"]}))
            self._gc_t0 = None

    def __enter__(self):
        gc.callbacks.append(self._gc)
        real = self._real_capture
        events = self.events

        def capture(capturer, body, what):
            t0 = time.perf_counter()
            try:
                return real(capturer, body, what)
            finally:
                events.append(("capture", t0, time.perf_counter(),
                               {"what": what}))

        device_mod.GraphCapturer.__call__ = capture
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        device_mod.GraphCapturer.__call__ = self._real_capture

    def between(self, t0, t1, kind=None):
        return [e for e in self.events if e[1] < t1 and e[2] > t0
                and (kind is None or e[0] == kind)]


def replay(model, trace, args, timeline):
    """One replay through a fresh runtime: per-window (submit, done,
    latency) on the host clock, and the run's metrics."""
    arrivals, make_images = trace_to_load(trace)
    policy = ServePolicy(max_wait_ms=args.max_wait_ms, slo_ms=args.slo_ms,
                         max_queue_images=args.queue_depth)
    handles = {}
    with AsyncServeRuntime(model, policy=policy) as client:
        t0 = time.perf_counter()
        metrics = run_open_loop(client, arrivals, make_images,
                                slo_ms=args.slo_ms,
                                on_accept=lambda k, h: handles.__setitem__(
                                    k, h))
        t1 = time.perf_counter()
    windows = [(h.t_submit, h.t_done, h.latency_s)
               for _, h in sorted(handles.items()) if h is not None]
    late = [{"window": i, "latency_ms": lat * 1e3,
             "overlapping": [
                 {"kind": k, "ms": (b - a) * 1e3, **info}
                 for k, a, b, info in timeline.between(s, d)]}
            for i, (s, d, lat) in enumerate(windows)
            if lat * 1e3 > args.slo_ms]
    passes = timeline.between(t0, t1, "gc")
    lats = sorted(w[2] * 1e3 for w in windows)
    return {
        "slo_attainment": metrics["slo_attainment"],
        "latency_p50_ms": lats[len(lats) // 2],
        "latency_p99_ms": lats[min(len(lats) - 1, int(0.99 * len(lats)))],
        "latency_max_ms": lats[-1],
        "late_windows": late,
        "gc_in_replay": {
            "passes": len(passes),
            "total_ms": sum((b - a) * 1e3 for _, a, b, _ in passes),
            "max_ms": max(((b - a) * 1e3 for _, a, b, _ in passes),
                          default=0.0),
            "by_generation": {str(g): sum(1 for p in passes
                                          if p[3]["generation"] == g)
                              for g in (0, 1, 2)}},
        "captures_in_replay": len(timeline.between(t0, t1, "capture")),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--runs", type=int, default=12,
                    help="runs a ballast, alternating the two traces")
    ap.add_argument("--ballast", default="0",
                    help="comma-separated long-lived object counts")
    ap.add_argument("--device", default=None)
    opts = ap.parse_args(argv)
    if opts.device != "cpu":
        if not torch.cuda.is_available():
            print("events_slo_probe.py: no card; pass --device cpu",
                  file=sys.stderr)
            return 2
        from repro_torch.kernels import _build
        _build.build_all()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(smi, flush=True)
    ballast: list = []
    for n in (int(v) for v in opts.ballast.split(",")):
        ballast.clear()
        gc.collect()
        rows = []
        with Timeline() as timeline:
            for r in range(opts.runs):
                # the heap grows run by run, as the smoke's phases grow it
                ballast.extend({"i": i} for i in range(n // opts.runs))
                flags = ["--trace", str(TRACE)] if r % 2 else []
                device_flags = (["--device", opts.device] if opts.device
                                else [])
                args = cli.parse_args(["--events", "--smoke", *flags,
                                       *device_flags])
                trace = cli.event_trace(args)
                t0 = time.perf_counter()
                model, compile_s = cli.build_model(args,
                                                   cli.event_config(trace))
                build_s = time.perf_counter() - t0
                for rep in range(2):
                    row = {"ballast": n, "run": r, "replay": rep,
                           "trace": "fixture" if flags else "synthetic",
                           "build_s": build_s, "compile_s": compile_s,
                           **replay(model, trace, args, timeline)}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
                del model
        print(json.dumps({"ballast": n, "replays": len(rows),
                          "missed": sum(r["slo_attainment"] < 1.0
                                        for r in rows),
                          "late_windows": sum(len(r["late_windows"])
                                              for r in rows),
                          "late_with_gc": sum(
                              any(o["kind"] == "gc" for o in w["overlapping"])
                              for r in rows for w in r["late_windows"]),
                          "gc_passes_in_replays": sum(
                              r["gc_in_replay"]["passes"] for r in rows),
                          "gc_max_ms": max(r["gc_in_replay"]["max_ms"]
                                           for r in rows),
                          "latency_max_ms": max(r["latency_max_ms"]
                                                for r in rows)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
