"""Summarize a serving trace (``--trace-out`` JSONL) on the terminal.

Reads the versioned span JSONL ``repro_torch.obs.export.write_spans_jsonl``
emits and prints the three views a latency investigation starts with:

  * per-phase breakdown — count / total / mean wall time per span name
    (admit, queue, place, assemble, step, complete, window ops, layers),
  * the top-N slowest requests (the ``complete`` span IS the request's
    latency, so sorting them is the tail),
  * per-replica utilization — each replica's ``step`` time over the trace
    wall, the "is one replica dragging" readout for a fleet trace.

``--assert-complete`` turns the report into a gate (the CI trace-smoke
step): every admitted request must carry its full rid-scoped span chain
(``admit -> queue -> complete``; empty-payload admits legitimately skip
``queue`` — they never enter the queue) and the ring must not have
dropped spans. Exit 1 with the missing rids on violation.

  PYTHONPATH=src python -m repro_torch.launch.trace_report trace.jsonl \
      [--top 5] [--assert-complete]

Port of the reference's ``scripts/trace_report.py`` over
``repro_torch.obs.export.load_spans_jsonl``, so a host without JAX (the
card's) can read the span files the port's serving driver writes. The
report is the reference script's, line for line.
"""
from __future__ import annotations

import argparse
import collections
import sys

from ..obs.export import load_spans_jsonl


def phase_breakdown(spans) -> dict:
    """{(category, name): {"count", "total_s", "mean_s"}} over every
    duration span (counters are instant samples, not phases)."""
    acc = collections.defaultdict(lambda: [0, 0.0])
    for s in spans:
        if s.category == "counter":
            continue
        a = acc[(s.category, s.name)]
        a[0] += 1
        a[1] += s.duration_s
    return {k: {"count": c, "total_s": tot, "mean_s": tot / c}
            for k, (c, tot) in sorted(acc.items())}


def slowest_requests(spans, n: int = 5) -> list:
    """The ``complete`` spans with the largest durations — each one is a
    request's submit-to-done latency."""
    done = [s for s in spans
            if s.category == "request" and s.name == "complete"]
    return sorted(done, key=lambda s: s.duration_s, reverse=True)[:n]


def replica_utilization(spans) -> dict:
    """{replica: step_time / trace_wall} — how much of the trace each
    replica spent inside ``model.step``. Replica None is the single-worker
    engine/runtime lane."""
    if not spans:
        return {}
    wall = (max(s.t1 for s in spans) - min(s.t0 for s in spans)) or 1.0
    busy = collections.defaultdict(float)
    for s in spans:
        if s.category == "batch" and s.name == "step":
            busy[s.replica] += s.duration_s
    return {rep: t / wall for rep, t in sorted(
        busy.items(), key=lambda kv: (kv[0] is None, kv[0]))}


def check_complete(spans, dropped_spans: int) -> list:
    """Every admitted request's rid-scoped chain must close. Returns the
    violations (empty list = the trace passes)."""
    by_rid = collections.defaultdict(set)
    admit_value = {}
    for s in spans:
        if s.category != "request" or s.rid is None:
            continue
        by_rid[s.rid].add(s.name)
        if s.name == "admit":
            admit_value[s.rid] = s.value
    problems = []
    if dropped_spans:
        problems.append(f"ring dropped {dropped_spans} spans — the trace "
                        "is lossy; raise the tracer capacity")
    for rid in sorted(r for r in by_rid if "admit" in by_rid[r]):
        names = by_rid[rid]
        missing = {"complete"} - names
        # a zero-image admit completes at the door and never queues
        if admit_value.get(rid):
            missing |= {"queue"} - names
        if missing:
            problems.append(
                f"rid {rid}: admitted but missing {sorted(missing)} "
                f"(has {sorted(names)})")
    return problems


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="span JSONL from --trace-out")
    ap.add_argument("--top", type=int, default=5,
                    help="how many slowest requests to show")
    ap.add_argument("--assert-complete", action="store_true",
                    help="exit 1 unless every admitted request has a "
                         "complete span chain and zero spans were dropped")
    args = ap.parse_args(argv)

    header, spans = load_spans_jsonl(args.trace)
    dropped = int(header.get("dropped_spans", 0))
    print(f"{args.trace}: {len(spans)} spans, dropped_spans={dropped}")

    print("\nper-phase breakdown:")
    for (cat, name), row in phase_breakdown(spans).items():
        print(f"  {cat:>8s}/{name:<12s} n={row['count']:<6d} "
              f"total={row['total_s'] * 1e3:9.3f}ms "
              f"mean={row['mean_s'] * 1e3:8.3f}ms")

    slow = slowest_requests(spans, args.top)
    if slow:
        print(f"\ntop {len(slow)} slowest requests:")
        for s in slow:
            rep = "" if s.replica is None else f" replica={s.replica}"
            print(f"  rid={s.rid:<6} latency={s.duration_s * 1e3:8.3f}ms"
                  f"{rep}")

    util = replica_utilization(spans)
    if util:
        print("\nper-replica step utilization:")
        for rep, frac in util.items():
            lane = "worker" if rep is None else f"replica {rep}"
            print(f"  {lane:<10s} {frac * 100:6.2f}%")

    if args.assert_complete:
        problems = check_complete(spans, dropped)
        if problems:
            print("\nFAIL: incomplete trace", file=sys.stderr)
            for p in problems:
                print(f"  {p}", file=sys.stderr)
            return 1
        n_req = sum(1 for s in spans
                    if s.category == "request" and s.name == "admit")
        print(f"\nOK: all {n_req} admitted requests have complete span "
              "chains, 0 dropped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
