"""Open-loop load generation against the async serving runtime.

A closed-loop driver (submit everything, drain, divide) measures the
server's best case: arrivals conveniently wait for capacity. Real-time
claims — VESTA's sustained ~30 fps — are open-loop properties: requests
arrive on their OWN schedule whether or not the server kept up, and the
numbers that matter are goodput (work completed within its SLO per second
of wall time), tail latency under that arrival process (p99, not mean),
and SLO attainment. This module produces exactly those numbers.

    trace = poisson_trace(rps=60, duration_s=3, seed=0)
    with AsyncServeRuntime(model, policy=ServePolicy(slo_ms=100)) as rt:
        metrics = run_open_loop(rt, trace,
                                image_maker(model.input_shape()[1:], seed=1),
                                slo_ms=100)

The driver speaks only the ``ServeClient`` protocol (submit that may
raise ``QueueFull``, handles whose ``result`` blocks), so the same trace
drives the sync ``MicroBatchEngine``, the ``AsyncServeRuntime``, or a
multi-replica ``ServeFleet`` without an isinstance anywhere —
``run_replica_sweep`` exploits that to replay one trace across fleet
sizes and report goodput scaling.

The trace is a plain list of ``Arrival`` values, deterministic from its
seed, so a trace can be replayed — through the async runtime, or through
the sync engine for the bit-identical-labels parity check — and committed
next to a benchmark record. (The rid-aligned replay comparison assumes a
ZERO-REJECTION run: a rejected submit consumes no runtime rid, shifting
every later rid relative to a replay that submits all arrivals. Align on
per-request labels from the returned handles when rejections are
possible.)
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from ..infer.engine import latency_summary
from .scheduler import QueueFull


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: submit ``n_images`` at ``t_s`` seconds after
    the run starts."""
    t_s: float
    n_images: int


def validate_trace(trace) -> list:
    """Materialize any ``Arrival`` iterable and enforce the open-loop
    contract: timestamps non-negative and sorted non-decreasing, image
    counts >= 1. ``run_open_loop`` and the trace-replay path both call
    this at the door — a replay that silently reordered arrivals would
    produce a decision table that never happened, so a violation is a
    loud ``ValueError`` naming the offending index, never a sort."""
    trace = list(trace)
    prev = 0.0
    for k, a in enumerate(trace):
        if a.t_s < prev:
            raise ValueError(
                f"arrival {k} at t_s={a.t_s!r} precedes "
                f"{'arrival ' + str(k - 1) if k else 'the run start'} at "
                f"t_s={prev!r}; traces must be sorted non-decreasing")
        if a.n_images < 1:
            raise ValueError(
                f"arrival {k} carries n_images={a.n_images!r}; every "
                f"arrival must carry at least one image")
        prev = a.t_s
    return trace


def poisson_trace(*, rps: float, duration_s: float, seed: int,
                  images_per_request=(1, 1)) -> list:
    """Poisson arrival process: exponential inter-arrival times at ``rps``
    requests/second for ``duration_s``, each request carrying a uniform
    number of images in ``images_per_request`` (inclusive bounds).
    Deterministic from ``seed``."""
    if rps <= 0 or duration_s <= 0:
        raise ValueError(f"rps and duration_s must be > 0, got "
                         f"{rps!r}, {duration_s!r}")
    lo, hi = images_per_request
    rng = np.random.default_rng(seed)
    trace, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / rps))
        if t >= duration_s:
            return trace
        trace.append(Arrival(t_s=t, n_images=int(rng.integers(lo, hi + 1))))


def burst_trace(*, rps_on: float, on_s: float, off_s: float,
                duration_s: float, seed: int, rps_off: float = 0.0,
                images_per_request=(1, 1)) -> list:
    """ON/OFF (interrupted Poisson) arrival process — the bursty shape a
    real event-camera workload produces: Poisson arrivals at ``rps_on``
    during ON periods of ``on_s`` seconds, then ``rps_off`` (default:
    silence) for ``off_s``, repeating for ``duration_s``. Deterministic
    from ``seed``. Same mean rate as Poisson at the duty-cycled average,
    but a far higher index of dispersion — exactly the traffic that makes
    queue-depth high-watermarks and admission control earn their keep."""
    if rps_on <= 0 or on_s <= 0 or off_s < 0 or duration_s <= 0:
        raise ValueError(
            f"need rps_on, on_s, duration_s > 0 and off_s >= 0, got "
            f"rps_on={rps_on!r}, on_s={on_s!r}, off_s={off_s!r}, "
            f"duration_s={duration_s!r}")
    if rps_off < 0:
        raise ValueError(f"rps_off must be >= 0, got {rps_off!r}")
    lo, hi = images_per_request
    rng = np.random.default_rng(seed)
    trace, t, period = [], 0.0, on_s + off_s
    while t < duration_s:
        phase = t % period
        rate = rps_on if phase < on_s else rps_off
        if rate <= 0:
            # silent phase: jump to the next ON boundary, no draws
            t = (t // period) * period + period
            continue
        t += float(rng.exponential(1.0 / rate))
        if t >= duration_s or (t % period) >= on_s and rate == rps_on:
            # a draw that crossed out of its phase is discarded, not kept:
            # keeping it would smear the OFF edge
            continue
        trace.append(Arrival(t_s=t, n_images=int(rng.integers(lo, hi + 1))))
    return trace


def burstiness(trace, *, window_s: float = 0.1) -> dict:
    """Burstiness accounting for an arrival trace: the index of dispersion
    (variance/mean of per-``window_s`` arrival counts — 1.0 for Poisson,
    >> 1 for ON/OFF bursts) and the peak-to-mean window rate. These are
    properties of the OFFERED load, computed from the trace alone, so a
    loadgen report can say "the server survived D=12 traffic", not just
    "some traffic". ``None`` values when the trace spans < 2 windows."""
    trace = list(trace)
    if not trace:
        return {"dispersion_index": None, "peak_to_mean_rate": None}
    span = trace[-1].t_s
    n_windows = int(np.ceil(span / window_s)) if span > 0 else 1
    if n_windows < 2:
        return {"dispersion_index": None, "peak_to_mean_rate": None}
    counts = np.zeros(n_windows, np.int64)
    for a in trace:
        counts[min(int(a.t_s / window_s), n_windows - 1)] += 1
    mean = counts.mean()
    return {
        "dispersion_index": (round(float(counts.var() / mean), 4)
                             if mean else None),
        "peak_to_mean_rate": (round(float(counts.max() / mean), 4)
                              if mean else None),
    }


def image_maker(image_shape, *, seed: int):
    """A deterministic ``make(index, n) -> (n, H, W, C) uint8`` factory for
    synthetic request payloads; same seed + same call sequence = same
    images (what lets a trace replay bit-identically through the sync and
    async paths)."""
    image_shape = tuple(int(d) for d in image_shape)
    rng = np.random.default_rng(seed)

    def make(index: int, n: int):
        return rng.integers(0, 256, (n, *image_shape), dtype=np.uint8)

    return make


def run_open_loop(runtime, trace, make_images, *, slo_ms: float,
                  result_timeout_s: float = 60.0, clock=time.perf_counter,
                  sleep=time.sleep, on_accept=None) -> dict:
    """Replay ``trace`` open-loop against ``runtime`` and measure.

    ``trace`` is ANY iterable of sorted ``Arrival`` values — a
    ``poisson_trace``/``burst_trace`` list, a generator, or arrivals
    loaded from a recorded event trace; it is materialized and validated
    at the door (``validate_trace`` — non-monotonic timestamps are a loud
    ``ValueError``, because the replay contract depends on arrival order).

    Each arrival is submitted at its scheduled time regardless of what has
    completed — when the server falls behind, latency (and eventually
    admission-control rejections) absorb the difference; the generator
    never throttles. After the last arrival the run waits for every
    ACCEPTED request; one that fails to complete within
    ``result_timeout_s`` counts as ``dropped`` — the acceptance contract is
    zero, because an accepted request is a promise.

    ``on_accept(k, handle)`` (optional) is called per arrival with the
    submit handle, or ``None`` when admission control rejected it — the
    hook trace replay uses to align labels with arrivals even though
    runtime rids only cover accepted submits.

    Returns the serving-under-load metrics: offered vs completed rates,
    goodput (within-SLO images/s over the whole open-loop window),
    p50/p95/p99 latency, SLO attainment, and the offered trace's
    burstiness (index of dispersion, peak-to-mean window rate).
    """
    trace = validate_trace(trace)
    slo_s = slo_ms / 1e3
    accepted, rejected = [], 0
    t0 = clock()
    for k, a in enumerate(trace):
        delay = t0 + a.t_s - clock()
        if delay > 0:
            sleep(delay)
        imgs = make_images(k, a.n_images)
        try:
            handle = runtime.submit(imgs)
        except QueueFull:
            rejected += 1
            handle = None
        else:
            accepted.append(handle)
        if on_accept is not None:
            on_accept(k, handle)
    # "done" is decided by FUTURE resolution, not t_done: a request that
    # times out here counts as dropped and must stay out of the completed
    # metrics even if the worker finishes it later in this wait loop —
    # one request, one bucket, metrics row internally consistent.
    # result_timeout_s is ONE shared drain deadline, not per-request: a
    # wedged worker fails the whole drain after that budget instead of
    # stalling accepted_requests x timeout (hours at bench rates).
    done, dropped = [], 0
    drain_deadline = clock() + result_timeout_s
    for req in accepted:
        try:
            req.result(timeout=max(0.0, drain_deadline - clock()))
            done.append(req)
        except Exception:
            dropped += 1
    elapsed = clock() - t0
    images_done = sum(len(r.labels) for r in done)
    within = [r for r in done if r.latency_s <= slo_s]
    duration = trace[-1].t_s if trace else 0.0
    return {
        "requests_offered": len(trace),
        "requests_accepted": len(accepted),
        "requests_rejected": rejected,
        "requests_dropped": dropped,          # accepted but never completed
        "offered_rps": round(len(trace) / duration, 2) if duration else 0.0,
        "elapsed_s": round(elapsed, 4),
        "images_completed": images_done,
        "completed_fps": round(images_done / elapsed, 2) if elapsed else 0.0,
        "goodput_fps": round(sum(len(r.labels) for r in within) / elapsed, 2)
        if elapsed else 0.0,
        "slo_ms": slo_ms,
        "slo_attainment": round(len(within) / len(done), 4) if done else None,
        **burstiness(trace),
        **latency_summary(r.latency_s for r in done),
    }


def run_replica_sweep(make_client, trace, make_images_factory, *,
                      replica_counts=(1, 2), slo_ms: float,
                      result_timeout_s: float = 60.0,
                      clock=time.perf_counter, sleep=time.sleep) -> list:
    """Replay ONE trace across fleet sizes and measure goodput scaling.

    ``make_client(n)`` builds a fresh ``ServeClient`` with ``n`` replicas
    (closed here after its run); ``make_images_factory()`` returns a fresh
    deterministic image maker per run, so every fleet size sees the exact
    same arrival schedule AND payload bytes — the only variable is the
    replica count. Returns one metrics row per count (the ``run_open_loop``
    schema plus ``replicas`` and ``goodput_scaling``, normalized to the
    first count's goodput — run counts smallest-first so the baseline is
    the 1-replica row)."""
    rows, base = [], None
    for n in replica_counts:
        client = make_client(n)
        try:
            metrics = run_open_loop(
                client, trace, make_images_factory(), slo_ms=slo_ms,
                result_timeout_s=result_timeout_s, clock=clock, sleep=sleep)
        finally:
            client.close()
        row = {"replicas": int(n), **metrics}
        if base is None:
            base = row["goodput_fps"]
        row["goodput_scaling"] = (round(row["goodput_fps"] / base, 4)
                                  if base else None)
        rows.append(row)
    return rows


def replay_decisions(trace, scheduler, *, service_s, drain=True) -> list:
    """Replay an arrival trace through a scheduler as a pure discrete-event
    simulation and return the full decision table.

    Live runs thread real wall time through ``decide``; this replay
    threads a virtual clock instead, so the SAME trace + the SAME policy +
    the SAME service-time model always produce the IDENTICAL table — the
    determinism half of the trace-replay contract, and the tool that lets
    a test pin exactly how a bursty ON/OFF trace sheds (``QueueFull``) at
    the burst peak and recovers once it passes.

    ``scheduler`` is a fresh ``ContinuousBatchingScheduler`` (one modeled
    worker) or ``FleetScheduler`` (its ``n_replicas`` workers, busy masks
    and placement included). ``service_s`` models step time: a
    ``{bucket: seconds}`` dict or a ``f(bucket) -> seconds`` callable — a
    live scheduler's ``service_snapshot()`` is a ready-made dict. Each
    dispatch occupies its replica for the modeled service time and feeds
    ``observe_step``, so the policy's EWMAs evolve exactly as they would
    have.

    Table rows (time rounded to 6 decimals, chronological):
    ``{"t", "event": "reject", "images", "backlog"}`` for an admission
    shed, ``{"t", "event": "dispatch", "bucket", "rows", "replica",
    "reason", "backlog"}`` for a dispatch (``backlog`` = images left
    AFTER the action). With ``drain=True`` (default) the tail of the
    queue dispatches under draining rules once arrivals are exhausted —
    every admitted image leaves the table, the simulated promise."""
    trace = validate_trace(trace)
    service = (service_s if callable(service_s)
               else lambda b, _m=dict(service_s): float(_m[b]))
    is_fleet = hasattr(scheduler, "place")
    n = getattr(scheduler, "n_replicas", 1)
    queue: deque = deque()          # per-image submit times, FIFO
    busy_until = [0.0] * n
    table, i, now = [], 0, 0.0
    while i < len(trace) or queue:
        # deliver every arrival due by the virtual clock
        while i < len(trace) and trace[i].t_s <= now:
            a = trace[i]
            if scheduler.admit(len(queue), a.n_images):
                queue.extend([a.t_s] * a.n_images)
            else:
                table.append({"t": round(a.t_s, 6), "event": "reject",
                              "images": int(a.n_images),
                              "backlog": len(queue)})
            i += 1
        if not is_fleet and busy_until[0] > now:
            # the single runtime's worker cannot decide mid-step: jump to
            # whichever comes first, the step finishing or the next arrival
            now = (min(busy_until[0], trace[i].t_s) if i < len(trace)
                   else busy_until[0])
            continue
        draining = drain and i >= len(trace)
        kwargs = dict(backlog=len(queue),
                      oldest_submit_s=queue[0] if queue else None,
                      now_s=now, draining=draining)
        if is_fleet:
            d = scheduler.decide(
                busy=tuple(busy_until[r] > now for r in range(n)), **kwargs)
        else:
            d = scheduler.decide(**kwargs)
        if d.action == "dispatch":
            r = 0 if d.replica is None else d.replica
            rows = min(d.rows, len(queue))
            for _ in range(rows):
                queue.popleft()
            svc = float(service(d.bucket))
            busy_until[r] = now + svc
            if is_fleet:
                scheduler.observe_step(d.bucket, svc, replica=r)
            else:
                scheduler.observe_step(d.bucket, svc)
            table.append({"t": round(now, 6), "event": "dispatch",
                          "bucket": int(d.bucket), "rows": int(rows),
                          "replica": int(r), "reason": d.reason,
                          "backlog": len(queue)})
            continue
        # "wait" / "idle": advance the clock to the next state change
        nexts = []
        if i < len(trace):
            nexts.append(trace[i].t_s)
        if d.action == "wait":
            nexts.append(now + max(d.wait_s, 1e-9))
        frees = [b for b in busy_until if b > now]
        if frees:
            nexts.append(min(frees))
        if not nexts:
            break   # idle, nothing left to happen
        now = min(nexts)
    return table
