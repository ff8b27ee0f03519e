"""The port's observability layer (``repro_torch.obs``) against the JAX
reference's: the span ring, the bounded metrics and the trace exports.

The reference tests of ``tests/test_obs.py`` are ported case by case onto
the port's objects (the event-stream session's cases wait for the events
slice). Beside them, parity cases feed both packages the same
clock-injected span sequences and observations and require equal spans,
drop counts, percentiles and snapshots, equal JSONL and Perfetto documents
after ``json.loads``, and each package's ``load_spans_jsonl`` reading the
other's file. The serving clients run a small model on the CPU whose
weights come from the reference's tree (with gains that keep it firing).
"""
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.spikformer import SpikformerConfig as JConfig
from repro.core.spikformer import fold_inference_params as jfold
from repro.core.spikformer import init as jinit
from repro.infer.quant import map_folded_layers as jmap_layers
from repro.obs import LatencyHistogram as JHist
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer
from repro.obs import load_spans_jsonl as jload_spans
from repro.obs import to_chrome_trace as jto_chrome
from repro.obs import write_chrome_trace as jwrite_chrome
from repro.obs import write_spans_jsonl as jwrite_spans
from repro.serve import FleetScheduler as JFleetScheduler
from repro.serve import ServePolicy as JPolicy
from repro_torch.core.spikformer import SpikformerConfig
from repro_torch.infer import (ExecutionPlan, MicroBatchEngine,
                               SERVE_STATS_VERSION, compile as infer_compile)
from repro_torch.infer.engine import (QueueDepthWatermark, Request,
                                      StepAccounting, latency_summary,
                                      serve_stats)
from repro_torch.obs import (LIFECYCLE, NULL_TRACER, SPANS_SCHEMA_VERSION,
                             Counter, Gauge, LatencyHistogram,
                             MetricsRegistry, NullTracer, Span, Tracer,
                             load_spans_jsonl, to_chrome_trace,
                             write_chrome_trace, write_spans_jsonl)
from repro_torch.serve import (AsyncServeRuntime, ContinuousBatchingScheduler,
                               FleetScheduler, ServeFleet, ServePolicy)
from repro_torch.weights import from_reference

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "scripts"))
import trace_report  # noqa: E402  (the reference's trace report)

GAIN, GAIN_RESIDUAL = 4.0, 0.7        # kernel gains; wo/fc2 get both


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these steps are no faster on more (a reduced
    bucket-8 step takes ~24 ms on one thread or eight), and the suite runs
    beside other test processes, where eight threads a process would
    oversubscribe the cores and stretch the serving loops' latencies."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small():
    """The reference test's small config, its seeded tree with gains (so
    the logits are not all zero), compiled by the port on the CPU."""
    jcfg = JConfig().scaled(img_size=16, dim=32, depth=1)
    cfg = SpikformerConfig().scaled(img_size=16, dim=32, depth=1)
    folded = jfold(jinit(jax.random.PRNGKey(0), jcfg), jcfg)
    folded = jmap_layers(folded, lambda p, l: {**l, "kernel": l["kernel"] * (
        GAIN * (GAIN_RESIDUAL if p.endswith(("/wo", "/fc2")) else 1.0))})
    model = infer_compile(from_reference(
        jax.tree_util.tree_map(np.asarray, folded)), cfg,
        ExecutionPlan(weight_dtype="int8", batch_buckets=(2, 8)),
        folded=True, device="cpu")
    model.warmup()
    imgs = np.random.default_rng(1).integers(0, 256, (11, 16, 16, 3),
                                             dtype=np.uint8)
    return cfg, model, imgs


class FakeClock:
    """Ticks 1.0 per call — pins span tables exactly."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        self.t += 1.0
        return self.t


# ---------------------------------------------------------------------------
# tracer: the ring contract
# ---------------------------------------------------------------------------

def test_ring_overflow_drops_oldest_and_counts():
    tr = Tracer(capacity=4, clock=FakeClock())
    for k in range(6):
        tr.span("test", f"s{k}", t0=float(k), t1=float(k) + 0.5)
    assert len(tr) == 4
    assert tr.dropped_spans == 2
    got = tr.spans()
    # chronological, oldest SURVIVING first: s0/s1 were overwritten
    assert [s.name for s in got] == ["s2", "s3", "s4", "s5"]
    assert got[0].t0 == 2.0 and got[0].t1 == 2.5
    assert all(isinstance(s, Span) for s in got)


def test_ring_clear_preserves_drop_account():
    tr = Tracer(capacity=2)
    for k in range(3):
        tr.span("test", "x", t0=0.0)
    assert tr.dropped_spans == 1
    tr.clear()
    assert len(tr) == 0 and tr.spans() == []
    assert tr.dropped_spans == 1          # loss is history, not contents
    tr.span("test", "y", t0=9.0)          # ring still usable after clear
    assert [s.name for s in tr.spans()] == ["y"]


def test_tracer_rejects_zero_capacity():
    with pytest.raises(ValueError, match="capacity"):
        Tracer(capacity=0)


def test_tracer_injected_clock_stamps_instants():
    clock = FakeClock()
    tr = Tracer(capacity=8, clock=clock)
    tr.span("test", "bare")               # t0 defaults to the clock
    tr.counter("depth", 3, t=10.0)
    tr.counter("depth", 4)                # counter on the clock too
    bare, c1, c2 = tr.spans()
    assert bare.t0 == bare.t1 == 1.0      # instant on the injected clock
    assert (c1.category, c1.name, c1.t0, c1.value) == \
        ("counter", "depth", 10.0, 3.0)
    assert c2.t0 == 2.0 and c2.value == 4.0


def test_null_tracer_is_inert():
    assert NULL_TRACER.enabled is False
    assert isinstance(NULL_TRACER, NullTracer)
    NULL_TRACER.span("x", "y", t0=1.0)
    NULL_TRACER.counter("d", 1)
    assert NULL_TRACER.spans() == [] and len(NULL_TRACER) == 0
    assert NULL_TRACER.dropped_spans == 0
    assert LIFECYCLE == ("admit", "queue", "place", "assemble", "step",
                         "complete")


def emit(tr, n_spans):
    """One clock-injected span sequence: spans of every field, counters
    and bare instants, enough of them to wrap a small ring."""
    for k in range(n_spans):
        if k % 5 == 0:
            tr.counter("queue_depth", k, t=0.5 * k, replica=k % 2)
        elif k % 5 == 1:
            tr.span("test", f"bare{k}")
        else:
            tr.span("batch" if k % 2 else "request", f"s{k}", t0=0.25 * k,
                    t1=0.25 * k + 0.125, rid=k if k % 2 == 0 else None,
                    replica=k % 3, bucket=8, occupancy=k / 100.0, value=k)


@pytest.mark.parametrize("capacity,n", [(64, 20), (7, 20), (1, 3)],
                         ids=["fits", "wraps", "one-slot"])
def test_tracer_spans_equal_the_reference(capacity, n):
    """The same clock-injected sequence gives the reference's spans (as
    tuples: the two ``Span`` types differ) and ``dropped_spans``, the ring
    wrapped or not."""
    ours = Tracer(capacity=capacity, clock=FakeClock())
    theirs = JTracer(capacity=capacity, clock=FakeClock())
    emit(ours, n)
    emit(theirs, n)
    assert [tuple(s) for s in ours.spans()] == \
        [tuple(s) for s in theirs.spans()]
    assert ours.dropped_spans == theirs.dropped_spans == max(0, n - capacity)
    assert len(ours) == len(theirs)


# ---------------------------------------------------------------------------
# metrics: counters, gauges, the bounded histogram
# ---------------------------------------------------------------------------

def test_counter_and_gauge_watermark():
    c = Counter("n")
    c.inc()
    c.inc(4)
    assert c.value == 5
    g = Gauge("depth")
    assert g.value is None and g.max is None
    for v in (3.0, 9.0, 2.0):
        g.set(v)
    assert g.value == 2.0 and g.max == 9.0  # burst peak survives the quiet


def test_queue_depth_watermark():
    w = QueueDepthWatermark()
    assert w.peak == 0                     # nothing observed yet
    for d in (3, 8, 1):
        w.observe(d)
    assert w.peak == 8
    shared = Gauge("queue_depth")
    w2 = QueueDepthWatermark(shared)
    w2.observe(5)
    assert shared.max == 5 and w2.peak == 5


def exact_nearest_rank(samples, q):
    """The exact order statistic the histogram approximates: nearest-rank
    over the sorted sample list (NOT numpy's interpolating percentile)."""
    s = sorted(samples)
    rank = max(1, int(np.ceil(q / 100.0 * len(s))))
    return s[rank - 1]


def test_histogram_percentiles_within_documented_error():
    rng = np.random.default_rng(42)
    samples = np.exp(rng.uniform(np.log(1e-4), np.log(1.0), 5000))
    h = LatencyHistogram()
    for v in samples:
        h.observe(float(v))
    assert h.count == 5000
    assert h.mean == pytest.approx(float(samples.sum()) / 5000)
    for q in (1, 10, 25, 50, 75, 90, 95, 99, 99.9):
        got = h.percentile(q)
        want = exact_nearest_rank(samples, q)
        assert abs(got - want) / want <= h.error_bound, \
            f"p{q}: {got} vs exact {want} beyond {h.error_bound:.3f}"
    assert h.error_bound == pytest.approx(0.05)


def test_histogram_empty_single_and_degenerate():
    h = LatencyHistogram()
    assert h.percentile(50) is None and h.mean is None
    assert h.summary() == {"latency_p50_s": None, "latency_p95_s": None,
                           "latency_p99_s": None, "latency_mean_s": None}
    h.observe(0.0123)                     # single sample: exact everywhere
    for q in (0, 50, 99, 100):
        assert h.percentile(q) == pytest.approx(0.0123)
    h2 = LatencyHistogram()
    h2.observe(0.0)                       # the empty-request latency
    assert h2.percentile(50) == 0.0       # clamped into observed [0, 0]
    h2.observe(1e9)                       # overflow bucket: the hi edge
    assert h2.percentile(100) == h2.hi
    with pytest.raises(ValueError, match=">= 0"):
        h2.observe(-0.1)
    with pytest.raises(ValueError, match="growth"):
        LatencyHistogram(growth=1.0)
    with pytest.raises(ValueError, match="lo"):
        LatencyHistogram(lo=0.0)


def test_histogram_memory_is_fixed():
    h = LatencyHistogram()
    n_buckets = len(h.counts)
    for v in np.linspace(1e-5, 2.0, 1000):
        h.observe(float(v))
    assert len(h.counts) == n_buckets     # O(buckets) however many observed
    assert sum(h.counts) == h.count == 1000


def test_registry_get_or_create_and_type_conflict():
    r = MetricsRegistry()
    c = r.counter("drops")
    assert r.counter("drops") is c
    r.gauge("depth").set(4)
    r.histogram("lat").observe(0.01)
    with pytest.raises(TypeError, match="drops"):
        r.gauge("drops")
    with pytest.raises(TypeError, match="depth"):
        r.histogram("depth")
    assert r.names() == ["depth", "drops", "lat"]
    snap = r.snapshot()
    assert snap["drops"] == 0
    assert snap["depth"] == {"value": 4, "max": 4}
    assert snap["lat"]["count"] == 1
    assert snap["lat"]["latency_p50_s"] == pytest.approx(0.01)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_and_registry_equal_the_reference(seed):
    """The same observations give the reference's percentiles, summary,
    bucket counts and registry snapshot, exactly."""
    rng = np.random.default_rng(seed)
    samples = np.concatenate([
        np.exp(rng.uniform(np.log(1e-7), np.log(200.0), 2000)),
        [0.0, 1e-6, 100.0]]).tolist()
    ours, theirs = LatencyHistogram(), JHist()
    reg, jreg = MetricsRegistry(), JRegistry()
    for i, v in enumerate(samples):
        ours.observe(v)
        theirs.observe(v)
        for r in (reg, jreg):
            r.histogram("lat").observe(v)
            r.counter("n").inc(i % 3)
            r.gauge("depth").set(float(v) * (i % 7))
    assert ours.counts == theirs.counts
    for q in (0, 1, 50, 95, 99, 99.9, 100):
        assert ours.percentile(q) == theirs.percentile(q)
    assert ours.summary() == theirs.summary()
    assert reg.snapshot() == jreg.snapshot()
    assert reg.names() == jreg.names()


# ---------------------------------------------------------------------------
# the sync engine's span table, pinned under a fake clock
# ---------------------------------------------------------------------------

def test_engine_span_table_pinned(small):
    _, model, imgs = small
    tr = Tracer(capacity=64)
    eng = MicroBatchEngine(model, tracer=tr, clock=FakeClock())
    eng.submit(imgs[:2])
    eng.run()
    table = [(s.category, s.name, s.t0, s.t1, s.rid, s.bucket)
             for s in tr.spans()]
    assert table == [
        ("request", "admit", 1.0, 2.0, 0, None),
        ("counter", "queue_depth", 2.0, 2.0, None, None),
        ("batch", "place", 3.0, 4.0, None, 2),
        ("request", "queue", 2.0, 5.0, 0, None),
        ("batch", "assemble", 5.0, 6.0, None, 2),
        ("batch", "step", 6.0, 7.0, None, 2),
        ("counter", "occupancy", 6.0, 6.0, None, None),
        ("request", "complete", 2.0, 8.0, 0, None),
    ]
    by_name = {s.name: s for s in tr.spans()}
    assert by_name["admit"].value == 2          # images admitted
    assert by_name["queue_depth"].value == 2.0
    assert by_name["step"].occupancy is not None
    assert tr.dropped_spans == 0


def test_engine_empty_request_chain_skips_queue(small):
    _, model, _ = small
    tr = Tracer(capacity=16)
    eng = MicroBatchEngine(model, tracer=tr, clock=FakeClock())
    req = eng.submit(np.zeros((0, 16, 16, 3), np.uint8))
    assert req.labels == []
    names = [(s.name, s.rid) for s in tr.spans()]
    assert names == [("admit", 0), ("complete", 0)]
    assert tr.spans()[0].value == 0             # zero-image admit
    # the reference's report gate accepts the short chain for empty admits
    assert trace_report.check_complete(tr.spans(), 0) == []


def test_untraced_engine_emits_nothing(small):
    _, model, imgs = small
    eng = MicroBatchEngine(model)
    assert eng.tracer is NULL_TRACER
    eng.submit(imgs[:2])
    eng.run()
    assert len(eng.tracer) == 0


# ---------------------------------------------------------------------------
# chain determinism: identical per-rid lifecycle across every ServeClient
# ---------------------------------------------------------------------------

def chains(tracer):
    """{rid: [span names in append order]} over rid-scoped request spans."""
    out = {}
    for s in tracer.spans():
        if s.category == "request" and s.rid is not None:
            out.setdefault(s.rid, []).append(s.name)
    return out


def test_request_chains_identical_across_clients(small):
    _, model, imgs = small
    sizes = [2, 1, 3, 2]

    tr_eng = Tracer()
    eng = MicroBatchEngine(model, tracer=tr_eng)
    for k, n in enumerate(sizes):
        eng.submit(imgs[:n], rid=k)
    eng.run()

    tr_rt = Tracer()
    with AsyncServeRuntime(model, tracer=tr_rt) as rt:
        handles = [rt.submit(imgs[:n], rid=k) for k, n in enumerate(sizes)]
        for h in handles:
            h.result(timeout=60.0)

    tr_fl = Tracer()
    with ServeFleet(model, replicas=2, tracer=tr_fl) as fleet:
        handles = [fleet.submit(imgs[:n], rid=k)
                   for k, n in enumerate(sizes)]
        for h in handles:
            h.result(timeout=60.0)

    want = {k: ["admit", "queue", "complete"] for k in range(len(sizes))}
    assert chains(tr_eng) == want
    assert chains(tr_rt) == want
    assert chains(tr_fl) == want
    # fleet batch spans carry the executing replica's index
    step_replicas = {s.replica for s in tr_fl.spans()
                     if s.category == "batch" and s.name == "step"}
    assert step_replicas and step_replicas <= {0, 1}
    for tr in (tr_eng, tr_rt, tr_fl):
        assert tr.dropped_spans == 0
        assert trace_report.check_complete(tr.spans(), 0) == []


def test_queue_depth_peak_parity_engine_vs_runtime(small):
    _, model, imgs = small
    # 4 requests x 2 images fill the largest bucket exactly; a 5s window
    # with no SLO means the async worker provably holds all 8 before the
    # first dispatch — both clients must report the identical peak
    eng = MicroBatchEngine(model)
    for k in range(4):
        eng.submit(imgs[2 * (k % 2):2 * (k % 2) + 2], rid=k)
    eng.run()
    assert eng.stats()["queue_depth_peak"] == 8

    with AsyncServeRuntime(model,
                           policy=ServePolicy(max_wait_ms=5000.0)) as rt:
        handles = [rt.submit(imgs[2 * (k % 2):2 * (k % 2) + 2], rid=k)
                   for k in range(4)]
        for h in handles:
            h.result(timeout=60.0)
        assert rt.stats()["queue_depth_peak"] == 8


# ---------------------------------------------------------------------------
# scheduler inspectability: debug_state + publish
# ---------------------------------------------------------------------------

def test_scheduler_debug_state_and_publish():
    s = ContinuousBatchingScheduler((2, 8), ServePolicy())
    s.observe_step(2, 0.010, occupancy=0.10)    # sparse (< 0.35)
    s.observe_step(8, 0.040, occupancy=0.90)    # dense
    ds = s.debug_state()
    assert ds["buckets"] == [2, 8]
    assert set(ds["step_s"]) == {2, 8}
    assert set(ds["class_step_s"]) == {"2/sparse", "8/dense"}
    assert ds["occupancy_ewma"] is not None
    ds["step_s"].clear()                        # a copy, not the live table
    assert s.debug_state()["step_s"]

    reg = MetricsRegistry()
    s.publish(reg)
    assert reg.names() == [
        "scheduler/class_step_s/2/sparse", "scheduler/class_step_s/8/dense",
        "scheduler/occupancy_ewma", "scheduler/step_s/2",
        "scheduler/step_s/8",
    ]
    assert reg.gauge("scheduler/step_s/2").value == pytest.approx(0.010)


def test_fleet_scheduler_publishes_replica_tables():
    s = FleetScheduler((2, 8), ServePolicy(), n_replicas=2)
    s.observe_step(2, 0.010, occupancy=0.10, replica=1)
    ds = s.debug_state()
    assert ds["n_replicas"] == 2
    assert set(ds["replica_step_s"]) == {"1/2"}
    assert set(ds["replica_class_step_s"]) == {"1/2/sparse"}
    reg = MetricsRegistry()
    s.publish(reg, prefix="fleet/")
    names = set(reg.names())
    assert {"fleet/n_replicas", "fleet/replica_step_s/1/2",
            "fleet/replica_class_step_s/1/2/sparse"} <= names
    assert reg.gauge("fleet/n_replicas").value == 2.0


def test_fresh_scheduler_publishes_nothing_spurious():
    reg = MetricsRegistry()
    ContinuousBatchingScheduler((2, 8)).publish(reg)
    assert reg.names() == []        # no observations, no occupancy: silence


def test_scheduler_publish_equals_the_reference():
    """The same observations published by both packages' fleet schedulers
    give equal debug states and registry snapshots."""
    obs = [(2, 0.010, 0.10, 1), (8, 0.040, 0.90, 0), (2, 0.013, 0.50, 0),
           (8, 0.035, 0.20, 1), (2, 0.011, None, 1)]
    ours = FleetScheduler((2, 8), ServePolicy(max_wait_ms=7.0, slo_ms=50.0),
                          n_replicas=2)
    theirs = JFleetScheduler((2, 8), JPolicy(max_wait_ms=7.0, slo_ms=50.0),
                             n_replicas=2)
    for b, s, occ, rep in obs:
        ours.observe_step(b, s, occupancy=occ, replica=rep)
        theirs.observe_step(b, s, occupancy=occ, replica=rep)
    assert ours.debug_state() == theirs.debug_state()
    reg, jreg = MetricsRegistry(), JRegistry()
    ours.publish(reg, prefix="fleet/")
    theirs.publish(jreg, prefix="fleet/")
    assert reg.snapshot() == jreg.snapshot()


# ---------------------------------------------------------------------------
# serve_stats v3: histogram-backed latency fields
# ---------------------------------------------------------------------------

def fake_acct():
    acct = StepAccounting()
    acct.record_step(rows=2, bucket=2, busy_s=0.01, wall_s=0.02,
                     occupancy=0.5)
    return acct


def test_serve_stats_v3_histogram_vs_exact_list():
    assert SERVE_STATS_VERSION == 3
    lats = [0.002, 0.004, 0.008, 0.016, 0.032]
    hist = LatencyHistogram()
    done = []
    for k, v in enumerate(lats):
        hist.observe(v)
        r = Request(rid=k, images=np.zeros((1, 4, 4, 3), np.uint8))
        r.t_submit, r.t_done = 0.0, v
        done.append(r)
    via_hist = serve_stats(acct=fake_acct(), done=done, buckets=(2, 8),
                           latency_hist=hist)
    via_list = serve_stats(acct=fake_acct(), done=done, buckets=(2, 8))
    assert via_hist["stats_version"] == via_list["stats_version"] == 3
    assert set(via_hist) == set(via_list)     # same schema either way
    for k, q in (("latency_p50_s", 50), ("latency_p95_s", 95),
                 ("latency_p99_s", 99)):
        want = exact_nearest_rank(lats, q)
        assert via_hist[k] == pytest.approx(want, rel=hist.error_bound)
    assert via_hist["latency_mean_s"] == pytest.approx(
        via_list["latency_mean_s"], abs=1e-6)     # the mean is exact
    assert via_hist["requests"] == 5


def test_serve_stats_empty_window_reports_absence():
    empty = serve_stats(acct=StepAccounting(), done=[], buckets=(2, 8),
                        latency_hist=LatencyHistogram())
    assert empty["latency_p50_s"] is None and empty["latency_mean_s"] is None
    assert empty["requests"] == 0 and empty["fps"] == 0.0
    assert latency_summary([None, None])["latency_p50_s"] is None
    assert latency_summary([])["latency_p99_s"] is None


# ---------------------------------------------------------------------------
# export: chrome trace structure + JSONL round trip
# ---------------------------------------------------------------------------

def traced_fixture(tracer_cls=Tracer):
    tr = tracer_cls(capacity=32)
    tr.span("request", "admit", t0=10.0, t1=10.1, rid=0, value=2)
    tr.span("request", "queue", t0=10.1, t1=10.3, rid=0)
    tr.span("batch", "place", t0=10.1, t1=10.2, bucket=2)
    tr.span("batch", "step", t0=10.3, t1=10.9, bucket=2, occupancy=0.4,
            value=2, replica=1)
    tr.span("window", "encode", t0=10.0, t1=10.05, rid=3, value=7)
    tr.counter("queue_depth", 2, t=10.1)
    tr.span("request", "complete", t0=10.1, t1=11.0, rid=0)
    return tr


def test_chrome_trace_structure():
    tr = traced_fixture()
    doc = to_chrome_trace(tr.spans(), dropped_spans=3)
    assert doc["otherData"] == {"spans_version": SPANS_SCHEMA_VERSION,
                                "dropped_spans": 3}
    ev = doc["traceEvents"]
    x = [e for e in ev if e["ph"] == "X"]
    counters = [e for e in ev if e["ph"] == "C"]
    meta = [e for e in ev if e["ph"] == "M"]
    assert len(x) == 6 and len(counters) == 1
    assert min(e["ts"] for e in x) == 0.0
    assert all(e["dur"] >= 0.0 for e in x)
    assert {e["pid"] for e in x} == {0, 1}
    by_name = {e["name"]: e for e in x}
    assert by_name["admit"]["tid"] == 10 + 0      # request lane
    assert by_name["place"]["tid"] == 1           # scheduler lane
    assert by_name["encode"]["tid"] == 10 + 3     # rid lane wins over window
    assert by_name["step"]["args"]["occupancy"] == 0.4
    assert counters[0]["args"] == {"queue_depth": 2.0}
    proc_names = {e["pid"]: e["args"]["name"] for e in meta
                  if e["name"] == "process_name"}
    assert proc_names == {0: "replica 0", 1: "replica 1"}
    assert any(e["name"] == "thread_name" and e["args"]["name"] == "worker"
               for e in meta)


def test_jsonl_round_trip(tmp_path):
    tr = traced_fixture()
    path = tmp_path / "trace.jsonl"
    n = write_spans_jsonl(path, tr, meta={"mode": "test"})
    assert n == 7
    header, spans = load_spans_jsonl(path)
    assert header["kind"] == "repro.obs.spans"
    assert header["spans_version"] == SPANS_SCHEMA_VERSION
    assert header["dropped_spans"] == 0 and header["meta"] == {"mode": "test"}
    assert spans == tr.spans()                    # bit-exact inversion
    pf = tmp_path / "trace.perfetto.json"
    assert write_chrome_trace(pf, tr) == 7
    assert len(json.loads(pf.read_text())["traceEvents"]) > 7


def test_jsonl_loader_refuses_bad_files(tmp_path):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    with pytest.raises(ValueError, match="empty"):
        load_spans_jsonl(empty)
    wrong = tmp_path / "wrong.jsonl"
    wrong.write_text(json.dumps({"kind": "something.else"}) + "\n")
    with pytest.raises(ValueError, match="kind"):
        load_spans_jsonl(wrong)
    future = tmp_path / "future.jsonl"
    future.write_text(json.dumps({"kind": "repro.obs.spans",
                                  "spans_version": 99, "spans": 0}) + "\n")
    with pytest.raises(ValueError, match="spans_version"):
        load_spans_jsonl(future)
    trunc = tmp_path / "trunc.jsonl"
    trunc.write_text(json.dumps({"kind": "repro.obs.spans",
                                 "spans_version": SPANS_SCHEMA_VERSION,
                                 "spans": 5}) + "\n")
    with pytest.raises(ValueError, match="truncated"):
        load_spans_jsonl(trunc)


@pytest.mark.parametrize("capacity", [32, 5], ids=["whole", "wrapped"])
def test_exports_equal_the_reference_and_cross_load(tmp_path, capacity):
    """The same spans written by both packages give equal JSONL and
    Perfetto documents after ``json.loads`` (the wrapped ring's
    ``dropped_spans`` travels in both), and each package's loader reads the
    other's file back to the same spans."""
    ours, theirs = traced_fixture(), traced_fixture(JTracer)
    if capacity < 32:
        ours, theirs = Tracer(capacity=capacity), JTracer(capacity=capacity)
        for tr in (ours, theirs):
            for s in traced_fixture().spans():
                tr.span(s.category, s.name, t0=s.t0, t1=s.t1, rid=s.rid,
                        replica=s.replica, bucket=s.bucket,
                        occupancy=s.occupancy, value=s.value)
    meta = {"mode": "parity", "replicas": 2}
    write_spans_jsonl(tmp_path / "ours.jsonl", ours, meta=meta)
    jwrite_spans(tmp_path / "theirs.jsonl", theirs, meta=meta)
    lines = [[json.loads(line) for line in (tmp_path / f).read_text()
              .splitlines()] for f in ("ours.jsonl", "theirs.jsonl")]
    assert lines[0] == lines[1]
    write_chrome_trace(tmp_path / "ours.json", ours)
    jwrite_chrome(tmp_path / "theirs.json", theirs)
    docs = [json.loads((tmp_path / f).read_text())
            for f in ("ours.json", "theirs.json")]
    assert docs[0] == docs[1]
    assert to_chrome_trace(ours.spans(), dropped_spans=4) == jto_chrome(
        theirs.spans(), dropped_spans=4)
    h_theirs, from_ours = jload_spans(tmp_path / "ours.jsonl")
    h_ours, from_theirs = load_spans_jsonl(tmp_path / "theirs.jsonl")
    assert h_ours == h_theirs
    assert h_ours["dropped_spans"] == ours.dropped_spans == max(
        0, 7 - capacity)
    assert [tuple(s) for s in from_ours] == [tuple(s) for s in ours.spans()]
    assert from_theirs == ours.spans()
