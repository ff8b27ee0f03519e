"""The port's serving stack (``repro_torch.serve``) against the JAX
reference's: the scheduler, the async runtime, the open-loop load
generator and the replica fleet.

The reference tests of ``tests/test_serve.py`` are ported case by case onto
the port's objects, on the CPU. Beside them, parity cases hold the port to
the reference: the same seed gives the reference's traces, burstiness and
images; ``replay_decisions`` gives the reference's decision tables under
both schedulers; and a seeded trace served by the port's runtime and its
two-replica fleet gives labels equal to ``classify`` and to the
reference's runtime on the same weights, with the reference's stats keys.
The models are the reference test's small config with the reference's
seeded tree (gains keep it firing, so labels are not all 0) and int8
weights, whose routes are all exact in both packages.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.core.spikformer import SpikformerConfig as JConfig
from repro.core.spikformer import fold_inference_params as jfold
from repro.core.spikformer import init as jinit
from repro.infer import ExecutionPlan as JPlan
from repro.infer import compile as jcompile
from repro.infer.quant import map_folded_layers as jmap_layers
from repro.infer.engine import batch_occupancy as jbatch_occupancy
from repro.serve import AsyncServeRuntime as JRuntime
from repro.serve import ContinuousBatchingScheduler as JScheduler
from repro.serve import FleetScheduler as JFleetScheduler
from repro.serve import ServeFleet as JFleet
from repro.serve import ServePolicy as JPolicy
from repro.serve import burst_trace as jburst_trace
from repro.serve import burstiness as jburstiness
from repro.serve import image_maker as jimage_maker
from repro.serve import poisson_trace as jpoisson_trace
from repro.serve import replay_decisions as jreplay_decisions
from repro.serve import run_open_loop as jrun_open_loop
from repro_torch.core.spikformer import SpikformerConfig
from repro_torch.infer import (ExecutionPlan, MicroBatchEngine,
                               SERVE_STATS_VERSION, ServeClient,
                               compile as infer_compile)
from repro_torch.infer.compile import plan_chunks
from repro_torch.infer.engine import (StepAccounting, assemble_batch,
                                      batch_occupancy, latency_summary,
                                      validate_images)
from repro_torch.serve import (Arrival, AsyncServeRuntime, burst_trace,
                               burstiness, ContinuousBatchingScheduler,
                               FleetScheduler, QueueFull, ServeFleet,
                               ServePolicy, image_maker, poisson_trace,
                               replay_decisions, run_open_loop,
                               run_replica_sweep, validate_trace)
from repro_torch.sharding.rules import replica_devices, serving_mesh
from repro_torch.weights import from_reference

GAIN, GAIN_RESIDUAL = 4.0, 0.7        # kernel gains; wo/fc2 get both
JCFG = JConfig().scaled(img_size=16, dim=32, depth=1)
CFG = SpikformerConfig().scaled(img_size=16, dim=32, depth=1)


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


def exact(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def reference_tree(seed):
    """The reference's seeded folded tree at the small config, with gains
    that keep the residual stream firing."""
    folded = jfold(jinit(jax.random.PRNGKey(seed), JCFG), JCFG)
    return jmap_layers(folded, lambda p, l: {**l, "kernel": l["kernel"] * (
        GAIN * (GAIN_RESIDUAL if p.endswith(("/wo", "/fc2")) else 1.0))})


def port_model(seed=0, buckets=(2, 8)):
    tree = jax.tree_util.tree_map(np.asarray, reference_tree(seed))
    model = infer_compile(from_reference(tree), CFG, ExecutionPlan(
        weight_dtype="int8", batch_buckets=buckets), folded=True,
        device="cpu")
    model.warmup()
    return model


@pytest.fixture(scope="module")
def small():
    imgs = np.random.default_rng(1).integers(0, 256, (11, 16, 16, 3),
                                             dtype=np.uint8)
    return CFG, port_model(0), imgs


# ---------------------------------------------------------------------------
# scheduler: the pinned decision table (pure, injected clock)
# ---------------------------------------------------------------------------

def sched(max_wait_ms=10.0, slo_ms=None, depth=512, buckets=(2, 8)):
    return ContinuousBatchingScheduler(
        buckets, ServePolicy(max_wait_ms=max_wait_ms, slo_ms=slo_ms,
                             max_queue_images=depth))


def test_decision_table_wait_vs_dispatch():
    s = sched(max_wait_ms=10.0)
    # empty queue: idle (sleep until a submit)
    assert s.decide(backlog=0, oldest_submit_s=None, now_s=5.0).action == \
        "idle"
    # a full largest bucket never waits
    d = s.decide(backlog=8, oldest_submit_s=0.0, now_s=0.0)
    assert (d.action, d.bucket, d.rows) == ("dispatch", 8, 8)
    d = s.decide(backlog=9, oldest_submit_s=0.0, now_s=0.0)
    assert (d.action, d.bucket, d.rows) == ("dispatch", 8, 8)
    # partial backlog inside the window: wait EXACTLY until the deadline
    d = s.decide(backlog=3, oldest_submit_s=1.0, now_s=1.004)
    assert d.action == "wait"
    assert d.wait_s == pytest.approx(0.006)
    # at the deadline: dispatch the FIRST chunk of the pad-minimizing
    # split — 3 over (2, 8) runs 2 now, leaves 1 accumulating
    d = s.decide(backlog=3, oldest_submit_s=1.0, now_s=1.010)
    assert (d.action, d.bucket, d.rows) == ("dispatch", 2, 2)
    assert d.reason == "max_wait deadline reached"


def test_decision_table_tail_smaller_than_smallest_bucket():
    s = sched(max_wait_ms=10.0)
    # backlog 1 < smallest bucket 2: waits its window, then dispatches
    # padded into the smallest bucket
    d = s.decide(backlog=1, oldest_submit_s=0.0, now_s=0.0)
    assert d.action == "wait" and d.wait_s == pytest.approx(0.010)
    d = s.decide(backlog=1, oldest_submit_s=0.0, now_s=0.011)
    assert (d.action, d.bucket, d.rows) == ("dispatch", 2, 1)


def test_decision_table_slo_pressure_closes_window_early():
    s = sched(max_wait_ms=50.0, slo_ms=30.0)
    # no observed step times: SLO deadline = submit + slo (estimate 0),
    # tighter than max_wait
    d = s.decide(backlog=1, oldest_submit_s=0.0, now_s=0.0)
    assert d.action == "wait" and d.wait_s == pytest.approx(0.030)
    # an observed 20ms step shrinks the budget: dispatch by 30-20=10ms
    s.observe_step(2, 0.020)
    d = s.decide(backlog=1, oldest_submit_s=0.0, now_s=0.0)
    assert d.action == "wait" and d.wait_s == pytest.approx(0.010)
    d = s.decide(backlog=1, oldest_submit_s=0.0, now_s=0.0105)
    assert d.action == "dispatch" and d.reason == "SLO pressure"
    # EWMA: a faster step moves the estimate, deterministically
    s.observe_step(2, 0.010)
    assert s.service_estimate(2) == pytest.approx(0.8 * 0.020 + 0.2 * 0.010)
    # unknown bucket: conservative (slowest observed)
    assert s.service_estimate(8) == s.service_estimate(2)


def test_decision_table_draining_dispatches_immediately():
    s = sched(max_wait_ms=10_000.0)
    d = s.decide(backlog=1, oldest_submit_s=0.0, now_s=0.0, draining=True)
    assert (d.action, d.bucket, d.rows) == ("dispatch", 2, 1)
    assert d.reason == "draining"
    assert s.decide(backlog=0, oldest_submit_s=None, now_s=0.0,
                    draining=True).action == "idle"


def test_scheduler_admission_bound():
    s = sched(depth=4)
    assert s.admit(0, 4) and s.admit(3, 1)
    assert not s.admit(3, 2) and not s.admit(0, 5)
    with pytest.raises(ValueError, match="max_queue_images"):
        ServePolicy(max_queue_images=0)
    with pytest.raises(ValueError, match="slo_ms"):
        ServePolicy(slo_ms=0)
    with pytest.raises(ValueError, match="max_wait_ms"):
        ServePolicy(max_wait_ms=-1)


def test_scheduler_reuses_model_plan_chunks(small):
    """The scheduler's dispatch shape IS the model's pad-minimizing split —
    same function, not a copy."""
    _, model, _ = small
    for n in range(1, 20):
        assert plan_chunks(n, model.buckets) == model.plan_chunks(n)
    s = sched()
    for backlog in range(1, 8):
        d = s.decide(backlog=backlog, oldest_submit_s=0.0, now_s=1.0)
        assert (d.rows, d.bucket) == model.plan_chunks(backlog)[0]


# ---------------------------------------------------------------------------
# shared serve plumbing (engine.py): validation, assembly, accounting
# ---------------------------------------------------------------------------

def test_validate_images_shape_and_dtype():
    ok = validate_images(np.zeros((2, 16, 16, 3), np.uint8), (16, 16, 3))
    assert ok.shape == (2, 16, 16, 3) and ok.dtype == np.uint8
    # int32 in range casts; out of range refuses
    assert validate_images(np.full((1, 16, 16, 3), 255, np.int32),
                           (16, 16, 3)).dtype == np.uint8
    with pytest.raises(ValueError, match=r"outside \[0, 255\]"):
        validate_images(np.full((1, 16, 16, 3), 256, np.int32), (16, 16, 3))
    # the error NAMES the expected per-image shape
    with pytest.raises(ValueError, match=r"\(n, 16, 16, 3\)"):
        validate_images(np.zeros((2, 8, 8, 3), np.uint8), (16, 16, 3))
    with pytest.raises(ValueError, match="expected uint8"):
        validate_images(np.zeros((2, 16, 16, 3), np.float32), (16, 16, 3))
    # a single unbatched image is not silently promoted
    with pytest.raises(ValueError, match=r"\(16, 16, 3\)"):
        validate_images(np.zeros((16, 16, 3), np.uint8), (16, 16, 3))


def test_engine_submit_door_validation(small):
    _, model, imgs = small
    eng = MicroBatchEngine(model)
    with pytest.raises(ValueError, match=r"\(n, 16, 16, 3\)"):
        eng.submit(np.zeros((1, 8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="dtype"):
        eng.submit(imgs[:1].astype(np.float32))
    assert not eng.queue                  # nothing half-queued


def test_assemble_batch_and_accounting():
    batch, pad = assemble_batch([np.ones((4, 4), np.uint8)] * 3, 8)
    assert batch.shape == (8, 4, 4) and pad == 5
    assert batch[:3].all() and not batch[3:].any()
    batch, pad = assemble_batch([np.ones((4, 4), np.uint8)] * 2, 2)
    assert batch.shape == (2, 4, 4) and pad == 0
    acct = StepAccounting()
    acct.record_step(rows=3, bucket=8, busy_s=0.5, wall_s=1.0)
    acct.record_step(rows=2, bucket=2, busy_s=0.25, wall_s=0.5)
    assert acct.batches == 2 and acct.images == 5
    assert acct.padded_rows == 5 and acct.total_rows == 10
    assert acct.pad_waste == 0.5
    assert acct.fps == pytest.approx(5 / 1.5)
    assert latency_summary([])["latency_p99_s"] is None
    s = latency_summary([0.1] * 99 + [1.0])
    assert s["latency_p50_s"] == 0.1 and s["latency_p99_s"] > 0.1


# ---------------------------------------------------------------------------
# runtime: sync/async parity and the edge-case contract
# ---------------------------------------------------------------------------

def trace_requests(imgs):
    """A fixed mixed-size request trace over the fixture images."""
    sizes = (2, 1, 3, 1, 2, 2)
    out, i = [], 0
    for n in sizes:
        out.append(imgs[i:i + n])
        i += n
    return out


def test_identical_trace_sync_async_bit_identical_labels(small):
    """The acceptance property: the SAME request trace through the sync
    engine and the async runtime yields bit-identical labels, and both
    match direct classify()."""
    _, model, imgs = small
    reqs = trace_requests(imgs)
    eng = MicroBatchEngine(model)
    for r in reqs:
        eng.submit(r)
    sync_done = sorted(eng.run(), key=lambda r: r.rid)
    with AsyncServeRuntime(model,
                           policy=ServePolicy(max_wait_ms=2.0)) as rt:
        handles = [rt.submit(r) for r in reqs]
        async_labels = [h.result(timeout=30) for h in handles]
    assert [r.labels for r in sync_done] == async_labels
    want = np.asarray(model.classify(imgs)).tolist()
    flat = [lab for labs in async_labels for lab in labs]
    assert flat == want[:len(flat)]


def test_async_empty_request_completes_via_future(small):
    _, model, imgs = small
    with AsyncServeRuntime(model) as rt:
        req = rt.submit(imgs[:0])
        assert req.result(timeout=5) == []
        assert req.t_done == req.t_submit
        assert rt.stats()["requests"] == 1


def test_async_rid_reuse_and_inflight_rejection(small):
    _, model, imgs = small
    with AsyncServeRuntime(model,
                           policy=ServePolicy(max_wait_ms=10_000.0)) as rt:
        first = rt.submit(imgs[:2], rid=7)     # fills bucket 2: dispatches
        assert first.result(timeout=30) is not None
        second = rt.submit(imgs[2:3], rid=7)   # completed rid is reusable
        # 1 image < smallest bucket + huge window: still in flight
        with pytest.raises(ValueError, match="already in flight"):
            rt.submit(imgs[3:4], rid=7)
    # close() drained: the in-flight request completed, not abandoned
    assert second.result(timeout=1) == second.labels
    assert len(second.labels) == 1
    with pytest.raises(RuntimeError, match="closed"):
        rt.submit(imgs[:1])


def test_async_queue_full_rejection_is_explicit(small):
    _, model, imgs = small
    policy = ServePolicy(max_wait_ms=10_000.0, max_queue_images=3)
    with AsyncServeRuntime(model, policy=policy) as rt:
        kept = [rt.submit(imgs[i:i + 1]) for i in range(3)]
        with pytest.raises(QueueFull, match="max_queue_images=3"):
            rt.submit(imgs[3:4])
        assert rt.stats()["requests_rejected"] == 1
    # every ACCEPTED request still completed on drain
    assert all(len(k.result(timeout=1)) == 1 for k in kept)


def test_async_tail_smaller_than_smallest_bucket_pads(small):
    """A lone request below the smallest bucket is not starved: the window
    closes and it ships padded."""
    _, model, imgs = small
    with AsyncServeRuntime(model,
                           policy=ServePolicy(max_wait_ms=1.0)) as rt:
        req = rt.submit(imgs[:1])
        assert len(req.result(timeout=30)) == 1
        stats = rt.stats()
    assert stats["padded_rows"] == 1 and stats["total_rows"] == 2
    assert req.labels == np.asarray(model.classify(imgs[:1])).tolist()


def test_async_submit_door_validation_rejects_before_queueing(small):
    _, model, imgs = small
    with AsyncServeRuntime(model) as rt:
        with pytest.raises(ValueError, match=r"\(n, 16, 16, 3\)"):
            rt.submit(np.zeros((1, 8, 8, 3), np.uint8))
        with pytest.raises(ValueError, match="dtype"):
            rt.submit(imgs[:1].astype(np.float64))
        assert rt.stats()["queued_images"] == 0


def test_async_streaming_callback_per_image(small):
    _, model, imgs = small
    got, lock = [], threading.Lock()

    def on_image(rid, idx, label):
        with lock:
            got.append((rid, idx, label))

    with AsyncServeRuntime(model,
                           policy=ServePolicy(max_wait_ms=2.0)) as rt:
        req = rt.submit(imgs[:3], rid=0, on_image=on_image)
        labels = req.result(timeout=30)
    assert sorted(got) == [(0, i, labels[i]) for i in range(3)]


def test_async_streaming_callback_exception_does_not_kill_worker(small):
    """A raising user callback must not wedge the runtime: the future
    still resolves and later requests still serve."""
    _, model, imgs = small

    def bad(rid, idx, label):
        raise RuntimeError("user callback bug")

    with AsyncServeRuntime(model,
                           policy=ServePolicy(max_wait_ms=2.0)) as rt:
        r1 = rt.submit(imgs[:2], on_image=bad)
        assert len(r1.result(timeout=30)) == 2
        r2 = rt.submit(imgs[2:4])
        assert len(r2.result(timeout=30)) == 2
    assert rt.stats()["requests"] == 2


class FlakyModel:
    """CompiledModel stand-in whose step fails on demand — small enough to
    pin the runtime's failure semantics without a real compile."""
    buckets = (2,)

    def __init__(self):
        self.fail_next = 0

    def input_shape(self, bucket=None):
        return (2, 4, 4, 3)

    def step(self, batch):
        if self.fail_next:
            self.fail_next -= 1
            raise RuntimeError("step boom")
        return np.zeros((len(batch), 10), np.float32)


def test_async_step_failure_fails_that_batch_not_the_runtime():
    """A failing model step resolves the affected futures with the error
    (never a silent forever-block) and serving continues."""
    model = FlakyModel()
    model.fail_next = 1
    imgs = np.zeros((2, 4, 4, 3), np.uint8)
    with AsyncServeRuntime(model,
                           policy=ServePolicy(max_wait_ms=2.0)) as rt:
        bad = rt.submit(imgs)
        with pytest.raises(RuntimeError, match="step boom"):
            bad.result(timeout=10)
        ok = rt.submit(imgs)                  # the worker survived
        assert ok.result(timeout=10) == [0, 0]
        stats = rt.stats()
    assert stats["requests_failed"] == 1 and stats["requests"] == 1


def test_async_submits_from_many_threads(small):
    """The bounded queue really is thread-safe: concurrent submitters, all
    futures complete, labels match the single-threaded classify()."""
    _, model, imgs = small
    want = np.asarray(model.classify(imgs)).tolist()
    results = {}
    with AsyncServeRuntime(model,
                           policy=ServePolicy(max_wait_ms=2.0)) as rt:
        def worker(i):
            results[i] = rt.submit(imgs[i:i + 1], rid=i).result(timeout=30)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert {i: labs[0] for i, labs in results.items()} == \
        {i: want[i] for i in range(8)}


# ---------------------------------------------------------------------------
# loadgen: deterministic traces, open-loop metrics
# ---------------------------------------------------------------------------

def test_poisson_trace_deterministic_and_bounded():
    a = poisson_trace(rps=100, duration_s=1.0, seed=3,
                      images_per_request=(1, 3))
    b = poisson_trace(rps=100, duration_s=1.0, seed=3,
                      images_per_request=(1, 3))
    assert a == b and len(a) > 20
    assert all(0 < x.t_s < 1.0 and 1 <= x.n_images <= 3 for x in a)
    assert [x.t_s for x in a] == sorted(x.t_s for x in a)
    assert a != poisson_trace(rps=100, duration_s=1.0, seed=4,
                              images_per_request=(1, 3))
    with pytest.raises(ValueError, match="rps"):
        poisson_trace(rps=0, duration_s=1.0, seed=0)


def test_validate_trace_fails_loud():
    # non-monotonic timestamps: a loud ValueError naming the index — the
    # replay contract depends on arrival order, so never a silent sort
    with pytest.raises(ValueError, match="arrival 2 .* precedes"):
        validate_trace([Arrival(0.1, 1), Arrival(0.2, 1), Arrival(0.15, 1)])
    with pytest.raises(ValueError, match="n_images"):
        validate_trace([Arrival(0.1, 0)])
    with pytest.raises(ValueError, match="arrival 0"):
        validate_trace([Arrival(-0.1, 1)])
    # any sorted iterable works, including a generator
    got = validate_trace(Arrival(0.01 * k, 1) for k in range(5))
    assert len(got) == 5


def test_open_loop_rejects_unsorted_trace(small):
    _, model, _ = small
    bad = [Arrival(0.2, 1), Arrival(0.1, 1)]
    with AsyncServeRuntime(model, policy=ServePolicy()) as rt:
        with pytest.raises(ValueError, match="sorted"):
            run_open_loop(rt, bad, image_maker(model.input_shape()[1:],
                                               seed=0), slo_ms=100.0)


def test_burst_trace_deterministic_and_bursty():
    kw = dict(rps_on=200.0, on_s=0.1, off_s=0.3, duration_s=2.0, seed=7)
    a, b = burst_trace(**kw), burst_trace(**kw)
    assert a == b and len(a) > 10
    assert [x.t_s for x in a] == sorted(x.t_s for x in a)
    # every arrival lands inside an ON phase (OFF draws are discarded)
    assert all((x.t_s % 0.4) < 0.1 for x in a)
    # ON/OFF traffic disperses far above Poisson at the same mean rate
    mean_rps = len(a) / 2.0
    pois = poisson_trace(rps=mean_rps, duration_s=2.0, seed=7)
    d_burst = burstiness(a)["dispersion_index"]
    d_pois = burstiness(pois)["dispersion_index"]
    assert d_burst > 2.0 > d_pois
    assert burstiness(a)["peak_to_mean_rate"] > 1.5
    with pytest.raises(ValueError, match="rps_on"):
        burst_trace(rps_on=0, on_s=0.1, off_s=0.1, duration_s=1.0, seed=0)


def test_burstiness_degenerate_traces():
    assert burstiness([]) == {"dispersion_index": None,
                              "peak_to_mean_rate": None}
    # one window only: no variance to speak of
    assert burstiness([Arrival(0.01, 1)])["dispersion_index"] is None


def test_open_loop_metrics_carry_burstiness(small):
    _, model, _ = small
    trace = poisson_trace(rps=100, duration_s=0.5, seed=2)
    eng = MicroBatchEngine(model)
    m = run_open_loop(eng, trace, image_maker(model.input_shape()[1:],
                                              seed=3), slo_ms=10_000.0)
    assert m["dispersion_index"] is not None
    assert m["peak_to_mean_rate"] >= 1.0


def test_replay_decisions_bursty_shed_and_recovery():
    """The decision-table replay contract under ON/OFF traffic: the same
    trace + policy + service model produce the IDENTICAL table, the burst
    peak sheds (QueueFull) against the admission bound, and the queue
    recovers — every admitted image leaves the table."""
    trace = burst_trace(rps_on=400.0, on_s=0.05, off_s=0.2,
                        duration_s=0.5, seed=11)

    def table():
        return replay_decisions(trace, sched(max_wait_ms=5.0, depth=6),
                                service_s={2: 0.02, 8: 0.05})

    t1, t2 = table(), table()
    assert t1 == t2 and t1
    rejects = [r for r in t1 if r["event"] == "reject"]
    dispatches = [r for r in t1 if r["event"] == "dispatch"]
    assert rejects, "burst peak must shed against depth 6"
    assert len(rejects) < len(trace), "recovery: not everything sheds"
    # sheds happen at the bound, never beyond it
    assert all(r["backlog"] + r["images"] > 6 for r in rejects)
    # conservation: every admitted image is dispatched exactly once
    admitted = (sum(a.n_images for a in trace)
                - sum(r["images"] for r in rejects))
    assert sum(d["rows"] for d in dispatches) == admitted
    assert t1[-1]["event"] == "dispatch" and t1[-1]["backlog"] == 0


def test_replay_decisions_fleet_uses_both_replicas():
    trace = burst_trace(rps_on=400.0, on_s=0.05, off_s=0.2,
                        duration_s=0.5, seed=11)

    def table():
        s = fleet_sched(n=2, max_wait_ms=5.0, max_queue_images=6)
        return replay_decisions(trace, s, service_s={2: 0.02, 8: 0.05})

    t1, t2 = table(), table()
    assert t1 == t2
    dispatches = [r for r in t1 if r["event"] == "dispatch"]
    assert {d["replica"] for d in dispatches} == {0, 1}
    # two modeled workers drain the same bursts with fewer sheds than one
    one = replay_decisions(trace, sched(max_wait_ms=5.0, depth=6),
                           service_s={2: 0.02, 8: 0.05})
    sheds = sum(r["images"] for r in t1 if r["event"] == "reject")
    sheds_one = sum(r["images"] for r in one if r["event"] == "reject")
    assert sheds < sheds_one


def test_replay_decisions_validates_trace():
    with pytest.raises(ValueError, match="sorted"):
        replay_decisions([Arrival(0.2, 1), Arrival(0.1, 1)], sched(),
                         service_s={2: 0.01, 8: 0.01})


def test_service_snapshot_is_a_copy_and_feeds_replay():
    s = sched()
    s.observe_step(2, 0.02)
    s.observe_step(8, 0.05)
    snap = s.service_snapshot()
    assert snap == {2: pytest.approx(0.02), 8: pytest.approx(0.05)}
    snap[2] = 99.0                       # mutating the snapshot is safe
    assert s.service_estimate(2) == pytest.approx(0.02)
    # a snapshot is a ready-made service model for the replay
    table = replay_decisions([Arrival(0.001, 2)], sched(), service_s=snap)
    assert table and table[-1]["event"] == "dispatch"


def test_image_maker_deterministic(small):
    _, model, _ = small
    shape = model.input_shape()[1:]
    m1, m2 = image_maker(shape, seed=5), image_maker(shape, seed=5)
    exact(m1(0, 2), m2(0, 2))
    exact(m1(1, 1), m2(1, 1))
    assert m1(2, 3).shape == (3, *shape) and m1(2, 3).dtype == np.uint8


def test_open_loop_run_completes_everything(small):
    _, model, _ = small
    trace = poisson_trace(rps=200, duration_s=0.3, seed=0)
    policy = ServePolicy(max_wait_ms=5.0, slo_ms=500.0)
    with AsyncServeRuntime(model, policy=policy) as rt:
        m = run_open_loop(rt, trace,
                          image_maker(model.input_shape()[1:], seed=1),
                          slo_ms=500.0)
    assert m["requests_offered"] == len(trace)
    assert m["requests_accepted"] + m["requests_rejected"] == len(trace)
    assert m["requests_dropped"] == 0                 # accepted == promise
    assert m["images_completed"] == sum(
        len(r.labels) for r in rt.done)
    assert m["goodput_fps"] <= m["completed_fps"]
    assert m["latency_p99_s"] is not None
    assert 0.0 <= m["slo_attainment"] <= 1.0


def test_open_loop_trace_replays_bit_identical_through_sync_engine(small):
    """The loadgen's deterministic trace + image stream replayed through
    the SYNC engine produces the same labels the async run produced."""
    _, model, _ = small
    trace = [Arrival(t_s=0.001 * (k + 1), n_images=1 + k % 3)
             for k in range(6)]
    shape = model.input_shape()[1:]
    with AsyncServeRuntime(model,
                           policy=ServePolicy(max_wait_ms=2.0)) as rt:
        run_open_loop(rt, trace, image_maker(shape, seed=9), slo_ms=100.0)
    async_labels = {r.rid: r.labels for r in rt.done}
    make = image_maker(shape, seed=9)                 # fresh, same stream
    eng = MicroBatchEngine(model)
    for k, a in enumerate(trace):
        eng.submit(make(k, a.n_images))
    sync_labels = {r.rid: r.labels for r in eng.run()}
    assert sync_labels == async_labels


# ---------------------------------------------------------------------------
# runtime construction contract
# ---------------------------------------------------------------------------

def test_runtime_rejects_policy_and_scheduler_together(small):
    _, model, _ = small
    with pytest.raises(ValueError, match="either policy or"):
        AsyncServeRuntime(model, policy=ServePolicy(),
                          scheduler=ContinuousBatchingScheduler((2, 8)))


def test_runtime_close_idempotent_without_start(small):
    _, model, _ = small
    rt = AsyncServeRuntime(model)
    rt.close()                              # never started: no-op
    rt.close()
    with pytest.raises(RuntimeError, match="closed"):
        rt.submit(np.zeros((1, 16, 16, 3), np.uint8))


# ---------------------------------------------------------------------------
# the unified ServeClient surface: one protocol, one stats schema
# ---------------------------------------------------------------------------

def test_all_three_clients_satisfy_serve_client_protocol(small):
    _, model, _ = small
    eng = MicroBatchEngine(model)
    rt = AsyncServeRuntime(model)
    fleet = ServeFleet(model, replicas=2)
    for client in (eng, rt, fleet):
        assert isinstance(client, ServeClient), type(client)
    rt.close()
    fleet.close()


def test_stats_schema_shared_and_versioned(small):
    """Every client's stats() carries the same versioned core schema, so
    loadgen/bench drivers read any of the three without isinstance."""
    _, model, imgs = small
    shared = {"stats_version", "requests", "images", "batches", "fps",
              "occupancy", "pad_waste", "padded_rows", "total_rows",
              "buckets", "wall_s", "paper_fps", "realtime",
              "latency_p50_s", "latency_p95_s", "latency_p99_s",
              "latency_mean_s", "queue_depth_peak"}
    # queue_depth_peak joined the shared vocabulary in v2; v3 made the
    # latency_* fields histogram-backed (same keys, bounded approximation)
    # — pin the version so a schema change can't ship without bumping it
    assert SERVE_STATS_VERSION == 3
    eng = MicroBatchEngine(model)
    eng.submit(imgs[:2])
    eng.close()                             # protocol close == run()
    clients = {"engine": eng.stats()}
    with AsyncServeRuntime(model,
                           policy=ServePolicy(max_wait_ms=2.0)) as rt:
        rt.submit(imgs[:2]).result(timeout=30)
    clients["runtime"] = rt.stats()
    with ServeFleet(model, replicas=2,
                    policy=ServePolicy(max_wait_ms=2.0)) as fleet:
        fleet.submit(imgs[:2]).result(timeout=30)
    clients["fleet"] = fleet.stats()
    for name, st in clients.items():
        missing = shared - set(st)
        assert not missing, (name, missing)
        assert st["stats_version"] == SERVE_STATS_VERSION
        assert st["requests"] == 1 and st["images"] == 2
        assert st["queue_depth_peak"] >= 0
    # async surfaces add queue metrics; the fleet adds its replica table
    for name in ("runtime", "fleet"):
        assert {"queued_images", "requests_rejected",
                "requests_failed"} <= set(clients[name])
    assert clients["fleet"]["replicas"] == 2
    assert len(clients["fleet"]["replica_stats"]) == 2


def test_sync_engine_drives_run_open_loop(small):
    """The sync engine is a ServeClient too: the loadgen drives it through
    the same protocol (result() drains the queue in-thread)."""
    _, model, _ = small
    trace = [Arrival(t_s=0.001 * (k + 1), n_images=1 + k % 3)
             for k in range(5)]
    eng = MicroBatchEngine(model)
    m = run_open_loop(eng, trace, image_maker(model.input_shape()[1:],
                                              seed=11), slo_ms=10_000.0)
    assert m["requests_dropped"] == 0 and m["requests_rejected"] == 0
    assert m["images_completed"] == sum(a.n_images for a in trace)


# ---------------------------------------------------------------------------
# fleet scheduler: placement is pure and replays from a pinned table
# ---------------------------------------------------------------------------

def fleet_sched(n=2, max_wait_ms=10.0, **kw):
    return FleetScheduler((2, 8), ServePolicy(max_wait_ms=max_wait_ms, **kw),
                          n_replicas=n)


def test_fleet_placement_decision_table():
    s = fleet_sched(n=2)
    # no history: free replicas tie on estimate 0 -> lowest index, and the
    # base wait-vs-dispatch table is untouched
    d = s.decide(backlog=8, oldest_submit_s=0.0, now_s=0.0)
    assert (d.action, d.bucket, d.rows, d.replica) == ("dispatch", 8, 8, 0)
    assert s.decide(backlog=0, oldest_submit_s=None, now_s=0.0).action == \
        "idle"
    # replica 0 is observed slower than replica 1: placement flips
    s.observe_step(8, 0.040, replica=0)
    s.observe_step(8, 0.010, replica=1)
    d = s.decide(backlog=8, oldest_submit_s=0.0, now_s=0.0)
    assert d.replica == 1
    # the faster replica busy: the slower free one gets the chunk
    d = s.decide(backlog=8, oldest_submit_s=0.0, now_s=0.0,
                 busy=(False, True))
    assert d.replica == 0
    # everyone busy: a bounded wait, never a dispatch nobody can run
    d = s.decide(backlog=8, oldest_submit_s=0.0, now_s=0.0,
                 busy=(True, True))
    assert d.action == "wait" and d.reason == "all replicas busy"
    assert d.wait_s == pytest.approx(0.010)
    # wait/idle decisions replay identically given identical inputs
    assert s.decide(backlog=8, oldest_submit_s=0.0, now_s=0.0) == \
        s.decide(backlog=8, oldest_submit_s=0.0, now_s=0.0)


def test_fleet_placement_class_conditioned_estimates():
    """Sparse and dense traffic get separate per-replica EWMAs: the same
    bucket routes to different replicas depending on the occupancy class —
    SLO pressure places batches on the replica whose class estimate meets
    the deadline."""
    s = fleet_sched(n=2, sparse_occupancy=0.35)
    # replica 0 is fast on sparse batches, replica 1 fast on dense
    s.observe_step(2, 0.010, occupancy=0.1, replica=0)
    s.observe_step(2, 0.050, occupancy=0.8, replica=0)
    s.observe_step(2, 0.040, occupancy=0.1, replica=1)
    s.observe_step(2, 0.015, occupancy=0.8, replica=1)
    free = (False, False)
    assert s.place(2, busy=free, occupancy=0.1) == 0
    assert s.place(2, busy=free, occupancy=0.9) == 1
    # with no explicit occupancy the running EWMA picks the class
    assert s.replica_estimate(0, 2, 0.1) == pytest.approx(0.010)
    assert s.replica_estimate(1, 2, 0.9) == pytest.approx(0.015)
    # a fresh replica (no history) borrows the fleet-wide estimate
    s3 = fleet_sched(n=3)
    s3.observe_step(2, 0.020, replica=0)
    assert s3.replica_estimate(2, 2) == s3.service_estimate(2)


def test_fleet_scheduler_validates_busy_mask_and_counts():
    with pytest.raises(ValueError, match="n_replicas"):
        fleet_sched(n=0)
    s = fleet_sched(n=2)
    with pytest.raises(ValueError, match="busy mask"):
        s.decide(backlog=8, oldest_submit_s=0.0, now_s=0.0,
                 busy=(True,))


# ---------------------------------------------------------------------------
# fleet runtime: determinism, lifecycle, hot swap
# ---------------------------------------------------------------------------

def test_fleet_identical_trace_one_vs_n_replicas_bit_identical(small):
    """The tentpole acceptance property: the SAME request trace through 1,
    2, and 3 replicas yields bit-identical labels, all matching direct
    classify()."""
    _, model, imgs = small
    reqs = trace_requests(imgs)
    per_n = {}
    for n in (1, 2, 3):
        with ServeFleet(model, replicas=n,
                        policy=ServePolicy(max_wait_ms=2.0)) as fleet:
            handles = [fleet.submit(r) for r in reqs]
            per_n[n] = [h.result(timeout=30) for h in handles]
    assert per_n[1] == per_n[2] == per_n[3]
    want = np.asarray(model.classify(imgs)).tolist()
    flat = [lab for labs in per_n[2] for lab in labs]
    assert flat == want[:len(flat)]


@pytest.mark.parametrize("pace_fps", [None, 40.0], ids=["cpu", "paced"])
def test_fleet_cpu_replicas_take_turns(small, pace_fps):
    """On the CPU the replicas of a fleet step one at a time (the
    dispatcher holds the queue while a step runs, so two steps never
    trade the GIL at every op), and every request still gets
    ``classify``'s labels. Paced replicas, fixed-rate cores asleep for
    most of their slot, still overlap."""
    _, model, imgs = small
    lock = threading.Lock()
    live, peak = [0], [0]

    def counted(step):
        def run(batch):
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
            try:
                out = step(batch)
                time.sleep(0.01)       # widen the window two steps share
                return out
            finally:
                with lock:
                    live[0] -= 1
        return run

    fleet = ServeFleet(model, replicas=2, pace_fps=pace_fps,
                       policy=ServePolicy(max_wait_ms=1.0))
    for rep in fleet.replicas:
        rep.model.step = counted(rep.model.step)
    reqs = trace_requests(imgs)
    with fleet:
        handles = [fleet.submit(r) for r in reqs]
        got = [h.result(timeout=30) for h in handles]
    want = np.asarray(model.classify(imgs)).tolist()
    assert [lab for labs in got for lab in labs] == want[:sum(map(len, got))]
    if pace_fps is None:
        assert peak[0] == 1
    else:
        assert peak[0] == 2


def test_fleet_construction_contract(small):
    _, model, _ = small
    with pytest.raises(ValueError, match="replicas"):
        ServeFleet(model, replicas=0)
    with pytest.raises(ValueError, match="pace_fps"):
        ServeFleet(model, replicas=1, pace_fps=0)
    with pytest.raises(ValueError, match="either policy or"):
        ServeFleet(model, replicas=2, policy=ServePolicy(),
                   scheduler=FleetScheduler((2, 8), n_replicas=2))
    with pytest.raises(ValueError, match="placement"):
        ServeFleet(model, replicas=2,
                   scheduler=ContinuousBatchingScheduler((2, 8)))
    with pytest.raises(ValueError, match="2 replicas"):
        ServeFleet(model, replicas=3,
                   scheduler=FleetScheduler((2, 8), n_replicas=2))


def test_fleet_lifecycle_health_and_probe(small):
    _, model, imgs = small
    fleet = ServeFleet(model, replicas=2)
    assert all(r["state"] == "created"
               for r in fleet.health()["replicas"])
    fleet.start()
    h = fleet.health()
    assert all(r["state"] == "ready" and r["warmup_s"] is not None
               for r in h["replicas"])
    probes = fleet.probe()
    assert all(p["ok"] and p["probe_s"] is not None for p in probes)
    # drain replica 0: it takes no work, the fleet keeps serving
    fleet.drain_replica(0)
    assert fleet.submit(imgs[:3]).result(timeout=30) is not None
    h = fleet.health()
    assert h["replicas"][0]["state"] == "draining"
    assert h["replicas"][0]["steps"] == 0
    assert h["replicas"][1]["steps"] > 0
    fleet.resume_replica(0)
    assert fleet.health()["replicas"][0]["state"] == "ready"
    fleet.close()
    assert all(r["state"] == "stopped"
               for r in fleet.health()["replicas"])
    with pytest.raises(RuntimeError, match="closed"):
        fleet.submit(imgs[:1])


def test_fleet_hot_swap_under_load_keeps_every_promise(small):
    """Plan hot-swap mid-traffic: requests accepted before, during, and
    after the swap all resolve; post-swap labels are the NEW model's."""
    cfg, model, imgs = small
    model2 = port_model(42)
    policy = ServePolicy(max_wait_ms=2.0)
    with ServeFleet(model, replicas=2, policy=policy) as fleet:
        before = [fleet.submit(imgs[i:i + 2]) for i in (0, 2, 4)]
        fleet.swap(model2, timeout=30)
        after = [fleet.submit(imgs[i:i + 2]) for i in (6, 8)]
        for h in before + after:
            assert len(h.result(timeout=30)) == 2
    assert fleet.swaps == 1
    assert all(r["swaps"] == 1 for r in fleet.health()["replicas"])
    want = np.asarray(model2.classify(imgs)).tolist()
    assert [h.result() for h in after] == [want[6:8], want[8:10]]


def test_fleet_swap_rejects_incompatible_plan(small):
    cfg, model, _ = small
    other = port_model(0, buckets=(4,))
    with ServeFleet(model, replicas=1) as fleet:
        with pytest.raises(ValueError, match="bucket set"):
            fleet.swap(other)


def test_fleet_step_failure_contained_to_batch():
    """A failing replica step fails that batch's requests and counts on the
    replica's health row; the fleet keeps serving."""
    model = FlakyModel()
    model.fail_next = 1
    imgs = np.zeros((2, 4, 4, 3), np.uint8)
    with ServeFleet(model, replicas=2,
                    policy=ServePolicy(max_wait_ms=2.0)) as fleet:
        bad = fleet.submit(imgs)
        with pytest.raises(RuntimeError, match="step boom"):
            bad.result(timeout=10)
        ok = fleet.submit(imgs)
        assert ok.result(timeout=10) == [0, 0]
        stats = fleet.stats()
        health = fleet.health()
    assert stats["requests_failed"] == 1 and stats["requests"] == 1
    assert sum(r["failures"] for r in health["replicas"]) == 1


class RaceModel:
    """Forces two chunks of one request to be IN FLIGHT on two replicas at
    the same time (a barrier inside step), then fails the first
    ``fail_calls`` steps — the cross-replica failure-containment race."""
    buckets = (2,)

    def __init__(self, fail_calls=1):
        self.fail_calls = fail_calls
        self.barrier = threading.Barrier(2)
        self.lock = threading.Lock()
        self.calls = 0

    def input_shape(self, bucket=None):
        return (2, 4, 4, 3)

    def step(self, batch):
        with self.lock:
            self.calls += 1
            n = self.calls
        if n <= 2:
            self.barrier.wait(timeout=10)   # both chunks in flight together
            if n > self.fail_calls:
                time.sleep(0.05)   # lose the race: the purge lands first
        if n <= self.fail_calls:
            raise RuntimeError("step boom")
        return np.zeros((len(batch), 10), np.float32)


def test_fleet_cross_replica_failure_does_not_kill_fleet():
    """One request's chunks in flight on two replicas when one step fails:
    the surviving replica's completion must skip the purged bookkeeping,
    not KeyError into a whole-fleet abort."""
    model = RaceModel(fail_calls=1)
    imgs = np.zeros((4, 4, 4, 3), np.uint8)
    with ServeFleet(model, replicas=2,
                    policy=ServePolicy(max_wait_ms=1.0)) as fleet:
        bad = fleet.submit(imgs)        # 4 images -> two bucket-2 chunks
        with pytest.raises(RuntimeError, match="step boom"):
            bad.result(timeout=10)
        # bad's future fails the moment the FIRST chunk's step raises; the
        # surviving chunk is still in flight — wait for its completion
        # bookkeeping to land before judging fleet health (the pre-fix
        # KeyError->abort fires exactly there)
        deadline = time.time() + 5
        while time.time() < deadline and any(
                r._work is not None for r in fleet.replicas):
            time.sleep(0.01)
        ok = fleet.submit(imgs[:2])     # the fleet survived, still serves
        assert ok.result(timeout=10) == [0, 0]
        stats = fleet.stats()
    assert stats["requests_failed"] == 1
    assert stats["requests"] == 1


def test_fleet_same_request_failing_on_two_replicas_counts_once():
    """Both chunks of one request fail, on different replicas: the request
    fails once — failed_requests must not double-count the rid."""
    model = RaceModel(fail_calls=2)
    imgs = np.zeros((4, 4, 4, 3), np.uint8)
    with ServeFleet(model, replicas=2,
                    policy=ServePolicy(max_wait_ms=1.0)) as fleet:
        bad = fleet.submit(imgs)
        with pytest.raises(RuntimeError, match="step boom"):
            bad.result(timeout=10)
        ok = fleet.submit(imgs[:2])
        assert ok.result(timeout=10) == [0, 0]
        # bad's future fails on the FIRST chunk's _fail_batch; the second
        # replica's worker may still be landing its own failure bookkeeping
        # (failures += 1, then _work = None, under the lock) — wait for it
        deadline = time.time() + 5
        while time.time() < deadline and any(
                r._work is not None for r in fleet.replicas):
            time.sleep(0.005)
        stats = fleet.stats()
        health = fleet.health()
    assert stats["requests_failed"] == 1
    assert sum(r["failures"] for r in health["replicas"]) == 2


def test_fleet_close_resumes_drained_replicas(small):
    """close() finishes the drain even when the caller drained EVERY
    replica first: queued work still dispatches and every accepted
    request resolves (a fully-drained fleet must not hang close)."""
    _, model, imgs = small
    fleet = ServeFleet(model, replicas=2,
                       policy=ServePolicy(max_wait_ms=5.0)).start()
    fleet.drain_replica(0)
    fleet.drain_replica(1)
    req = fleet.submit(imgs[:3])
    fleet.close(timeout=30)
    assert len(req.result(timeout=1)) == 3
    assert fleet.stats()["requests_failed"] == 0


def test_fleet_queue_full_and_empty_request(small):
    _, model, imgs = small
    policy = ServePolicy(max_wait_ms=10_000.0, max_queue_images=3)
    with ServeFleet(model, replicas=2, policy=policy) as fleet:
        kept = [fleet.submit(imgs[i:i + 1]) for i in range(3)]
        with pytest.raises(QueueFull, match="max_queue_images=3"):
            fleet.submit(imgs[3:4])
        empty = fleet.submit(imgs[:0])
        assert empty.result(timeout=5) == []
    assert all(len(k.result(timeout=1)) == 1 for k in kept)
    assert fleet.stats()["requests_rejected"] == 1


def test_fleet_paced_replica_sweep_scales_goodput(small):
    """Paced replicas model fixed-rate cores: with the offered rate above
    one core's capacity, adding a second replica must raise goodput
    (the committed bench gates >= 1.5x; here >= 1.4 absorbs CI noise on a
    short trace) with zero drops and full SLO attainment."""
    _, model, _ = small
    policy = ServePolicy(max_wait_ms=10.0, slo_ms=1000.0,
                         max_queue_images=16)
    trace = poisson_trace(rps=40, duration_s=1.5, seed=5,
                          images_per_request=(1, 3))
    rows = run_replica_sweep(
        lambda n: ServeFleet(model, replicas=n, policy=policy,
                             pace_fps=40).start(),
        trace,
        lambda: image_maker(model.input_shape()[1:], seed=6),
        replica_counts=(1, 2), slo_ms=1000.0)
    assert [r["replicas"] for r in rows] == [1, 2]
    for r in rows:
        assert r["requests_dropped"] == 0
        assert r["slo_attainment"] == 1.0
    assert rows[0]["goodput_scaling"] == 1.0
    assert rows[1]["goodput_scaling"] >= 1.4, rows


# ---------------------------------------------------------------------------
# parity with the reference: traces, decision tables, served labels, stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("rps,dur,ipr", [(60.0, 3.0, (1, 3)),
                                         (300.0, 0.5, (1, 1)),
                                         (7.5, 10.0, (2, 5))])
def test_poisson_trace_and_burstiness_equal_the_reference(seed, rps, dur, ipr):
    ours = poisson_trace(rps=rps, duration_s=dur, seed=seed,
                         images_per_request=ipr)
    theirs = jpoisson_trace(rps=rps, duration_s=dur, seed=seed,
                            images_per_request=ipr)
    assert [(a.t_s, a.n_images) for a in ours] == \
        [(a.t_s, a.n_images) for a in theirs]
    for w in (0.05, 0.1, 1.0):
        assert burstiness(ours, window_s=w) == jburstiness(theirs,
                                                           window_s=w)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kw", [
    dict(rps_on=200.0, on_s=0.1, off_s=0.3, duration_s=2.0),
    dict(rps_on=400.0, on_s=0.05, off_s=0.2, duration_s=0.5,
         images_per_request=(1, 3)),
    dict(rps_on=50.0, on_s=0.2, off_s=0.1, duration_s=3.0, rps_off=5.0)],
    ids=["on-off", "short", "leaky"])
def test_burst_trace_equals_the_reference(seed, kw):
    ours = burst_trace(seed=seed, **kw)
    theirs = jburst_trace(seed=seed, **kw)
    assert [(a.t_s, a.n_images) for a in ours] == \
        [(a.t_s, a.n_images) for a in theirs]
    assert burstiness(ours) == jburstiness(theirs)


@pytest.mark.parametrize("shape", [(16, 16, 3), (224, 224, 3), (5, 7, 1)],
                         ids=["small", "paper", "odd"])
def test_image_maker_equals_the_reference(shape):
    ours, theirs = image_maker(shape, seed=5), jimage_maker(shape, seed=5)
    for k, n in enumerate((1, 3, 2, 1)):
        exact(ours(k, n), theirs(k, n))


def decision_traces():
    return {
        "poisson": jpoisson_trace(rps=300.0, duration_s=0.5, seed=4,
                                  images_per_request=(1, 3)),
        "burst": jburst_trace(rps_on=400.0, on_s=0.05, off_s=0.2,
                              duration_s=0.5, seed=11),
    }


@pytest.mark.parametrize("trace_name", ["poisson", "burst"])
@pytest.mark.parametrize("policy", [
    dict(max_wait_ms=5.0, max_queue_images=6),
    dict(max_wait_ms=10.0, slo_ms=30.0),
    dict(max_wait_ms=0.0, max_queue_images=512, sparse_occupancy=None)],
    ids=["shed", "slo", "no-wait"])
@pytest.mark.parametrize("replicas", [None, 2, 3], ids=["single", "fleet2",
                                                       "fleet3"])
def test_replay_decisions_equal_the_reference(trace_name, policy, replicas):
    """The same trace, policy and service model give the reference's full
    decision table, under the single scheduler and the fleet's."""
    trace = decision_traces()[trace_name]
    ours_trace = [Arrival(a.t_s, a.n_images) for a in trace]
    service = {2: 0.02, 8: 0.05}
    if replicas is None:
        ours = ContinuousBatchingScheduler((2, 8), ServePolicy(**policy))
        theirs = JScheduler((2, 8), JPolicy(**policy))
    else:
        ours = FleetScheduler((2, 8), ServePolicy(**policy),
                              n_replicas=replicas)
        theirs = JFleetScheduler((2, 8), JPolicy(**policy),
                                 n_replicas=replicas)
    table = replay_decisions(ours_trace, ours, service_s=service)
    want = jreplay_decisions(trace, theirs, service_s=service)
    assert table == want and table


def seeded_trace():
    return poisson_trace(rps=200.0, duration_s=0.15, seed=21,
                         images_per_request=(1, 3))


@pytest.fixture(scope="module")
def reference_run():
    """The reference's runtime serving the seeded trace on the same tree,
    int8 (its CPU ``packed`` backend: every int8 route is exact)."""
    model = jcompile(reference_tree(0), JCFG, JPlan(
        weight_dtype="int8", batch_buckets=(2, 8)), folded=True)
    model.warmup()
    with JRuntime(model, policy=JPolicy(max_wait_ms=2.0)) as rt:
        jrun_open_loop(rt, seeded_trace(), jimage_maker(
            model.input_shape()[1:], seed=22), slo_ms=10_000.0)
    labels = {r.rid: r.labels for r in rt.done}
    with JFleet(model, replicas=2, policy=JPolicy(max_wait_ms=2.0)) as fleet:
        fleet.submit(np.zeros((2, 16, 16, 3), np.uint8)).result(timeout=60)
    return labels, rt.stats(), fleet.stats()


@pytest.mark.parametrize("replicas", [1, 2], ids=["runtime", "fleet"])
def test_served_labels_and_stats_keys_equal_the_reference(small, replicas,
                                                          reference_run):
    """A seeded open-loop trace through the port's runtime, or its
    two-replica fleet: every request's labels equal ``classify`` of its
    images and the reference runtime's labels, the labels are not all one
    class, and the stats keys are the reference's (schema v3)."""
    _, model, _ = small
    want_labels, jrt_stats, jfleet_stats = reference_run
    trace = seeded_trace()
    make = image_maker(model.input_shape()[1:], seed=22)
    policy = ServePolicy(max_wait_ms=2.0)
    client = (AsyncServeRuntime(model, policy=policy) if replicas == 1
              else ServeFleet(model, replicas=2, policy=policy))
    images = {}

    def make_and_keep(k, n):
        images[k] = make(k, n)
        return images[k]

    with client:
        m = run_open_loop(client, trace, make_and_keep, slo_ms=10_000.0)
    assert m["requests_dropped"] == 0 and m["requests_rejected"] == 0
    got = {r.rid: r.labels for r in client.done}
    assert got == want_labels
    for rid, labs in got.items():
        assert labs == np.asarray(model.classify(images[rid])).tolist()
    assert len({lab for labs in got.values() for lab in labs}) > 1
    stats = client.stats()
    assert stats["stats_version"] == SERVE_STATS_VERSION == 3
    want = jrt_stats if replicas == 1 else jfleet_stats
    assert set(stats) == set(want)
    if replicas == 2:
        assert [set(r) for r in stats["replica_stats"]] == \
            [set(r) for r in want["replica_stats"]]
        assert set(client.health()) == {"replicas", "queued_images",
                                        "inflight_requests", "closing",
                                        "swaps"}


def test_fleet_replicas_share_weights_not_steps(small):
    """Thread-backed replicas share the template's folded tree but each
    gets a step lowered of its own (a graphed step's buffers serve one
    thread); the resolved plan is shared verbatim."""
    _, model, _ = small
    fleet = ServeFleet(model, replicas=3)
    models = [r.model for r in fleet.replicas]
    assert all(m.folded is model.folded for m in models)
    assert all(m.plan is model.plan for m in models)
    steps = {id(model._fwd), *(id(m._fwd) for m in models)}
    assert len(steps) == 4
    assert all(r.device is None for r in fleet.replicas)
    fleet.close()


def test_replica_devices_round_robin_over_a_device_list():
    devs = [torch.device("cuda", i) for i in range(3)]
    assert replica_devices(5, devs) == [devs[0], devs[1], devs[2], devs[0],
                                        devs[1]]
    assert replica_devices(2, devs[:1]) == [None, None]
    assert replica_devices(1, ["cuda:0", "cuda:1"]) == [devs[0]]
    assert serving_mesh(["cpu"]) == [torch.device("cpu")]
    if not torch.cuda.is_available():
        assert replica_devices(3) == [None] * 3   # one CPU: thread-backed
    with pytest.raises(ValueError, match="n >= 1"):
        replica_devices(0, devs)
    with pytest.raises(ValueError, match="at least one"):
        serving_mesh([])


@pytest.mark.parametrize("shape", [(8, 16, 16, 3), (3, 5, 7, 1), (1, 1, 1, 1),
                                   (2, 224, 224, 3), (13,), (0, 16, 16, 3)],
                         ids=["bucket", "odd", "one-byte", "paper", "flat",
                              "empty"])
@pytest.mark.parametrize("fill", ["random", "zeros", "ones"])
def test_batch_occupancy_equals_the_reference(shape, fill):
    """The byte popcount gives the reference's ``np.unpackbits`` mean as
    the same float, bit for bit."""
    rng = np.random.default_rng(len(shape) + sum(shape))
    arr = {"random": lambda: rng.integers(0, 256, shape, dtype=np.uint8),
           "zeros": lambda: np.zeros(shape, np.uint8),
           "ones": lambda: np.full(shape, 0xFF, np.uint8)}[fill]()
    got, want = batch_occupancy(arr), jbatch_occupancy(arr)
    assert type(got) is float and got == want
    assert batch_occupancy(list(arr)) == want


def test_launch_counts_are_locked_and_recorded_per_thread():
    """``count_launch`` ticks a wrapper's count under a lock, and the
    calling thread's open ``recording_launches`` only: a graph capture
    counts its own launches while other serving threads launch."""
    from repro_torch.kernels import _build, ops
    ops.reset_launch_counts()
    wrapper = ops.KERNELS["tflif"]
    barrier = threading.Barrier(4)
    recorded = {}

    def launch(i):
        barrier.wait(timeout=30)
        if i == 0:
            with ops.recording_launches() as counts:
                for _ in range(2000):
                    _build.count_launch(wrapper)
            recorded[i] = counts
        else:
            for _ in range(2000):
                _build.count_launch(wrapper)

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    try:
        assert ops.launch_counts()["tflif"] == 8000
        assert recorded[0] == {"tflif": 2000}
    finally:
        ops.reset_launch_counts()
