"""The port's training infrastructure against the JAX reference:
``optim.compression`` (``ef_compress`` bit for bit), ``data.pipeline``
(the LM sources bit for bit, the prefetching pipeline's exact restart),
``checkpoint.checkpointer`` (layout, atomicity, GC, checksums, async save,
and checkpoints crossing between the packages), ``runtime.
fault_tolerance`` (the reference's own cases, run on both packages) and
the ``launch.train`` CLI on the CPU with an injected failure.
"""
import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs.base import get_config as jget_config
from repro.data import pipeline as jpipeline
from repro.optim import compression as jcompression
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.nn import module
from repro_torch.optim import compression
from torch_threads import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def tree_np(tree):
    return {p: np.asarray(t) for p, t in module.tree_paths(tree)}


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _grads(seed):
    """Gradient-like leaves: ties at the top-k threshold, exact zeros,
    one all-zero leaf (the scale's 1e-12 floor), a 1-element leaf."""
    rng = np.random.default_rng(seed)
    big = rng.standard_normal((64, 96)).astype(np.float32)
    big[3, :40] = big[0, 0]                   # a 40-way tie
    big[5] = 0.0
    return {"a": {"w": big, "b": rng.standard_normal(37).astype(np.float32)
                  * 1e-6},
            "z": np.zeros((5, 3), np.float32),
            "s": np.array([2.5], np.float32)}


@pytest.mark.parametrize("method", ["int8", "topk"])
@pytest.mark.parametrize("topk_frac", [0.01, 0.3])
def test_ef_compress_bit_for_bit(method, topk_frac):
    """Two rounds (the second with the first's error feedback), f32 and
    bf16 gradients: the dequantized gradients and the feedback equal the
    reference's bit for bit."""
    for dtype in (np.float32, "bfloat16"):
        g0 = _grads(0)
        jgrads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x).astype(dtype), g0)
        tgrads = module.map_with_path(
            lambda _, x: torch.from_numpy(x).to(
                torch.bfloat16 if dtype == "bfloat16" else torch.float32),
            g0)
        jef, tef = jcompression.ef_init(jgrads), compression.ef_init(tgrads)
        for _ in range(2):
            jd, jef = jcompression.ef_compress(jgrads, jef, method=method,
                                               topk_frac=topk_frac)
            td, tef = compression.ef_compress(tgrads, tef, method=method,
                                              topk_frac=topk_frac)
            for want, got in ((jd, td), (jef, tef)):
                want = tree_np(jax.tree_util.tree_map(np.asarray, want))
                got = tree_np(got)
                assert list(got) == sorted(got)
                for p in want:
                    assert got[p].dtype == np.float32
                    np.testing.assert_array_equal(got[p], want[p], p)


def test_topk_keeps_ties_and_int8_rounds_half_to_even():
    x = torch.tensor([3.0, -3.0, 3.0, 1.0, 0.5, -2.0, 0.0, 1.0])
    ef = compression.ef_init({"x": x})
    d, e = compression.ef_compress({"x": x}, ef, method="topk",
                                   topk_frac=0.25)        # k = 2
    assert d["x"].tolist() == [3.0, -3.0, 3.0, 0, 0, 0, 0, 0]
    assert torch.equal(d["x"] + e["x"], x)
    # scale 127/127 = 1: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> -0
    y = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5])
    d, _ = compression.ef_compress({"y": y}, compression.ef_init({"y": y}))
    assert d["y"].tolist() == [127.0, 0.0, 2.0, 2.0, -0.0]
    with pytest.raises(ValueError):
        compression.ef_compress({"y": y}, compression.ef_init({"y": y}),
                                method="fp4")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_data_config_fields_are_the_reference_s_in_order():
    assert [(f.name, f.default) for f in
            dataclasses.fields(pipeline.DataConfig)] == \
        [(f.name, f.default) for f in
         dataclasses.fields(jpipeline.DataConfig)]
    args = (16, 4, 300, 9, "synthetic_lm", None, 8, 3, 1, 2, 5)
    assert dataclasses.asdict(pipeline.DataConfig(*args)) == \
        dataclasses.asdict(jpipeline.DataConfig(*args))


@pytest.mark.parametrize("kw", [dict(seq=32, global_batch=4, vocab=100),
                                dict(seq=8, global_batch=3, vocab=50000,
                                     seed=5),
                                dict(seq=300, global_batch=4, vocab=49152,
                                     seed=2, host_id=1, n_hosts=2)])
def test_synthetic_lm_batch_bit_for_bit(kw):
    for step in (0, 1, 17):
        want = jpipeline.synthetic_lm_batch(jpipeline.DataConfig(**kw), step)
        got = pipeline.synthetic_lm_batch(pipeline.DataConfig(**kw), step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("pl_name", ["reference", "port"])
def test_synthetic_rows_shorter_than_the_motif_raise(pl_name):
    """A reference fault kept bit for bit (ROADMAP §3): below seq 8 the
    motif (at least 8 tokens) does not fit the row and numpy refuses the
    copy, in both packages."""
    pl = {"reference": jpipeline, "port": pipeline}[pl_name]
    with pytest.raises(ValueError, match="broadcast"):
        pl.synthetic_lm_batch(pl.DataConfig(seq=3, global_batch=1), 0)


def test_token_file_source_bit_for_bit(tmp_path):
    path = tmp_path / "toks.bin"
    np.random.default_rng(0).integers(0, 2**31, 5000).astype(
        np.uint32).tofile(path)
    for kw in (dict(seq=9, global_batch=2), dict(seq=63, global_batch=6,
                                                  host_id=2, n_hosts=3)):
        kw = dict(kw, kind="token_file", path=str(path))
        want = jpipeline.TokenFileSource(jpipeline.DataConfig(**kw))
        got = pipeline.TokenFileSource(pipeline.DataConfig(**kw))
        assert got.n_windows == want.n_windows
        for step in (0, 3, 1000):
            w, g = want.batch(step), got.batch(step)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


# the reference's tests/test_data_checkpoint.py data cases, on both packages
PIPELINES = {"reference": jpipeline, "port": pipeline}


@pytest.fixture(params=list(PIPELINES))
def pl(request):
    return PIPELINES[request.param]


def test_synthetic_deterministic(pl):
    cfg = pl.DataConfig(seq=32, global_batch=4, vocab=100, seed=7)
    a = pl.synthetic_lm_batch(cfg, step=3)
    b = pl.synthetic_lm_batch(cfg, step=3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = pl.synthetic_lm_batch(cfg, step=4)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_labels_are_shifted_tokens(pl):
    cfg = pl.DataConfig(seq=32, global_batch=2, vocab=100)
    b = pl.synthetic_lm_batch(cfg, 0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_sharding_disjoint_and_consistent(pl):
    g = pl.DataConfig(seq=16, global_batch=4, vocab=50, seed=1)
    h0 = pl.DataConfig(seq=16, global_batch=4, vocab=50, seed=1, host_id=0,
                       n_hosts=2)
    h1 = pl.DataConfig(seq=16, global_batch=4, vocab=50, seed=1, host_id=1,
                       n_hosts=2)
    full = pl.synthetic_lm_batch(g, 5)["tokens"]
    part0 = pl.synthetic_lm_batch(h0, 5)["tokens"]
    part1 = pl.synthetic_lm_batch(h1, 5)["tokens"]
    np.testing.assert_array_equal(np.concatenate([part0, part1]), full)


def test_pipeline_restart_exact(pl):
    cfg = pl.DataConfig(seq=16, global_batch=2, vocab=64, seed=3, prefetch=1)
    p = pl.DataPipeline(cfg)
    for _ in range(5):
        next(p)
    state = p.state_dict()
    nxt = next(p)
    p.close()

    q = pl.DataPipeline.restore(cfg, state)
    resumed = next(q)
    q.close()
    np.testing.assert_array_equal(np.asarray(nxt["tokens"]),
                                  np.asarray(resumed["tokens"]))


def test_token_file_source(pl, tmp_path):
    path = tmp_path / "toks.bin"
    np.arange(1000, dtype=np.uint32).tofile(path)
    cfg = pl.DataConfig(seq=9, global_batch=2, kind="token_file",
                        path=str(path))
    src = pl.TokenFileSource(cfg)
    b = src.batch(0)
    assert b["tokens"].shape == (2, 9)
    np.testing.assert_array_equal(b["tokens"][0], np.arange(9))
    np.testing.assert_array_equal(b["labels"][0], np.arange(1, 10))


def test_image_batch_learnable_structure(pl):
    cfg = pl.DataConfig(global_batch=8, kind="images", image_size=16,
                        n_classes=4)
    b = pl.image_batch(cfg, 0)
    assert b["image"].shape == (8, 16, 16, 3) and b["image"].dtype == np.uint8
    assert set(np.unique(b["label"])) <= set(range(4))


@pytest.mark.parametrize("kind", ["synthetic_lm", "token_file", "images"])
def test_pipeline_hands_over_the_reference_s_batches_as_tensors(kind,
                                                                 tmp_path):
    path = tmp_path / "toks.bin"
    np.arange(3000, dtype=np.uint32).tofile(path)
    kw = dict(seq=12, global_batch=3, vocab=77, seed=4, kind=kind,
              path=str(path), image_size=8, prefetch=3)
    want = jpipeline.DataPipeline(jpipeline.DataConfig(**kw), start_step=2)
    got = pipeline.DataPipeline(pipeline.DataConfig(**kw), start_step=2,
                                device="cpu")
    try:
        for _ in range(4):
            w, g = next(want), next(got)
            assert g.keys() == w.keys()
            for k in w:
                assert isinstance(g[k], torch.Tensor)
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
        assert got.state_dict() == want.state_dict() == {"step": 6,
                                                         "seed": 4}
    finally:
        want.close()
        got.close()
    assert not got._thread.is_alive()
    with pytest.raises(ValueError, match="different data seed"):
        pipeline.DataPipeline.restore(pipeline.DataConfig(**kw),
                                      {"step": 1, "seed": 5})


# ---------------------------------------------------------------------------
# checkpointer
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layer": {"w": torch.randn(4, 4, generator=g),
                      "b": torch.zeros(4)},
            "half": torch.randn(3, 5, generator=g).bfloat16(),
            "step_count": torch.tensor(7, dtype=torch.int32)}


def _assert_equal_trees(got, want):
    assert [p for p, _ in module.tree_paths(got)] == \
        [p for p, _ in module.tree_paths(want)]
    for (p, g), (_, w) in zip(module.tree_paths(got),
                              module.tree_paths(want)):
        assert g.dtype == w.dtype and torch.equal(g, w), p


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(10, tree, extra={"data": {"step": 10, "seed": 0}}, block=True)
    assert ck.latest_step() == 10
    skel = module.map_with_path(lambda _, t: t.to("meta"), tree)
    got, extra = ck.restore(skeleton=skel)
    _assert_equal_trees(got, tree)
    assert extra["data"]["step"] == 10
    flat, _ = ck.restore()
    assert sorted(flat) == ["half", "layer/b", "layer/w", "step_count"]
    man = json.loads((tmp_path / "step_00000010" / "manifest.json")
                     .read_text())
    assert man["leaves"]["half"]["dtype"] == "bfloat16"
    assert man["leaves"]["layer/w"]["file"] == "layer.w.npy"
    bad = dict(skel, layer={"w": torch.empty(2, 2, device="meta"),
                            "b": skel["layer"]["b"]})
    with pytest.raises(ValueError, match="layer/w"):
        ck.restore(skeleton=bad)


def test_save_snapshots_before_returning(tmp_path):
    """The host copy is taken inside ``save``: writing the tree after it
    returns (a CPU tensor's ``.cpu()`` would be itself) changes nothing."""
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    want = module.map_with_path(lambda _, t: t.clone(), tree)
    ck.save(1, tree)
    for _, t in module.tree_paths(tree):
        t.add_(1)
    ck.wait()
    got, _ = ck.restore(skeleton=want)
    _assert_equal_trees(got, want)


def test_atomicity_tmp_dirs_invisible(tmp_path):
    ck = Checkpointer(str(tmp_path))
    bad = tmp_path / "step_00000099.tmp"
    bad.mkdir()
    (bad / "x.npy").write_bytes(b"junk")
    bad2 = tmp_path / "step_00000098"
    bad2.mkdir()
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()
    ck.save(5, _tree(), block=True)
    assert ck.latest_step() == 5
    assert not (tmp_path / "step_00000005.tmp").exists()


def test_gc_keeps_newest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(), block=True)
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]


def test_checksum_detects_corruption(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(), block=True)
    f = tmp_path / "step_00000001" / "layer.w.npy"
    arr = np.load(f)
    arr[0, 0] += 1.0
    np.save(f, arr)
    with pytest.raises(IOError, match="checksum"):
        ck.restore(skeleton=_tree())
    ck.restore(skeleton=_tree(), verify=False)


def test_async_save_does_not_block_and_surfaces_errors(tmp_path):
    ck = Checkpointer(str(tmp_path))
    big = {"w": torch.zeros(2000, 2000)}
    t0 = time.time()
    ck.save(1, big)
    t_return = time.time() - t0
    ck.wait()
    assert t_return < 1.0
    assert ck.latest_step() == 1
    # a writer that fails: wait() raises its error
    (tmp_path / "step_00000002.tmp").write_text("a file, not a directory")
    ck.save(2, big)
    with pytest.raises(OSError):
        ck.wait()


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jtree = {"layer": {"w": jax.random.normal(jax.random.PRNGKey(0), (4, 4)),
                       "b": jnp.arange(4.0)},
             "step_count": jnp.int32(7)}
    JCheckpointer(str(tmp_path)).save(3, jtree, extra={"step": 3},
                                      block=True)
    skel = {"layer": {"w": torch.empty(4, 4, device="meta"),
                      "b": torch.empty(4, device="meta")},
            "step_count": torch.empty((), device="meta")}
    got, extra = Checkpointer(str(tmp_path)).restore(skeleton=skel)
    assert extra == {"step": 3}
    for p, want in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        path = "/".join(str(k.key) for k in p)
        g = dict(module.tree_paths(got))[path]
        assert str(g.dtype).removeprefix("torch.") == str(want.dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree()
    del tree["half"]            # numpy has no bf16 of its own
    Checkpointer(str(tmp_path)).save(4, tree, extra={"step": 4}, block=True)
    ref = JCheckpointer(str(tmp_path))
    assert ref.latest_step() == 4
    skel = jax.tree_util.tree_map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.dtype(
            str(t.dtype).removeprefix("torch."))), tree)
    got, extra = ref.restore(skeleton=skel)
    assert extra == {"step": 4}
    for p, t in module.tree_paths(tree):
        leaf = got
        for k in p.split("/"):
            leaf = leaf[k]
        np.testing.assert_array_equal(np.asarray(leaf), t.numpy())


def test_bf16_leaf_has_the_reference_s_bytes_and_checksum(tmp_path):
    """A bf16 leaf saved by the port is stored as its uint16 bits, whose
    bytes and crc32 are those of the reference's ml_dtypes array."""
    x = torch.randn(6, 7, generator=torch.Generator().manual_seed(1))
    Checkpointer(str(tmp_path)).save(1, {"x": x.bfloat16()}, block=True)
    man = json.loads((tmp_path / "step_00000001" / "manifest.json")
                     .read_text())
    ref = np.asarray(jnp.asarray(x.numpy()).astype(jnp.bfloat16))
    stored = np.load(tmp_path / "step_00000001" / "x.npy")
    assert stored.tobytes() == ref.tobytes()
    assert man["leaves"]["x"]["crc32"] == zlib.crc32(ref.tobytes())


# ---------------------------------------------------------------------------
# fault tolerance: the reference's tests/test_fault_tolerance.py cases
# ---------------------------------------------------------------------------

@pytest.fixture(params=["repro", "repro_torch"])
def ft(request):
    return importlib.import_module(
        f"{request.param}.runtime.fault_tolerance")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_heartbeat_detects_silence(ft):
    clk = FakeClock()
    hb = ft.HeartbeatMonitor(n_nodes=4, timeout_s=10.0, clock=clk)
    clk.advance(5)
    for n in (0, 1, 3):
        hb.beat(n)
    clk.advance(7)
    assert hb.dead_nodes() == [2]
    assert not hb.healthy()
    hb.beat(2)
    assert 2 not in hb.dead_nodes()


def test_straggler_needs_patience(ft):
    det = ft.StragglerDetector(n_nodes=8, z_thresh=4.0, patience=3)
    base = [1.0] * 8
    assert det.update(base) == []
    slow = base.copy()
    slow[5] = 3.0
    assert det.update(slow) == []
    assert det.update(slow) == []
    assert det.update(slow) == [5]


def test_straggler_recovers(ft):
    det = ft.StragglerDetector(n_nodes=4, patience=3)
    det.update([1, 1, 1, 5.0])
    for _ in range(16):
        out = det.update([1, 1, 1, 1.0])
    assert out == []


def test_restart_policy_budget_window(ft):
    clk = FakeClock()
    pol = ft.RestartPolicy(max_restarts=2, window_s=100, backoff_s=1,
                           clock=clk)
    assert pol.record_failure()
    assert pol.record_failure()
    assert not pol.record_failure()
    clk.advance(200)
    assert pol.record_failure()


def test_restart_backoff_grows_and_caps(ft):
    pol = ft.RestartPolicy(backoff_s=2, backoff_mult=3, max_backoff_s=10)
    pol.record_failure()
    assert pol.next_delay() == 2
    pol.record_failure()
    assert pol.next_delay() == 6
    pol.record_failure()
    assert pol.next_delay() == 10


def test_loss_guard(ft):
    g = ft.LossGuard(spike_mult=5.0, warmup=2)
    assert g.check(4.0) and g.check(3.0) and g.check(2.0)
    assert not g.check(float("nan"))
    assert not g.check(math.inf)
    assert g.check(3.0)
    assert not g.check(11.0)


def test_supervisor_restores_and_completes(ft):
    log = []
    ckpt = {"step": 0}

    def make_state(restore):
        if restore is None:
            return {"step": 0}
        log.append(("restore", ckpt["step"]))
        return {"step": ckpt["step"]}

    fails = {5: True, 8: True}

    def run_segment(state):
        for step in range(state["step"], 12):
            if fails.pop(step, False):
                raise ft.NodeFailure(step)
            ckpt["step"] = step + 1
            log.append(("step", step))
        return None

    sup = ft.TrainSupervisor(ft.RestartPolicy(backoff_s=0), make_state,
                             run_segment, sleep=lambda s: None)
    assert sup.run() == {"restarts": 2, "completed": True}
    steps = [s for kind, s in log if kind == "step"]
    assert steps == sorted(steps) and steps[-1] == 11
    assert ("restore", 5) in log and ("restore", 8) in log


def test_supervisor_gives_up_when_budget_spent(ft):
    sup = ft.TrainSupervisor(
        ft.RestartPolicy(max_restarts=3, backoff_s=0), lambda r: {},
        lambda s: (_ for _ in ()).throw(ft.NodeFailure("always")),
        sleep=lambda s: None)
    out = sup.run()
    assert out["completed"] is False
    assert out["restarts"] == 3


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

def _run(argv, capsys):
    log = train.main(argv)
    lines = capsys.readouterr().out.splitlines()
    return log, lines


TRAIN_ARGS = ["--arch", "smollm-360m", "--reduce", "--device", "cpu",
              "--steps", "6", "--global-batch", "4", "--seq", "16",
              "--microbatch", "2", "--warmup", "2", "--lr", "1e-3",
              "--log-every", "1"]


def test_train_cli_recovers_an_injected_failure(tmp_path, capsys):
    """An uninterrupted run and one that fails at step 4: the second
    restores step 3's checkpoint (params, moments, data position) and
    logs the same losses as the first from there, exactly on the CPU; the
    loss falls; no ``.tmp`` is left and at most ``keep`` commits remain."""
    clean, _ = _run(TRAIN_ARGS + ["--ckpt-dir", str(tmp_path / "a"),
                                  "--ckpt-every", "3"], capsys)
    failed, lines = _run(TRAIN_ARGS + [
        "--ckpt-dir", str(tmp_path / "b"), "--ckpt-every", "3",
        "--inject-failure-at", "4", "--metrics-out",
        str(tmp_path / "m.json")], capsys)
    assert json.loads(lines[-1]) == {"result": {"restarts": 1,
                                                "completed": True}}
    assert f"[restore] step 3 from {tmp_path / 'b'}" in lines
    assert [r["step"] for r in clean] == list(range(6))
    assert [r["step"] for r in failed] == [0, 1, 2, 3, 3, 4, 5]
    by_step = {r["step"]: r for r in failed}       # the last record a step
    for r in clean:
        for k in ("loss", "grad_norm", "lr"):
            assert by_step[r["step"]][k] == r[k], (r, by_step[r["step"]])
    assert clean[-1]["loss"] < clean[0]["loss"]
    assert json.loads((tmp_path / "m.json").read_text()) == failed
    for d in ("a", "b"):
        names = sorted(p.name for p in (tmp_path / d).iterdir())
        assert names == ["step_00000003", "step_00000006"]


def test_train_cli_restart_waits_for_the_save_in_flight(tmp_path, capsys,
                                                       monkeypatch):
    """The failure lands while step 3's save is still being written (each
    leaf's write slowed to 50 ms): the restart commits that save first and
    restores it, rather than finding no checkpoint and starting over (the
    reference's ``make_state`` looks without waiting: ROADMAP §3)."""
    from repro_torch.checkpoint import checkpointer
    real = checkpointer.np.save

    def slow(*a, **kw):
        time.sleep(0.05)
        return real(*a, **kw)

    monkeypatch.setattr(checkpointer.np, "save", slow)
    log, lines = _run(TRAIN_ARGS + [
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
        "--inject-failure-at", "4"], capsys)
    assert f"[restore] step 3 from {tmp_path}" in lines
    assert [r["step"] for r in log] == [0, 1, 2, 3, 3, 4, 5]


def test_train_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    """``--resume`` continues a finished run's checkpoint; the data
    position comes back with it."""
    ck = str(tmp_path / "ck")
    _run(TRAIN_ARGS[:-6] + ["--steps", "2", "--ckpt-dir", ck,
                            "--ckpt-every", "1"], capsys)
    log, lines = _run(TRAIN_ARGS[:-6] + ["--steps", "3", "--ckpt-dir", ck,
                                         "--resume"], capsys)
    assert f"[restore] step 2 from {ck}" in lines
    assert [r["step"] for r in log] == [2]
    man = json.loads((pathlib.Path(ck) / "step_00000003" / "manifest.json")
                     .read_text())
    assert man["extra"] == {"step": 3, "data": {"step": 3, "seed": 0}}


@pytest.mark.parametrize("arch,extra", [
    ("qwen3-moe-30b-a3b", ["--compression", "int8"]),
    ("mamba2-130m", ["--compression", "topk"]),
    ("hymba-1.5b", []),
    ("whisper-large-v3", []),
    ("qwen2-vl-7b", ["--microbatch", "1"])])
def test_train_cli_runs_every_ported_family(arch, extra, capsys):
    log, lines = _run(["--arch", arch, "--reduce", "--device", "cpu",
                       "--steps", "2", "--global-batch", "2", "--seq", "16",
                       "--log-every", "1"] + extra, capsys)
    assert json.loads(lines[-1]) == {"result": {"restarts": 0,
                                                "completed": True}}
    assert len(log) == 2 and all(math.isfinite(r["loss"]) for r in log)


def test_train_cli_refuses_unported_families():
    with pytest.raises(KeyError, match="names no ArchConfig"):
        train.main(["--arch", "spikformer-v2", "--reduce",
                    "--device", "cpu"])


def test_train_lm_100m_example_drives_the_port(monkeypatch):
    """The example registers the reference example's ``lm-100m`` and
    hands ``train.main`` the reference example's arguments (plus
    ``--device``)."""
    spec = importlib.util.spec_from_file_location(
        "_ex_lm100m", ROOT / "examples" / "torch_train_lm_100m.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ref = jget_config("smollm-360m")    # registers nothing; the field list
    want = dict(name="lm-100m", family="dense", n_layers=16, d_model=768,
                n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32000,
                tie_embeddings=True, remat=False)
    got = dataclasses.asdict(mod.CONFIG)
    assert {k: got[k] for k in want} == want
    assert set(got) <= set(dataclasses.asdict(ref))
    seen = []
    monkeypatch.setattr(mod.train, "main", lambda argv: seen.append(argv))
    mod.main(["--steps", "7", "--ckpt-dir", "/ck", "--device", "cpu"])
    assert seen == [["--arch", "lm-100m", "--steps", "7", "--seq", "256",
                     "--global-batch", "8", "--microbatch", "4",
                     "--lr", "6e-4", "--warmup", "50", "--ckpt-dir", "/ck",
                     "--ckpt-every", "100", "--log-every", "10",
                     "--device", "cpu"]]
