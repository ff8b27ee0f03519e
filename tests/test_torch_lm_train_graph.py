"""The port's LM train step as the reference jits it
(``jax.jit(make_train_step(...), donate_argnums=(0, 1))``), pinned on the
CPU, where no CUDA graph can be captured: ``steps.graph_train_step``'s
in-place body, which the card records as one graph, equals the functional
``make_train_step`` bit for bit for every ported family and the
compression and bf16-moment cases; its dense cases stay within
``test_torch_lm_train.py::test_three_train_steps_match_reference``'s
tolerances of the reference's ``jax.jit`` step; the body makes no host
read; the state it owns never moves; and ``train.main`` restarts into it
bit for bit. (The mesh's body against the functional ``jit_train_step``
runs in ``tests/sharded_steps_worker.py``.)

Trees come from the reference's seeded ``init_model`` carried across by
``weights.lm_from_reference``, batches from the reference's
``synthetic_lm_batch`` plus seeded stub modality inputs
(``test_torch_lm_train.py``'s helpers), a global batch of 4 in
microbatches of 2."""
import contextlib
import dataclasses
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.nn import module as jmodule
from repro.optim import adamw as jadamw
from repro.optim.compression import ef_init as jef_init
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.device import TrainStep
from repro_torch.launch import steps, train
from repro_torch.nn import module
from repro_torch.optim import adamw
from repro_torch.optim.compression import ef_init
from test_torch_lm_train import (INT8_MISS_FRACTION, TOL, cfgs, lm_batch,
                                 trees)
from torch_threads import one_thread  # noqa: F401  (autouse)

STEPS = 3
# case -> (family, compression, moment dtype)
CASES = {"dense": ("dense", "none", "float32"),
         "moe": ("moe", "none", "float32"),
         "ssm": ("ssm", "none", "float32"),
         "hybrid": ("hybrid", "none", "float32"),
         "encdec": ("encdec", "none", "float32"),
         "vlm": ("vlm", "none", "float32"),
         "dense_int8": ("dense", "int8", "float32"),
         "dense_topk": ("dense", "topk", "float32"),
         "dense_bf16_moments": ("dense", "none", "bfloat16")}
DENSE_CASES = [c for c, (f, _, _) in CASES.items() if f == "dense"]
OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=4)


def setup(case, **cfg_kw):
    """The case's config, settings, a fresh copy of its seeded tree with
    moments (and error feedback), and STEPS batches (port side)."""
    family, comp, sdt = CASES[case]
    jcfg, cfg = cfgs(family, opt_state_dtype=sdt, **cfg_kw)
    ts = steps.TrainSettings(microbatch=2, compression=comp,
                             opt=adamw.OptConfig(**OPT))
    batches = [lm_batch(cfg.padded_vocab, step=i, batch=4, seed=2,
                        family=family)[1] for i in range(STEPS)]

    def state():
        _, tp = trees(family)
        params = module.map_with_path(lambda _, t: t.clone(), tp)
        opt = adamw.init(params, steps.opt_config(cfg, ts))
        if comp != "none":
            opt["ef"] = ef_init(params)
        return params, opt

    return jcfg, cfg, ts, state, batches


def functional_run(cfg, ts, state, batches):
    params, opt = state()
    step = steps.make_train_step(cfg, ts)
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        metrics.append(m)
    return params, opt, metrics


def body_run(cfg, ts, state, batches):
    """``graph_train_step`` on the CPU: the in-place body, eagerly."""
    params, opt = state()
    step = steps.graph_train_step(cfg, ts, device="cpu")
    assert not step.graphed
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        metrics.append({k: v.clone() for k, v in m.items()})
    assert params is step.params and opt is step.opt
    return params, opt, metrics


@pytest.mark.parametrize("case", list(CASES))
def test_in_place_body_equals_the_functional_step(case):
    """Three steps of the body against three of ``make_train_step`` from
    the same tree and batches: every loss, gradient norm and learning
    rate, and at the end every param, moment, the step counter and the
    error feedback, bit for bit."""
    _, cfg, ts, state, batches = setup(case)
    want_p, want_o, want_m = functional_run(cfg, ts, state, batches)
    got_p, got_o, got_m = body_run(cfg, ts, state, batches)
    for i, (g, w) in enumerate(zip(got_m, want_m)):
        assert sorted(g) == sorted(steps.TRAIN_METRICS)
        for k in steps.TRAIN_METRICS:
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), \
                (i, k)
    want = dict(module.tree_paths({"p": want_p, "o": want_o}))
    got = dict(module.tree_paths({"p": got_p, "o": got_o}))
    assert list(got) == list(want)
    for p, g in got.items():
        assert g.dtype == want[p].dtype and torch.equal(g, want[p]), p
    assert int(got_o["step"]) == STEPS
    assert ("o/ef/embed/embedding" in got) == (CASES[case][1] != "none")


@pytest.mark.parametrize("case", DENSE_CASES)
def test_body_tracks_the_reference_jit_step(case):
    """The body's three steps in f32 compute against the reference's
    ``jax.jit`` step within ``test_three_train_steps_match_reference``'s
    bars: losses, gradient norms and learning rates within rtol 1e-5,
    params, moments and error feedback within 1e-4 (int8: at most 1 in
    10^4 elements outside it)."""
    family, comp, sdt = CASES[case]
    jcfg, cfg, ts, state, _ = setup(case, compute_dtype="float32")
    jp, _ = trees(family)
    jts = jsteps.TrainSettings(microbatch=2, compression=comp,
                               opt=jadamw.OptConfig(**OPT))
    jo = jadamw.init(jp, dataclasses.replace(jts.opt,
                                             state_dtype=jnp.dtype(sdt)))
    if comp != "none":
        jo["ef"] = jef_init(jp)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jts))
    step = steps.graph_train_step(cfg, ts, device="cpu")
    tp, to = state()
    for i in range(STEPS):
        jb, tb = lm_batch(cfg.padded_vocab, step=i, batch=4, seq=32, seed=2)
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, m = step(tp, to, tb)
        for k in steps.TRAIN_METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    want = dict(jmodule.tree_paths({"p": jp, "o": jo}))
    got = dict(module.tree_paths({"p": tp, "o": to}))
    assert list(got) == list(want)
    misses = total = 0
    for path, t in got.items():
        w = np.asarray(want[path], np.float64)
        bad = np.abs(t.double().numpy() - w) > TOL + TOL * np.abs(w)
        if comp != "int8":
            assert not bad.any(), path
        misses += int(bad.sum())
        total += w.size
    assert misses <= INT8_MISS_FRACTION * total, (misses, total)


def _host_read(*_args, **_kw):
    raise AssertionError("a host read in the training step's body")


HOST_READS = ("item", "tolist", "cpu", "numpy", "nonzero", "__int__",
              "__float__", "__index__", "__bool__")


@pytest.mark.parametrize("case", list(CASES))
def test_body_makes_no_host_read(case, monkeypatch):
    """The body runs a step with every way of reading a tensor on the
    host patched to raise, and gives what it gives unpatched; the same
    patch stops a body whose learning rate reads the step counter on the
    host."""
    _, cfg, ts, state, batches = setup(case)
    want = functional_run(cfg, ts, state, batches[:1])[2][0]
    step = steps.graph_train_step(cfg, ts, device="cpu")
    step.own(*state())
    batch = step._batch(batches[0])
    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, _host_read)
    got = {k: v.clone() for k, v in step.body(batch).items()}
    monkeypatch.setattr(adamw, "schedule", lambda cfg, count: torch.tensor(
        cfg.peak_lr * min(1.0, int(count) / cfg.warmup_steps)))
    with pytest.raises(AssertionError, match="host read"):
        step.body(batch)
    monkeypatch.undo()
    assert all(torch.equal(got[k], want[k]) for k in steps.TRAIN_METRICS)


def addresses(step):
    return [(p, t.data_ptr()) for p, t in module.tree_paths(
        {"p": step.params, "o": step.opt, "m": step.metrics})]


def test_owned_state_never_moves():
    """The first call's trees become the step's own (donated, not
    copied); the params, moments, counter and metric tensors keep their
    addresses across steps and across a call with another tree, which
    copies that tree in (left as it was) and steps from it as the
    functional step does."""
    _, cfg, ts, state, batches = setup("dense_int8")
    params, opt = state()
    first = {p: t.data_ptr() for p, t in module.tree_paths(
        {"p": params, "o": opt})}
    step = steps.graph_train_step(cfg, ts, device="cpu")
    out_p, out_o, m = step(params, opt, batches[0])
    assert out_p is params and out_o is opt and m is step.metrics
    start = addresses(step)
    assert {p: a for p, a in start if not p.startswith("m/")} == first
    for b in batches[1:]:
        out_p, out_o, m = step(out_p, out_o, b)
        assert addresses(step) == start
    other_p, other_o = state()
    before = {p: t.clone() for p, t in module.tree_paths(
        {"p": other_p, "o": other_o})}
    out_p, out_o, m = step(other_p, other_o, batches[1])
    assert out_p is step.params and out_o is step.opt
    assert addresses(step) == start
    for p, t in module.tree_paths({"p": other_p, "o": other_o}):
        assert torch.equal(t, before[p]), p
    w_p, w_o, w_m = steps.make_train_step(cfg, ts)(*state(), batches[1])
    for k in steps.TRAIN_METRICS:
        assert torch.equal(m[k], w_m[k]), k
    want = dict(module.tree_paths({"p": w_p, "o": w_o}))
    for p, t in module.tree_paths({"p": out_p, "o": out_o}):
        assert torch.equal(t, want[p]), p
    with pytest.raises(ValueError, match="other leaves"):
        step({"embed": other_p["embed"]}, other_o, batches[0])


def test_a_batch_of_other_keys_or_shapes_raises():
    _, cfg, ts, state, batches = setup("dense")
    step = steps.graph_train_step(cfg, ts, device="cpu")
    params, opt, _ = step(*state(), batches[0])
    for bad in ({k: v[:2] for k, v in batches[1].items()},
                {k: v.to(torch.int64) for k, v in batches[1].items()},
                dict(batches[1], frames=torch.zeros(4, 8, 8)),
                dict(batches[1], cache_pos=0)):
        with pytest.raises(ValueError):
            step(params, opt, bad)


def test_jit_on_the_cpu_runs_eagerly():
    """``jit=True`` on a CPU the caller asked for runs the body eagerly:
    no capturer, no graph; the card is the default device."""
    _, cfg, ts, state, batches = setup("dense")
    step = steps.graph_train_step(cfg, ts, device="cpu", jit=True)
    step(*state(), batches[0])
    assert not step.graphed and step.graph is None and step._capture is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            steps.graph_train_step(cfg, ts)


MAIN_ARGS = ["--arch", "smollm-360m", "--reduce", "--device", "cpu",
             "--steps", "6", "--global-batch", "4", "--seq", "32",
             "--microbatch", "2", "--ckpt-every", "3", "--log-every", "1"]


def main_run(tmp_path, name, extra, monkeypatch):
    """``train.main`` with its step and checkpointer recorded: each
    call's step object and exact metrics, a copy of the tree saved at
    step 3 and what each restore returned."""
    rec = {"steps": [], "metrics": [], "restored": [], "own_trees": []}
    real_build = steps.graph_train_step

    def build(*a, **kw):
        step = real_build(*a, **kw)
        rec["steps"].append(step)

        def call(params, opt, batch):
            rec["own_trees"].append(params is step.params
                                    and opt is step.opt)
            out = step(params, opt, batch)
            rec["metrics"].append({k: float(v) for k, v in out[2].items()})
            return out
        return call

    class Recording(Checkpointer):
        def save(self, at, tree, **kw):
            if at == 3:
                rec["saved"] = {p: t.clone() for p, t in
                                module.tree_paths(tree)}
            return super().save(at, tree, **kw)

        def restore(self, *a, **kw):
            tree, extra = super().restore(*a, **kw)
            rec["restored"].append(dict(module.tree_paths(tree)))
            return tree, extra

    monkeypatch.setattr(steps, "graph_train_step", build)
    monkeypatch.setattr(train, "Checkpointer", Recording)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(MAIN_ARGS + ["--ckpt-dir", str(tmp_path / name)] + extra)
    monkeypatch.undo()
    rec["result"] = json.loads(out.getvalue().splitlines()[-1])["result"]
    return rec


def test_train_main_restarts_into_the_owned_state(tmp_path, monkeypatch):
    """``train.main --device cpu`` trains through one ``TrainStep`` (its
    eager body); with a failure injected at step 4 it restores step 3's
    checkpoint into that same step's own tensors (every call after the
    first, the restart's included, passes the trees the step owns, so no
    second copy of the state is kept): the restored tree equals the tree
    saved, and the losses, gradient norms and learning rates after the
    restore equal the uninterrupted run's bit for bit."""
    clean = main_run(tmp_path, "clean", [], monkeypatch)
    failed = main_run(tmp_path, "failed", ["--inject-failure-at", "4"],
                      monkeypatch)
    assert clean["result"] == {"restarts": 0, "completed": True}
    assert failed["result"] == {"restarts": 1, "completed": True}
    for rec in (clean, failed):
        [step] = rec["steps"]
        assert isinstance(step, TrainStep) and not step.graphed
    assert len(clean["metrics"]) == 6 and len(failed["metrics"]) == 7
    assert clean["own_trees"] == [False] + [True] * 5
    assert failed["own_trees"] == [False] + [True] * 6
    assert failed["metrics"][:4] == clean["metrics"][:4]
    assert failed["metrics"][4:] == clean["metrics"][3:]
    [restored] = failed["restored"]
    assert sorted(restored) == sorted(failed["saved"])
    for p, t in failed["saved"].items():
        assert t.dtype == restored[p].dtype and torch.equal(t, restored[p]), p


def test_a_save_then_a_step_leaves_the_saved_values(tmp_path, monkeypatch):
    """``Checkpointer.save`` of the step's own trees returns once they are
    copied to the host: a step run while the files are still unwritten
    (the writer held until it ends) leaves them at the values from before
    that step."""
    _, cfg, ts, state, batches = setup("dense")
    step = steps.graph_train_step(cfg, ts, device="cpu")
    params, opt, _ = step(*state(), batches[0])
    saved = {p: t.clone() for p, t in module.tree_paths(
        {"params": params, "opt": opt})}
    go, real = threading.Event(), np.save

    def held(*a, **kw):
        assert go.wait(60)
        return real(*a, **kw)

    monkeypatch.setattr(np, "save", held)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, {"params": params, "opt": opt})
    params, opt, _ = step(params, opt, batches[1])
    go.set()
    ck.wait()
    monkeypatch.undo()
    tree, _ = ck.restore(1)
    back = dict(module.tree_paths(tree))
    assert sorted(back) == sorted(saved)
    for p, t in saved.items():
        assert torch.equal(back[p], t), p
    assert not torch.equal(back["params/embed/embedding"],
                           params["embed"]["embedding"])
