"""The port's Spikformer training step as the reference jits it
(``examples/train_spikformer.py``: value_and_grad, AdamW, the BN stats
merged), pinned on the CPU, where no CUDA graph can be captured:
``make_train_step``'s in-place body, which the card records as one graph,
equals the functional ``train_step`` bit for bit, both stay within the
reference trajectory test's tolerances of the reference's ``jax.jit``
step, the body makes no host read, and the state it writes never moves.

The reduced config, the reference's seeded params carried into the port
(``repro_torch.weights``), and ``image_batch`` data drawn alike in both
packages. Tolerances against the reference are
``test_torch_train.py::test_three_step_train_trajectory``'s: each loss
within rtol 1e-5, the final params within rtol 1e-4 and atol 1e-5."""
import jax
import numpy as np
import pytest
import torch

from repro.core.spikformer import SpikformerConfig as JConfig
from repro.core.spikformer import init as jinit
from repro.core.spikformer import loss_fn as jloss_fn
from repro.core.spikformer import merge_bn_stats as jmerge
from repro.data import pipeline as jpipeline
from repro.optim import adamw as jadamw
from repro_torch.core.spikformer import (TRAIN_METRICS, SpikformerConfig,
                                         make_train_step, train_step)
from repro_torch.data import pipeline
from repro_torch.optim import adamw
from repro_torch.weights import from_reference
from torch_threads import one_thread  # noqa: F401  (autouse)

STEPS = 3
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
OPT = dict(peak_lr=2e-3, warmup_steps=1, decay_steps=STEPS,
           weight_decay=0.01)
DATA = dict(global_batch=4, image_size=32, n_classes=10, seed=0)


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """The reduced config, the reference's seeded params (both packages'
    trees), the port's optimizer config and STEPS batches."""
    jcfg, cfg = JConfig().scaled(), SpikformerConfig().scaled()
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    dcfg = pipeline.DataConfig(**DATA)
    batches = [pipeline.image_batch(dcfg, i) for i in range(STEPS)]
    return jcfg, cfg, jp, from_reference(np_tree(jp)), \
        adamw.OptConfig(**OPT), batches


def torch_batch(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def functional_run(params, cfg, ocfg, batches):
    """The example's former loop: ``train_step`` on fresh trees."""
    opt, metrics = adamw.init(params, ocfg), []
    for raw in batches:
        params, opt, loss, acc, m = train_step(params, opt, torch_batch(raw),
                                               cfg, ocfg)
        metrics.append(dict(zip(TRAIN_METRICS, (loss, acc, m["grad_norm"],
                                                m["lr"]))))
    return params, opt, metrics


def body_run(params, cfg, ocfg, batches):
    """``make_train_step``'s in-place body, eagerly on the CPU."""
    step = make_train_step(params, adamw.init(params, ocfg), cfg, ocfg,
                           device="cpu")
    assert not step.graphed
    metrics = [{k: v.clone() for k, v in step(raw).items()}
               for raw in batches]
    return step.params, step.opt, metrics


@pytest.fixture(scope="module")
def reference(setup):
    """The reference example's ``jax.jit`` step over the same batches:
    each step's loss and the final params."""
    jcfg, _, jp, _, _, batches = setup
    jocfg = jadamw.OptConfig(**OPT)

    @jax.jit
    def jstep(p, o, b):
        (loss, (_, stats)), g = jax.value_and_grad(
            jloss_fn, has_aux=True)(p, b, jcfg, train=True)
        p, o, _ = jadamw.update(g, o, p, jocfg)
        return jmerge(p, stats), o, loss

    jo, losses = jadamw.init(jp, jocfg), []
    for i, raw in enumerate(batches):
        want = jpipeline.image_batch(
            jpipeline.DataConfig(kind="images", **DATA), i)
        np.testing.assert_array_equal(want["image"], raw["image"])
        np.testing.assert_array_equal(want["label"], raw["label"])
        jp, jo, loss = jstep(jp, jo, {k: jax.numpy.asarray(v)
                                      for k, v in raw.items()})
        losses.append(float(loss))
    return losses, np_tree(jp)


def test_in_place_body_equals_the_functional_step(setup):
    """Three steps of the in-place body against three of ``train_step``
    from the same params and batches: every loss, accuracy, grad norm and
    learning rate, and at the end every param, both moments, the step
    counter and every BN running mean and variance, bit for bit."""
    _, cfg, _, tp, ocfg, batches = setup
    want_p, want_o, want_m = functional_run(tp, cfg, ocfg, batches)
    got_p, got_o, got_m = body_run(tp, cfg, ocfg, batches)
    for i, (g, w) in enumerate(zip(got_m, want_m)):
        for k in TRAIN_METRICS:
            assert torch.equal(g[k], w[k]), (i, k)
    for name, got, want in (("params", got_p, want_p), ("opt", got_o,
                                                          want_o)):
        want = dict(paths(want))
        got = dict(paths(got))
        assert sorted(got) == sorted(want)
        for p, g in got.items():
            assert g.dtype == want[p].dtype and torch.equal(g, want[p]), \
                f"{name}{p}"
    assert int(got_o["step"]) == STEPS
    # the BN running stats were written back
    start = dict(paths(tp))
    assert any(not torch.equal(t, start[p]) for p, t in paths(got_p)
               if p.endswith("/mean"))


@pytest.mark.parametrize("run", [functional_run, body_run],
                         ids=["functional", "body"])
def test_step_tracks_the_reference_jit_step(setup, reference, run):
    """Each of the port's steps over three steps against the reference's
    ``jax.jit`` step: each loss within rtol 1e-5, the final params (BN
    running stats included) within rtol 1e-4 and atol 1e-5."""
    _, cfg, _, tp, ocfg, batches = setup
    want_losses, want_p = reference
    params, _, metrics = run(tp, cfg, ocfg, batches)
    np.testing.assert_allclose([float(m["loss"]) for m in metrics],
                               want_losses, rtol=LOSS_RTOL)
    want = dict(paths(want_p))
    got = dict(paths(params))
    assert sorted(got) == sorted(want)
    for p, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[p], np.float32),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=p)


def _host_read(*_args, **_kw):
    raise AssertionError("a host read in the training step's body")


HOST_READS = ("item", "tolist", "cpu", "numpy", "nonzero", "__int__",
              "__float__", "__index__", "__bool__")


def test_body_makes_no_host_read(setup, monkeypatch):
    """The body runs a step with every way of reading a tensor on the
    host patched to raise, and gives what it gives unpatched; the same
    patch stops a body whose learning rate reads the step counter on the
    host."""
    _, cfg, _, tp, ocfg, batches = setup
    batch = {k: torch.from_numpy(batches[0][k]) for k in ("image", "label")}

    def make():
        return make_train_step(tp, adamw.init(tp, ocfg), cfg, ocfg,
                               device="cpu")

    want = {k: v.clone() for k, v in make().body(batch).items()}
    step = make()
    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, _host_read)
    got = {k: v.clone() for k, v in step.body(batch).items()}
    monkeypatch.setattr(adamw, "schedule", lambda cfg, count: torch.tensor(
        cfg.peak_lr * min(1.0, int(count) / cfg.warmup_steps)))
    with pytest.raises(AssertionError, match="host read"):
        step.body(batch)
    monkeypatch.undo()
    assert all(torch.equal(got[k], want[k]) for k in TRAIN_METRICS)


def test_static_state_never_moves(setup):
    """The params, moments, counter and metric tensors are the same
    objects at the same addresses across steps and ``state()`` calls:
    a captured graph keeps writing where the step reads. The caller's
    trees are copied, never written, and ``state()`` is a copy."""
    _, cfg, _, tp, ocfg, batches = setup
    before_tp = {p: t.clone() for p, t in paths(tp)}
    step = make_train_step(tp, adamw.init(tp, ocfg), cfg, ocfg,
                           device="cpu")
    trees = (step.params, step.opt, step.metrics)

    def addresses():
        return [(p, t.data_ptr()) for tree in trees for p, t in paths(tree)]

    start = addresses()
    for raw in batches:
        out = step(raw)
        assert out is step.metrics
        params, opt = step.state()
        assert addresses() == start
        assert all(a.data_ptr() != b.data_ptr() for (_, a), (_, b) in
                   zip(paths(params), paths(step.params)))
    params["head"]["kernel"].zero_()
    assert step.params["head"]["kernel"].abs().max() > 0
    assert all(torch.equal(t, before_tp[p]) for p, t in paths(tp))
    assert int(opt["step"]) == STEPS


def test_make_train_step_on_the_cpu_runs_eagerly(setup):
    """``jit=True`` on a CPU the caller asked for runs the body eagerly:
    no capturer, no graph; the card is the default device."""
    _, cfg, _, tp, ocfg, batches = setup
    step = make_train_step(tp, adamw.init(tp, ocfg), cfg, ocfg,
                           device="cpu", jit=True)
    step(batches[0])
    assert not step.graphed and step.graph is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_train_step(tp, adamw.init(tp, ocfg), cfg, ocfg)
