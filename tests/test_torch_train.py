"""The port's training half against the JAX reference: the atan surrogate
(``spike_fn``), training BN, SSA, ``apply``/``loss_fn``/``merge_bn_stats``,
AdamW, the image pipeline and the analytic engine model, plus the
reference's own training, optimizer and engine-model cases run on the
port. Inputs come from seeded numpy and go through both packages; the
reduced config's parameters come from the reference's ``init`` through
``repro_torch.weights``.

Tolerances: the surrogate gradient and ``image_batch`` bit for bit; the
loss within rtol 1e-5 and each gradient leaf within 1e-4 of its largest
|g| (the dot products and BN's batch reductions sum in another order than
XLA's); BN outputs and stats within 1e-5; AdamW's params and moments
within 1e-6 relative (``b ** step`` and the sums of squares round apart
by an ulp). LIF spike flips against the reference are counted per layer
and must be none at the reduced config.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lif as jlif
from repro.core import ssa as jssa
from repro.core import engine_model as jengine
from repro.core.spikformer import SpikformerConfig as JConfig
from repro.core.spikformer import apply as japply
from repro.core.spikformer import init as jinit
from repro.core.spikformer import loss_fn as jloss_fn
from repro.core.spikformer import merge_bn_stats as jmerge
from repro.data import pipeline as jpipeline
from repro.optim import adamw as jadamw
from repro_torch.core import engine_model, lif, ssa
from repro_torch.core.spikformer import (SpikformerConfig, _combine, apply,
                                         init, merge_bn_stats,
                                         value_and_grad)
from repro_torch.data import pipeline
from repro_torch.optim import adamw
from repro_torch.weights import from_reference

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest |g|
BN_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_tree_close(got, want, *, rtol=0.0, atol=0.0, what=""):
    want = dict(paths(np_tree(want)))
    got = dict(paths(got))
    assert sorted(got) == sorted(want), what
    for p, g in got.items():
        w = want[p]
        g = np.asarray(g.detach().float() if isinstance(g, torch.Tensor)
                       else g, np.float32)
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol, err_msg=f"{what}{p}")


@pytest.fixture(scope="module")
def small():
    """The reduced config, the reference's seeded params in both
    packages, and a seeded batch of 4 images with labels."""
    jcfg, cfg = JConfig().scaled(), SpikformerConfig().scaled()
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    r = np.random.default_rng(1)
    img = r.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    lab = r.integers(0, cfg.num_classes, 4).astype(np.int32)
    return jcfg, cfg, jp, from_reference(np_tree(jp)), img, lab


@pytest.fixture(scope="module")
def ref(small):
    """The reference's eval and train ``apply`` and ``loss_fn``'s value
    and gradient on the batch, under one ``jax.jit`` (one compile)."""
    jcfg, _, jp, _, img, lab = small

    @jax.jit
    def run(p, b):
        return (japply(p, b["image"], jcfg, train=False),
                japply(p, b["image"], jcfg, train=True),
                jax.value_and_grad(lambda q: jloss_fn(q, b, jcfg, train=True),
                                   has_aux=True)(p))

    return run(jp, jax_batch(img, lab))


def port_value_and_grad(params, batch, cfg, *, train=True):
    (loss, (acc, stats)), grads = value_and_grad(params, batch, cfg,
                                                 train=train)
    return loss, acc, stats, grads


def torch_batch(img, lab):
    return {"image": torch.from_numpy(img), "label": torch.from_numpy(lab)}


def jax_batch(img, lab):
    return {"image": jnp.asarray(img), "label": jnp.asarray(lab)}


# ---------------------------------------------------------------------------
# spike_fn: the atan surrogate
# ---------------------------------------------------------------------------

def test_spike_fn_forward_and_surrogate_bit_for_bit():
    """Normal f32 values and zeros of both signs. Subnormals are left out:
    XLA's CPU backend reads them as zero (so -1e-38 fires there), torch
    keeps them."""
    r = np.random.default_rng(0)
    u = np.concatenate([r.normal(0, 2, 4000), r.normal(0, 1e-3, 1000),
                        [0.0, -0.0, 1e-30, -1e-30, 1e30, -1e30]]
                       ).astype(np.float32)
    g = r.normal(0, 1, u.shape).astype(np.float32)
    want, vjp = jax.vjp(jlif.spike_fn, jnp.asarray(u))
    (want_grad,) = vjp(jnp.asarray(g))
    ut = torch.from_numpy(u).requires_grad_(True)
    got = lif.spike_fn(ut)
    (got_grad,) = torch.autograd.grad(got, ut, torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_grad.numpy(), np.asarray(want_grad))
    assert lif.SURROGATE_ALPHA == jlif.SURROGATE_ALPHA


def test_surrogate_gradient_nonzero():
    """The reference's case: nonzero around the threshold, peaked at it."""
    u = torch.tensor([-0.5, 0.0, 0.5], requires_grad=True)
    (g,) = torch.autograd.grad(lif.spike_fn(u).sum(), u)
    assert (g.abs() > 0).all()
    assert g[1] > g[0] and g[1] > g[2]


def test_tflif_forward_and_bptt_match_reference():
    """Spikes bit for bit; the gradient through the membrane and the hard
    reset (nothing detached) against ``jax.grad`` of the ``lax.scan``."""
    r = np.random.default_rng(2)
    x = (r.normal(0, 2, (6, 3, 40))).astype(np.float32)
    w = r.normal(0, 1, x.shape).astype(np.float32)

    def jf(z):
        return (jlif.tflif(z) * w).sum()

    want_s = np.asarray(jlif.tflif(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    s = lif.tflif(xt)
    (g,) = torch.autograd.grad((s * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_array_equal(s.detach().numpy(), want_s)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6, atol=1e-7)
    assert np.abs(want_g).max() > 0


def test_lif_step_and_tflif_time_axis():
    r = np.random.default_rng(3)
    x = r.normal(0, 2, (5, 4, 7)).astype(np.float32)
    vth = r.uniform(0.5, 1.5, 7).astype(np.float32)
    want = jlif.tflif(jnp.asarray(x), v_th=jnp.asarray(vth), time_axis=1)
    got = lif.tflif(torch.from_numpy(x), v_th=torch.from_numpy(vth),
                    time_axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# BN: inference and training forms
# ---------------------------------------------------------------------------

def bn_params(r, c):
    return {"scale": r.normal(1, 0.2, c).astype(np.float32),
            "bias": r.normal(0, 0.3, c).astype(np.float32),
            "mean": r.normal(0, 0.5, c).astype(np.float32),
            "var": r.uniform(0.2, 2.0, c).astype(np.float32)}


def test_bn_apply_matches_reference():
    r = np.random.default_rng(4)
    p = bn_params(r, 24)
    x = r.normal(0, 3, (4, 5, 24)).astype(np.float32)
    want = jlif.bn_apply({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = lif.bn_apply(from_reference(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BN_TOL,
                               atol=BN_TOL)


@pytest.mark.parametrize("axes", [(0, 1, 2), (0, 1, 2, 3)])
def test_bn_train_apply_y_stats_and_gradients(axes):
    """y, the EMA'd stats (detached) and the gradients through the batch
    mean and the population variance."""
    r = np.random.default_rng(5)
    shape = (3, 2, 5, 16) if len(axes) == 3 else (3, 2, 5, 6, 16)
    p = bn_params(r, 16)
    x = (r.normal(0.5, 2, shape)).astype(np.float32)
    w = r.normal(0, 1, shape).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def jf(xx, scale):
        y, new = jlif.bn_train_apply({**jp, "scale": scale}, xx, axes)
        return (y * w).sum(), (y, new)

    (_, (jy, jnew)), (jgx, jgs) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jp["scale"])
    tp = from_reference(p)
    tp["scale"].requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, new = lif.bn_train_apply(tp, xt, axes)
    gx, gs = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                                 (xt, tp["scale"]))
    assert not new["mean"].requires_grad and not new["var"].requires_grad
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=BN_TOL, atol=BN_TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]),
                                   rtol=BN_TOL, atol=BN_TOL)
    for got, want in ((gx, jgx), (gs, jgs)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())


def test_batch_stats_population_variance():
    x = torch.tensor([[1.0, 2.0, 3.0, 6.0]])
    mean, var = lif.batch_stats(x, (1,))
    want_m, want_v = jlif.batch_stats(jnp.asarray(x.numpy()), (1,))
    np.testing.assert_array_equal(mean.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(var.numpy(), np.asarray(want_v))
    assert float(var[0]) == 3.5         # 14 / 4, not 14 / 3


# ---------------------------------------------------------------------------
# SSA, apply, loss_fn, merge_bn_stats
# ---------------------------------------------------------------------------

def spike_input(r, shape, rate=0.3):
    return (r.random(shape) < rate).astype(np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_ssa_apply_matches_reference(small, train):
    jcfg, cfg, jp, tp, _, _ = small
    r = np.random.default_rng(6)
    x = spike_input(r, (cfg.timesteps, 2, 16, cfg.dim))
    jblk, tblk = jp["blocks"]["b0"]["ssa"], tp["blocks"]["b0"]["ssa"]
    # gains keep the attention firing under the folded-inference BN
    gain = {"wq": 4.0, "wk": 4.0, "wv": 4.0, "wo": 6.0}
    jblk = {k: ({**v, "kernel": v["kernel"] * gain[k]} if k in gain else v)
            for k, v in jblk.items()}
    tblk = from_reference(np_tree(jblk))
    want, jst = jax.jit(lambda b, z: jssa.ssa_apply(
        b, z, heads=cfg.heads, scale=cfg.attn_scale, train=train))(
        jblk, jnp.asarray(x))
    got, st = ssa.ssa_apply(tblk, torch.from_numpy(x), heads=cfg.heads,
                            scale=cfg.attn_scale, train=train)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert list(st) == ["wq_bn", "wk_bn", "wv_bn", "wo_bn"]
    assert sorted(st) == sorted(jst)
    if train:
        # at 16 tokens the attention's LIF stays silent under batch
        # statistics (its sums stay below threshold), in both packages
        assert_tree_close(st, jst, rtol=BN_TOL, atol=BN_TOL)
        assert float(st["wq_bn"]["var"].sub(0.9).abs().max()) > 0
    else:
        assert float(got.mean()) > 0
        assert all(v is None for v in st.values())


def test_ssa_init_keeps_init_draws():
    """``spikformer.init`` draws each block's SSA through ``ssa_init``,
    after the head and the four conv kernels: block 0's SSA equals
    ``ssa_init`` on a generator advanced by those draws."""
    cfg = SpikformerConfig().scaled()
    p = init(torch.Generator().manual_seed(3), cfg)
    g = torch.Generator().manual_seed(3)
    head = ssa.linear_init(g, cfg.dim, cfg.num_classes, bias=True)
    cin = cfg.in_channels
    for cout in cfg.scs_channels:
        torch.randn((2, 2, cin, cout), generator=g)
        cin = cout
    want = ssa.ssa_init(g, cfg.dim, cfg.heads)
    torch.testing.assert_close(p["head"], head, rtol=0, atol=0)
    torch.testing.assert_close(p["blocks"]["b0"]["ssa"], want, rtol=0,
                               atol=0)
    assert list(want) == ["wq", "wq_bn", "wk", "wk_bn", "wv", "wv_bn", "wo",
                          "wo_bn"]


def count_flips(cfg, tp, jp, img):
    """Spike bits of every LIF of the eval-mode graph that differ from the
    reference's, in call order (both packages' ``tflif`` hooked in their
    Spikformer and SSA modules)."""
    from repro.core import spikformer as jspik
    from repro_torch.core import spikformer as tspik
    got, want = [], []
    mods = [(m, m.tflif, out) for m, out in
            ((tspik, got), (ssa, got), (jspik, want), (jssa, want))]

    def hooked(fn, out):
        return lambda y, **kw: out.append(fn(y, **kw)) or out[-1]

    for m, fn, out in mods:
        m.tflif = hooked(fn, out)
    try:
        apply(tp, torch.from_numpy(img), cfg)
        japply(jp, jnp.asarray(img), JConfig().scaled())
    finally:
        for m, fn, _ in mods:
            m.tflif = fn
    assert len(got) == len(want)
    return [int((g.numpy() != np.asarray(w)).sum())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_apply_logits_and_every_stats_leaf(small, ref, train):
    jcfg, cfg, jp, tp, img, _ = small
    want, jst = ref[1 if train else 0]
    got, st = apply(tp, torch.from_numpy(img), cfg, train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if train:
        assert_tree_close(st, jst, rtol=BN_TOL, atol=BN_TOL)
    else:
        assert all(v is None for _, v in paths(st))


def test_lif_spike_flips_per_layer_are_none(small):
    jcfg, cfg, jp, tp, img, _ = small
    flips = count_flips(cfg, tp, jp, img)
    assert len(flips) == 4 + cfg.depth * 7      # q, k, v, attn, wo, fc1, fc2
    assert flips == [0] * len(flips), flips


def test_loss_fn_value_and_every_gradient_leaf(small, ref):
    jcfg, cfg, jp, tp, img, lab = small
    (jl, (jacc, jst)), jg = ref[2]
    loss, acc, st, grads = port_value_and_grad(tp, torch_batch(img, lab),
                                               cfg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert float(acc) == float(jacc)
    assert_tree_close(st, jst, rtol=BN_TOL, atol=BN_TOL)
    want = dict(paths(np_tree(jg)))
    got = dict(paths(grads))
    assert sorted(got) == sorted(want)
    for p, g in got.items():
        w = want[p]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(w).max(), 1e-30),
                                   err_msg=p)
    assert np.abs(want["/scs/conv0/kernel"]).max() > 0


def test_loss_fn_eval_and_first_index_argmax():
    """Accuracy counts the first index of a tied maximum, as jnp.argmax."""
    logits = torch.tensor([[1.0, 3.0, 3.0], [2.0, 2.0, 0.0]])
    want = jnp.argmax(jnp.asarray(logits.numpy()), -1)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(want))


def test_merge_bn_stats_matches_reference(small, ref):
    jcfg, cfg, jp, tp, img, _ = small
    _, jst = ref[1]
    want = jmerge(jp, jst)
    got = merge_bn_stats(tp, from_reference(np_tree(
        jax.tree_util.tree_map(lambda x: x, jst))))
    assert_tree_close(got, want)
    # the input tree is left as it was
    assert float(tp["scs"]["conv0"]["bn"]["mean"].abs().max()) == 0.0


def test_merge_bn_stats_roundtrip_port(small):
    """The reference's case on the port: running stats move from init."""
    _, cfg, _, tp, img, _ = small
    _, stats = apply(tp, torch.from_numpy(img), cfg, train=True)
    merged = merge_bn_stats(tp, stats)
    assert float(merged["scs"]["conv0"]["bn"]["mean"].abs().max()) > 0.0


def test_combine_keeps_spikes_binary():
    r = np.random.default_rng(0)
    a, b = (torch.from_numpy(spike_input(r, (100,), 0.5)) for _ in range(2))
    assert set(_combine(a, b, "iand").unique().tolist()) <= {0.0, 1.0}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def rand_tree(r, scale):
    return {"w": (r.normal(0, scale, (6, 5))).astype(np.float32),
            "blk": {"b": (r.normal(0, scale, (5,))).astype(np.float32),
                    "k": (r.normal(0, scale, (3, 4, 2))).astype(np.float32)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_steps_match_reference(dtype):
    """3 steps, moments in ``dtype``, gradients large enough that the
    clip engages; decay only on the >= 2-D leaves."""
    r = np.random.default_rng(7)
    params = rand_tree(r, 1.0)
    jcfg = jadamw.OptConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=10,
                            weight_decay=0.1, clip_norm=1.0,
                            state_dtype=getattr(jnp, dtype))
    cfg = adamw.OptConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=10,
                          weight_decay=0.1, clip_norm=1.0,
                          state_dtype=getattr(torch, dtype))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = from_reference(params)
    jst, st = jadamw.init(jp, jcfg), adamw.init(tp, cfg)
    for i in range(3):
        g = rand_tree(r, 10.0)
        jp, jst, jm = jadamw.update(jax.tree_util.tree_map(jnp.asarray, g),
                                    jst, jp, jcfg)
        tp, st, m = adamw.update(from_reference(g), st, tp, cfg)
        assert float(jm["grad_norm"]) > jcfg.clip_norm     # clipped
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(st["step"]) == int(jst["step"]) == i + 1
        assert_tree_close(tp, jp, rtol=1e-6, atol=1e-7, what=f"step {i} ")
        tol = 1e-6 if dtype == "float32" else 1e-2
        assert_tree_close(st["m"], jst["m"], rtol=tol, atol=1e-7)
        assert_tree_close(st["v"], jst["v"], rtol=tol, atol=1e-7)
    assert st["m"]["w"].dtype == getattr(torch, dtype)


def test_adamw_is_not_torch_adamw():
    """Decay added to the direction before lr, eps after sqrt(vhat):
    one step from zero moments moves a 2-D leaf by lr * (sign(g) + wd * p),
    which ``torch.optim.AdamW`` (p *= 1 - lr * wd first) does not give."""
    cfg = adamw.OptConfig(peak_lr=0.1, warmup_steps=0, decay_steps=10,
                          weight_decay=0.5, clip_norm=1e9, eps=0.0)
    p = {"w": torch.full((2, 2), 2.0)}
    g = {"w": torch.full((2, 2), 3.0)}
    new, _, m = adamw.update(g, adamw.init(p, cfg), p, cfg)
    lr = float(m["lr"])
    torch.testing.assert_close(new["w"], torch.full((2, 2),
                                                    2.0 - lr * (1.0 + 1.0)))


def test_schedule_warmup_then_cosine():
    """The reference's schedule case on the port."""
    cfg = adamw.OptConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100,
                          min_lr_frac=0.1)
    lrs = [float(adamw.schedule(cfg, torch.tensor(s)))
           for s in (0, 5, 10, 50, 100, 200)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 5e-4) < 1e-8
    assert abs(lrs[2] - 1e-3) < 1e-8
    assert lrs[3] < lrs[2]
    assert abs(lrs[4] - 1e-4) < 1e-7
    assert abs(lrs[5] - 1e-4) < 1e-7
    jcfg = jadamw.OptConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100,
                            min_lr_frac=0.1)
    want = [float(jadamw.schedule(jcfg, jnp.asarray(s)))
            for s in (0, 5, 10, 50, 100, 200)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6, atol=0)


def test_adamw_converges_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros((3, 1))}
    cfg = adamw.OptConfig(peak_lr=0.1, warmup_steps=5, decay_steps=200,
                          weight_decay=0.0)
    state = adamw.init(params, cfg)
    for _ in range(200):
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(((w[:, 0] - target) ** 2).sum(), w)
        params, state, _ = adamw.update({"w": g}, state, params, cfg)
    assert float(((params["w"][:, 0] - target) ** 2).sum()) < 1e-2


def test_clip_norm_applied():
    params = {"w": torch.zeros((2, 2))}
    cfg = adamw.OptConfig(clip_norm=1.0, peak_lr=1.0, warmup_steps=0,
                          decay_steps=10)
    _, _, m = adamw.update({"w": torch.full((2, 2), 100.0)},
                           adamw.init(params, cfg), params, cfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_bf16_moments():
    params = {"w": torch.zeros((4, 4))}
    cfg = adamw.OptConfig(state_dtype=torch.bfloat16)
    state = adamw.init(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    _, s2, _ = adamw.update({"w": torch.ones((4, 4))}, state, params, cfg)
    assert s2["m"]["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the image pipeline and a short training trajectory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(global_batch=6, image_size=32, n_classes=4, seed=0),
    dict(global_batch=4, image_size=16, n_classes=10, seed=3,
         host_id=1, n_hosts=2)])
def test_image_batch_bit_for_bit(kw):
    for step in (0, 7):
        want = jpipeline.image_batch(
            jpipeline.DataConfig(kind="images", **kw), step)
        got = pipeline.image_batch(pipeline.DataConfig(**kw), step)
        for k in ("image", "label"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert pipeline.DataConfig(**kw).local_batch == \
        jpipeline.DataConfig(kind="images", **kw).local_batch


def train_steps_port(tp, cfg, ocfg, dcfg, steps):
    opt = adamw.init(tp, ocfg)
    losses = []
    for i in range(steps):
        raw = pipeline.image_batch(dcfg, i)
        loss, _, stats, grads = port_value_and_grad(
            tp, torch_batch(raw["image"], raw["label"]), cfg)
        tp, opt, _ = adamw.update(grads, opt, tp, ocfg)
        tp = merge_bn_stats(tp, stats)
        losses.append(float(loss))
    return losses, tp


def test_three_step_train_trajectory(small):
    """``train_spikformer.py``'s step (value_and_grad, AdamW, merge the
    BN stats) for 3 steps from the same params: each step's loss within
    LOSS_RTOL and the final params within tolerance of the reference's."""
    jcfg, cfg, jp, tp, _, _ = small
    jocfg = jadamw.OptConfig(peak_lr=2e-3, warmup_steps=1, decay_steps=3,
                             weight_decay=0.01)
    ocfg = adamw.OptConfig(peak_lr=2e-3, warmup_steps=1, decay_steps=3,
                           weight_decay=0.01)
    dkw = dict(global_batch=4, image_size=32, n_classes=10, seed=0)

    @jax.jit
    def jstep(p, o, b):
        (loss, (_, stats)), g = jax.value_and_grad(
            jloss_fn, has_aux=True)(p, b, jcfg, train=True)
        p, o, _ = jadamw.update(g, o, p, jocfg)
        return jmerge(p, stats), o, loss

    jo, want = jadamw.init(jp, jocfg), []
    for i in range(3):
        raw = jpipeline.image_batch(
            jpipeline.DataConfig(kind="images", **dkw), i)
        jp, jo, loss = jstep(jp, jo, jax_batch(raw["image"], raw["label"]))
        want.append(float(loss))
    got, tp = train_steps_port(tp, cfg, ocfg, pipeline.DataConfig(**dkw), 3)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert_tree_close(tp, jp, rtol=1e-4, atol=1e-5)


def test_train_step_reduces_loss_port():
    """The reference's case on the port: nine plain SGD steps on one batch
    lower the loss (train-mode BN keeps the untrained network firing)."""
    cfg = SpikformerConfig().scaled()
    params = init(torch.Generator().manual_seed(0), cfg)
    r = np.random.default_rng(1)
    batch = torch_batch(r.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
                        np.array([3, 7], np.int32))
    l0 = None
    for _ in range(9):
        loss, _, _, g = port_value_and_grad(params, batch, cfg)
        l0 = float(loss) if l0 is None else l0
        params = adamw._map(lambda w, gw: w - 0.5 * gw, params, g)
    assert float(loss) < l0


# ---------------------------------------------------------------------------
# the analytic engine model
# ---------------------------------------------------------------------------

def test_engine_model_equals_reference():
    cfg, jcfg = SpikformerConfig(), JConfig()
    assert engine_model.PE_TOTAL == jengine.PE_TOTAL == 4096
    assert engine_model.PEAK_GSOPS == pytest.approx(4096.0)
    assert [(o.method, o.layer, o.macs) for o in
            engine_model.spikformer_op_counts(cfg)] == \
        [(o.method, o.layer, o.macs) for o in
         jengine.spikformer_op_counts(jcfg)]
    for calibrated in (False, True):
        assert engine_model.table2_distribution(cfg, calibrated=calibrated) \
            == jengine.table2_distribution(jcfg, calibrated=calibrated)
        assert engine_model.frames_per_second(cfg, calibrated=calibrated) \
            == jengine.frames_per_second(jcfg, calibrated=calibrated)
    assert engine_model.implied_utilization(cfg) == \
        jengine.implied_utilization(jcfg)
    assert engine_model.table1_summary() == jengine.table1_summary()


def test_engine_model_reference_cases_on_port():
    """The reference's ``test_engine_model.py`` assertions on the port."""
    dist = engine_model.table2_distribution(calibrated=True)
    for k in ("WSSL", "STDP", "SSSC"):
        assert dist[k] == pytest.approx(engine_model.PAPER_TABLE2[k],
                                        abs=1.5)
    assert dist["ZSC"] < 2.0
    ideal = engine_model.table2_distribution(calibrated=False)
    assert ideal["WSSL"] > 55.0 and ideal["SSSC"] + ideal["ZSC"] < 10.0
    assert engine_model.frames_per_second(calibrated=False) > 30.0
    assert engine_model.frames_per_second(calibrated=True) == \
        pytest.approx(30.0, rel=0.05)
    assert 5e9 < sum(engine_model.macs_by_method().values()) < 30e9
    u = engine_model.implied_utilization()
    assert all(0.0 < v <= 1.0 for v in u.values())
    assert 0.2 < u["WSSL"] < 0.6 and u["ZSC"] == 1.0
    s = engine_model.table1_summary()
    assert (s["pe_number"], s["frequency_mhz"], s["paper_fps"]) == \
        (4096, 500.0, 30.0)
    assert math.isfinite(s["ideal_fps"])
