"""The port's LM training (``nn.layers.softmax_xent``,
``nn.transformer.lm_loss`` and remat, ``launch.steps``) against the JAX
reference, at ``reduced()`` configs of the six ported families (dense
smollm-360m, MoE qwen3-moe-30b-a3b, SSM mamba2-130m, hybrid hymba-1.5b at
three layers, encoder-decoder whisper-large-v3, VLM qwen2-vl-7b), one
reference ``init_model`` tree carried across by
``weights.lm_from_reference``, batches from the reference's
``synthetic_lm_batch`` (plus seeded frames, image embeddings and M-RoPE
streams for the last two). The JAX side runs jitted, with no mesh set (under
a mesh its sharding hints fail on this JAX: ROADMAP §3).

Tolerances:
  * f32 compute: the loss and every gradient leaf within atol = rtol =
    1e-4 (measured: gradients within 2.2e-5 of their leaf's max, losses
    within 1.5e-6); three train steps' params and moments within 1e-4.
  * bf16 compute (the configs' own): the loss within rtol 1e-3 and each
    gradient leaf's relative L2 error (``|g - g_ref| / |g_ref|``) under
    ``BF16_GRAD_L2`` by family. Both packages round the products to bf16
    at the same points but sum in different orders, and a hidden state one
    bf16 ulp off can move a token's top-2 experts: measured 0.012 (dense),
    0.006 (ssm), 0.044 (hybrid, ``a_log``), 0.118 (MoE, the router),
    0.014 (encdec, ``ln_cross``), 0.024 (vlm, the k bias).
  * int8 compression: its quantizer rounds ``g / scale`` half to even, so
    an element whose two f32 gradient sums differ by an ulp at a rounding
    boundary moves by a quantum; three steps leave 15 of ~1.2M param and
    state elements outside 1e-4. The bar: at most 1 in 10^4 elements
    outside 1e-4, losses and gradient norms within rtol 1e-5.
    (``ef_compress`` itself is bit for bit the reference's:
    ``test_torch_train_infra.py``.)
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.data import pipeline as jpipeline
from repro.launch import steps as jsteps
from repro.nn import layers as jlayers
from repro.nn import module as jmodule
from repro.nn import transformer as JT
from repro.optim import adamw as jadamw
from repro.optim.compression import ef_init as jef_init
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.nn import attention as attn
from repro_torch.nn import layers
from repro_torch.nn import module
from repro_torch.nn import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.compression import ef_init
from repro_torch.weights import lm_from_reference
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-4
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_L2 = {"dense": 3e-2, "moe": 0.25, "ssm": 2e-2, "hybrid": 0.1,
                "encdec": 3e-2, "vlm": 5e-2}
INT8_MISS_FRACTION = 1e-4
SEQ = 40          # past the reduced hybrid's window of 32

# family -> (arch, reduced() overrides)
FAMILIES = {"dense": ("smollm-360m", {}),
            "moe": ("qwen3-moe-30b-a3b", {}),
            "ssm": ("mamba2-130m", {}),
            "hybrid": ("hymba-1.5b", {"n_layers": 3}),
            "encdec": ("whisper-large-v3", {}),
            "vlm": ("qwen2-vl-7b", {})}


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def cfgs(family, **kw):
    arch, over = FAMILIES[family]
    return (dataclasses.replace(jget_config(arch).reduced(**over), **kw),
            dataclasses.replace(get_config(arch).reduced(**over), **kw))


@functools.lru_cache(maxsize=None)
def trees(family, seed=0):
    jcfg, cfg = cfgs(family)
    jp = JT.init_model(jax.random.PRNGKey(seed), jcfg)
    tp = lm_from_reference(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           device="cpu")
    return jp, tp


def lm_batch(vocab, step=0, batch=2, seq=SEQ, seed=1, family=None):
    """A ``synthetic_lm_batch``, plus a family's stub modality inputs,
    seeded: bf16 frames for ``encdec``; bf16 image embeddings and distinct
    M-RoPE streams for ``vlm``."""
    b = jpipeline.synthetic_lm_batch(
        jpipeline.DataConfig(seq=seq, global_batch=batch, vocab=vocab,
                             seed=seed), step)
    if family in ("encdec", "vlm"):
        cfg = cfgs(family)[1]
        rng = np.random.default_rng(seed + 100 * step)
        n = cfg.n_frames if family == "encdec" else cfg.img_tokens
        emb = np.asarray(jnp.asarray(rng.standard_normal(
            (batch, n, cfg.d_model)).astype(np.float32)).astype(
                jnp.bfloat16))
        b["frames" if family == "encdec" else "image_embeds"] = emb
        if family == "vlm":
            b["mrope_positions"] = rng.integers(
                0, 2 * seq, (3, batch, seq)).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.array(v).view(np.uint16)).view(
                torch.bfloat16) if v.dtype == jnp.bfloat16
             else torch.from_numpy(np.array(v)) for k, v in b.items()})


@functools.lru_cache(maxsize=None)
def jgrad_fn():
    return jax.jit(jax.value_and_grad(JT.lm_loss, has_aux=True),
                   static_argnums=2)


def port_grads(params, batch, cfg):
    """(loss, {path: gradient}) of ``lm_loss`` by autograd."""
    leaves = {p: t.detach().requires_grad_()
              for p, t in module.tree_paths(params)}
    loss, _ = T.lm_loss(module.map_with_path(lambda p, _: leaves[p], params),
                        batch, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), {p: torch.zeros_like(t) if g is None else g
                           for (p, t), g in zip(leaves.items(), grads)}


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", ["none", "some", "all"])
def test_softmax_xent_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    if masked == "some":
        labels[rng.random(labels.shape) < 0.4] = -100
    elif masked == "all":
        labels[:] = -100
    want = jlayers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    got = layers.softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    assert got.dtype == torch.float32
    close(got, want, 1e-6)
    # bf16 logits are read in f32
    got16 = layers.softmax_xent(torch.from_numpy(logits).bfloat16(),
                                torch.from_numpy(labels))
    want16 = jlayers.softmax_xent(jnp.asarray(logits).astype(jnp.bfloat16),
                                  jnp.asarray(labels))
    close(got16, want16, 1e-6)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_lm_loss_and_every_gradient_leaf_match_reference(family):
    jcfg, cfg = cfgs(family, compute_dtype="float32")
    jp, tp = trees(family)
    jb, tb = lm_batch(cfg.padded_vocab, family=family)
    (jloss, jaux), jg = jgrad_fn()(jp, jb, jcfg)
    loss, grads = port_grads(tp, tb, cfg)
    close(loss, jloss)
    want = dict(jmodule.tree_paths(jg))
    assert list(grads) == list(want)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[path]),
                                   rtol=TOL, atol=TOL, err_msg=path)
    if family == "moe":
        assert set(jaux) == {"load_balance", "router_z"}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_lm_loss_in_bf16_compute_within_the_stated_bar(family):
    jcfg, cfg = cfgs(family)
    assert cfg.compute_dtype == "bfloat16"
    jp, tp = trees(family)
    jb, tb = lm_batch(cfg.padded_vocab, family=family)
    (jloss, _), jg = jgrad_fn()(jp, jb, jcfg)
    loss, grads = port_grads(tp, tb, cfg)
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=BF16_LOSS_RTOL)
    want = dict(jmodule.tree_paths(jg))
    errs = {}
    for path, g in grads.items():
        w = np.asarray(want[path], np.float64)
        errs[path] = np.linalg.norm(g.double().numpy() - w) / max(
            np.linalg.norm(w), 1e-30)
    assert max(errs.values()) < BF16_GRAD_L2[family], errs


@pytest.mark.parametrize("case", [("dense", "nothing"), ("dense", "dots"),
                                  ("moe", "nothing"), ("hybrid", "nothing")])
def test_remat_changes_no_value(case, monkeypatch):
    """Remat (``torch.utils.checkpoint`` around each layer; the "dots"
    policy keeps the matmul outputs) gives the loss and gradients of the
    plain backward bit for bit, on the stacked path and on hybrid's
    per-layer one, and checkpoints every layer."""
    family, policy = case
    _, cfg = cfgs(family, compute_dtype="float32")
    _, tp = trees(family)
    _, tb = lm_batch(cfg.padded_vocab)
    loss0, g0 = port_grads(tp, tb, cfg)
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(*a, **kw):
        calls.append(kw.get("context_fn"))
        return real(*a, **kw)

    monkeypatch.setattr(T.ckpt, "checkpoint", counting)
    loss1, g1 = port_grads(tp, tb, dataclasses.replace(
        cfg, remat=True, remat_policy=policy))
    assert len(calls) == cfg.n_layers
    assert all((c is not None) == (policy == "dots") for c in calls)
    assert torch.equal(loss0, loss1)
    for path in g0:
        assert torch.equal(g0[path], g1[path]), path


# ---------------------------------------------------------------------------
# attention under autograd
# ---------------------------------------------------------------------------

def test_flash_attention_raises_on_an_operand_that_requires_grad():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 8, 16, generator=g) for _ in range(3))
    ops.flash_attention(q, k, v, scale=0.25)          # no grad: fine
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention(*args, scale=0.25)
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention(*args, scale=0.25, plain=True)
        with torch.no_grad():
            ops.flash_attention(*args, scale=0.25)


def test_lm_loss_with_flash_under_autograd_raises():
    _, cfg = cfgs("dense", compute_dtype="float32")
    _, tp = trees("dense")
    _, tb = lm_batch(cfg.padded_vocab)
    leaves = module.map_with_path(
        lambda _, t: t.detach().requires_grad_(), tp)
    with pytest.raises(RuntimeError, match="no backward"):
        T.lm_loss(leaves, tb, cfg, flash=True)
    with torch.no_grad():
        flash, _ = T.lm_loss(tp, tb, cfg, flash=True)
    plain, _ = T.lm_loss(leaves, tb, cfg)
    close(flash, plain.detach(), 1e-5)


def test_train_step_never_calls_the_flash_kernel(monkeypatch):
    """The train step passes ``flash=False``: its attention is the plain
    chunked softmax in every layer."""
    _, cfg = cfgs("dense", compute_dtype="float32")
    _, tp = trees("dense")
    seen = []
    monkeypatch.setattr(attn, "_flash", lambda *a, **kw: seen.append(1))
    ts = steps.TrainSettings(microbatch=1)
    step = steps.make_train_step(cfg, ts)
    _, tb = lm_batch(cfg.padded_vocab, batch=2)
    step(tp, adamw.init(tp, steps.opt_config(cfg, ts)), tb)
    assert seen == []


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

TRAIN_CASES = {"none": ("none", "float32"), "int8": ("int8", "float32"),
               "topk": ("topk", "float32"),
               "none_bf16_moments": ("none", "bfloat16")}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_three_train_steps_match_reference(case):
    """Three steps of a global batch of 4 in microbatches of 2 (two
    accumulation steps), AdamW through warmup and decay, from the same
    params and batches: losses, gradient norms and learning rates, then
    the params, moments, step and error feedback."""
    comp, sdt = TRAIN_CASES[case]
    jcfg, cfg = cfgs("dense", compute_dtype="float32", opt_state_dtype=sdt)
    jp, tp = trees("dense")
    kw = dict(microbatch=2, compression=comp)
    jts = jsteps.TrainSettings(**kw, opt=jadamw.OptConfig(
        peak_lr=1e-3, warmup_steps=1, decay_steps=4))
    ts = steps.TrainSettings(**kw, opt=adamw.OptConfig(
        peak_lr=1e-3, warmup_steps=1, decay_steps=4))
    jo = jadamw.init(jp, dataclasses.replace(jts.opt,
                                             state_dtype=jnp.dtype(sdt)))
    to = adamw.init(tp, steps.opt_config(cfg, ts))
    if comp != "none":
        jo["ef"], to["ef"] = jef_init(jp), ef_init(tp)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jts))
    step = steps.make_train_step(cfg, ts)
    for i in range(3):
        jb, tb = lm_batch(cfg.padded_vocab, step=i, batch=4, seq=32, seed=2)
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, m = step(tp, to, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    want = dict(jmodule.tree_paths({"p": jp, "o": jo}))
    got = dict(module.tree_paths({"p": tp, "o": to}))
    assert list(got) == list(want)
    assert to["m"]["embed"]["embedding"].dtype == getattr(torch, sdt)
    assert int(to["step"]) == 3
    misses = total = 0
    for path, t in got.items():
        w = np.asarray(want[path], np.float64)
        g = t.double().numpy()
        assert g.shape == w.shape, path
        bad = np.abs(g - w) > TOL + TOL * np.abs(w)
        if comp != "int8":
            assert not bad.any(), (path, np.abs(g - w).max())
        misses += int(bad.sum())
        total += w.size
    assert misses <= INT8_MISS_FRACTION * total, (misses, total)


def test_microbatches_split_as_the_reference_reshape(monkeypatch):
    """Row ``j * micro + i`` of the global batch is row i of microbatch
    j, the microbatches in order; a batch that does not split raises."""
    _, cfg = cfgs("dense", compute_dtype="float32")
    _, tp = trees("dense")
    seen = []
    real = T.lm_loss

    def recording(params, batch, cfg, **kw):
        seen.append(batch["tokens"].clone())
        return real(params, batch, cfg, **kw)

    monkeypatch.setattr(T, "lm_loss", recording)
    ts = steps.TrainSettings(microbatch=2)
    step = steps.make_train_step(cfg, ts)
    _, tb = lm_batch(cfg.padded_vocab, batch=6, seq=8)
    step(tp, adamw.init(tp, steps.opt_config(cfg, ts)), tb)
    want = np.asarray(tb["tokens"]).reshape(3, 2, 8)
    assert [s.tolist() for s in seen] == want.tolist()
    _, odd = lm_batch(cfg.padded_vocab, batch=5, seq=8)
    with pytest.raises(ValueError, match="does not split"):
        step(tp, adamw.init(tp, steps.opt_config(cfg, ts)), odd)


def test_bf16_accumulator_matches_reference():
    """``accum_dtype="bfloat16"``: the gradients summed in bf16 in
    microbatch order, divided in bf16, as the reference's scan does."""
    jcfg, cfg = cfgs("dense", compute_dtype="float32")
    jp, tp = trees("dense")
    jts = jsteps.TrainSettings(microbatch=1, accum_dtype="bfloat16")
    ts = steps.TrainSettings(microbatch=1, accum_dtype="bfloat16")
    jb, tb = lm_batch(cfg.padded_vocab, batch=3, seq=16)
    jp2, _, jm = jax.jit(jsteps.make_train_step(jcfg, jts))(
        jp, jadamw.init(jp, jts.opt), jb)
    tp2, _, m = steps.make_train_step(cfg, ts)(
        tp, adamw.init(tp, ts.opt), tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3)
    want = dict(jmodule.tree_paths(jp2))
    for path, t in module.tree_paths(tp2):
        close(t, want[path])


# ---------------------------------------------------------------------------
# prefill / serve steps and shapes
# ---------------------------------------------------------------------------

def test_prefill_and_serve_step_match_reference():
    """The steps fill a bf16 cache, as the reference's do; the prefill's
    attention is the flash route, whose softmax weights stay f32 where the
    reference rounds them to the cache's dtype before the product with V
    (1e-3 apart; the plain route, which rounds them too, within 1e-4)."""
    jcfg, cfg = cfgs("dense", compute_dtype="float32")
    jp, tp = trees("dense")
    jb, tb = lm_batch(cfg.padded_vocab, batch=2, seq=12)
    jlogits, jcache = jax.jit(jsteps.make_prefill(jcfg, None))(
        jp, {"tokens": jb["tokens"]})
    want_k = np.asarray(jcache["kv"]["k"].astype(jnp.float32))
    logits, cache = steps.make_prefill(cfg)(tp, {"tokens": tb["tokens"]})
    close(logits, jlogits, 1e-2)
    # layer 0's keys precede any attention output
    np.testing.assert_array_equal(cache["kv"]["k"][0].float().numpy(),
                                  want_k[0])
    plain, pcache, _ = T.model_apply(
        tp, {"tokens": tb["tokens"], "cache_pos": 0}, cfg, mode="prefill",
        cache=T.init_cache(cfg, 2, 12, device="cpu"), flash=False)
    close(plain, jlogits)
    np.testing.assert_array_equal(pcache["kv"]["k"].float().numpy(), want_k)
    # decode one token into a cache with room for it
    jc = JT.init_cache(jcfg, 2, 16)
    c = T.init_cache(cfg, 2, 16, device="cpu")
    pre = {"tokens": jb["tokens"], "cache_pos": jnp.int32(0)}
    _, jc, _ = JT.model_apply(jp, pre, jcfg, mode="prefill", cache=jc)
    T.model_apply(tp, {"tokens": tb["tokens"], "cache_pos": 0}, cfg,
                  mode="prefill", cache=c)
    nxt = np.argmax(np.asarray(jlogits)[:, -1], -1).astype(np.int32)[:, None]
    jtok, _ = jax.jit(jsteps.make_serve_step(jcfg))(
        jp, jc, {"tokens": jnp.asarray(nxt), "cache_pos": jnp.int32(12)})
    tok, _ = steps.make_serve_step(cfg)(
        tp, c, {"tokens": torch.from_numpy(nxt), "cache_pos": 12})
    assert tok.dtype == torch.int32
    assert tok.tolist() == np.asarray(jtok).tolist()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_abstract_params_and_opt_state_match_the_reference_shapes(family):
    jcfg, cfg = cfgs(family)
    ts = steps.TrainSettings(compression="int8")
    jts = jsteps.TrainSettings(compression="int8")
    jp = jsteps.abstract_params(jcfg)
    jo = jsteps.abstract_opt_state(jcfg, jp, jts)
    tp = steps.abstract_params(cfg)
    to = steps.abstract_opt_state(cfg, tp, ts)
    for want, got in ((jp, tp), (jo, to)):
        want = dict(jmodule.tree_paths(want))
        got = dict(module.tree_paths(got))
        assert list(got) == list(want)
        for path, t in got.items():
            assert t.device.type == "meta", path
            assert tuple(t.shape) == want[path].shape, path
            assert str(t.dtype).removeprefix("torch.") == \
                str(want[path].dtype), path
    real = T.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert [(p, t.shape, t.dtype) for p, t in module.tree_paths(real)] == \
        [(p, t.shape, t.dtype) for p, t in module.tree_paths(tp)]


def test_unported_families_raise_in_the_train_step():
    _, cfg = cfgs("dense")
    with pytest.raises(NotImplementedError, match="not ported"):
        steps.make_train_step(dataclasses.replace(cfg, family="retnet"),
                              steps.TrainSettings())


# ---------------------------------------------------------------------------
# tree helpers
# ---------------------------------------------------------------------------

def test_tree_helpers_match_reference():
    """``tree_paths``' strings and order, ``map_with_path``'s calls,
    ``cast_tree`` and ``DTypes`` over an LM tree with its optimizer
    state (an int32 step) and a list."""
    jp, tp = trees("moe")
    jo = jadamw.init(jp, jadamw.OptConfig())
    to = adamw.init(tp, adamw.OptConfig())
    jtree = {"params": jp, "opt": jo, "caches": [{"b": jnp.zeros(2)},
                                                 {"a": jnp.ones(1)}]}
    ttree = {"opt": to, "params": tp, "caches": [{"b": torch.zeros(2)},
                                                 {"a": torch.ones(1)}]}
    want = [(p, np.asarray(x)) for p, x in jmodule.tree_paths(jtree)]
    got = list(module.tree_paths(ttree))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=p)
    jcalls, tcalls = [], []
    jmodule.map_with_path(lambda p, x: jcalls.append(p), jtree)
    mapped = module.map_with_path(lambda p, x: tcalls.append(p) or p, ttree)
    assert tcalls == jcalls
    assert list(mapped) == list(ttree)          # the input's key order
    assert mapped["caches"][1]["a"] == "caches/1/a"
    cast = module.cast_tree(ttree, torch.bfloat16)
    jcast = jmodule.cast_tree(jtree, jnp.bfloat16)
    for (p, g), (_, w) in zip(module.tree_paths(cast),
                              jmodule.tree_paths(jcast)):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), p
    assert [f.name for f in dataclasses.fields(module.DTypes)] == \
        [f.name for f in dataclasses.fields(jmodule.DTypes)]
    d = module.DTypes()
    assert (d.param, d.compute, d.accum) == (torch.float32, torch.bfloat16,
                                             torch.float32)
