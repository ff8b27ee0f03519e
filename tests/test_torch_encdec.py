"""The port's encoder-decoder family (whisper-large-v3: a non-causal
encoder over precomputed frame embeddings, sinusoidal positions, a
cross-attention block in every decoder layer, layernorm, gelu MLP with
biases) against the JAX reference at ``reduced()`` (2 + 2 layers, 16
frames). One reference ``init_model`` tree, its zero biases and unit
scales set to seeded nonzero values, is carried across by
``weights.lm_from_reference``. The JAX side runs jitted, with no mesh set
(under a mesh its sharding constraints fail on this JAX: ROADMAP §3).
Frames are seeded bf16, as the reference's input spec makes them.

Tolerances:
  * ``_sinusoidal`` and ``encode`` in f32: atol = rtol = 1e-6 (at a
    position p past the first few, ``_sinusoidal`` within p ulp of its
    frequency: XLA's CPU exp is not correctly rounded);
  * logits, caches, the loss and train-step params in f32: atol = rtol =
    1e-4 (both sides compute in f32 from the same weights and differ in
    the order of f32 sums); every gradient leaf within 1e-4 of its leaf's
    largest |g|;
  * train-mode logits in bf16 compute: relative L2 error under
    ``BF16_LOGITS_L2`` (both packages round the products to bf16 at the
    same points and sum in different orders; measured 0.0066-0.0068);
  * prefill plus decode against the port's own train-mode forward: the
    reference's bar, atol = rtol = 5e-2 (``tests/test_archs.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import (check_checkpoint_crosses, check_loss_and_grads,
                       check_three_train_steps, close, leaf_paths,
                       nonzero_norms_and_biases, t_)
from repro.configs.base import get_config as jget_config
from repro.nn import module as jmodule
from repro.nn import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch.serve import Engine
from repro_torch.nn import attention as attn
from repro_torch.nn import module
from repro_torch.nn import transformer as T
from repro_torch.weights import lm_from_reference
from torch_threads import one_thread  # noqa: F401  (autouse)

ARCH = "whisper-large-v3"
ENC_TOL = 1e-6
BF16_LOGITS_L2 = 2e-2
REF_DECODE_TOL = 5e-2
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@functools.lru_cache(maxsize=None)
def setup():
    """(JAX config, port config, numpy tree, the port's params from it)."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tree = nonzero_norms_and_biases(jax.tree_util.tree_map(np.asarray, jp),
                                    seed=5)
    return jcfg, cfg, tree, lm_from_reference(tree, cfg, device="cpu")


def batch(cfg, b, s, seed):
    """Seeded tokens (B, S) and bf16 frames (B, n_frames, D), as a JAX and
    a torch batch."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    frames = jnp.asarray(rng.standard_normal(
        (b, cfg.n_frames, cfg.d_model)).astype(np.float32)).astype(
            jnp.bfloat16)
    return ({"tokens": jnp.asarray(toks), "frames": frames},
            {"tokens": t_(toks).long(),
             "frames": t_(frames.astype(jnp.float32)).bfloat16()})


@functools.lru_cache(maxsize=None)
def japply(mode, dtype="float32"):
    return jax.jit(functools.partial(JT.model_apply, mode=mode,
                                     compute_dtype=DTYPES[dtype][1]),
                   static_argnames=("cfg",))


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    for j, t in ((jcfg, cfg), (jcfg.encoder_cfg(), cfg.encoder_cfg())):
        want, got = dataclasses.asdict(j), dataclasses.asdict(t)
        assert got == {k: want[k] for k in got}
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert (cfg.family, cfg.head_dim, cfg.n_frames) == (
        "encdec", 32 if reduced else 64, 16 if reduced else 1500)


def test_init_model_tree_matches_reference_layout():
    """The seeded tree has the reference's paths, shapes and dtypes: the
    encoder's stacked layers and ``enc_norm``, and each decoder layer's
    ``cross`` and ``ln_cross``."""
    jcfg, cfg, tree, _ = setup()
    tp = T.init_model(torch.Generator().manual_seed(3), cfg, device="cpu")
    want, got = dict(leaf_paths(tree)), dict(leaf_paths(tp))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).removeprefix("torch.") == \
            str(want[path].dtype), path
    assert module.param_count(tp) == jmodule.param_count(
        JT.init_model(jax.random.PRNGKey(0), jcfg))
    assert got["enc_layers/attn/wq/kernel"].shape[0] == cfg.encoder_layers
    assert "layers/cross/wk/kernel" in got and "enc_norm/bias" in got
    assert "enc_layers/cross/wk/kernel" not in got


def test_lm_from_reference_checks_the_encoder_and_cross_leaves():
    _, cfg, tree, _ = setup()
    for path in ("enc_layers/attn/wv/kernel", "enc_layers/ln2/bias",
                 "enc_norm/scale", "layers/cross/wo/kernel",
                 "layers/ln_cross/bias", "enc_layers/mlp/down/kernel"):
        *parents, key = path.split("/")
        for change in ("drop", "reshape"):
            t = jax.tree_util.tree_map(lambda x: x, tree)
            node = t
            for p in parents:
                node = node[p]
            if change == "drop":
                del node[key]
            else:
                node[key] = node[key][..., :-1]
            with pytest.raises(ValueError, match=path):
                lm_from_reference(t, cfg, device="cpu")


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [128, 1280])
def test_sinusoidal_matches_reference(d):
    """Within 1e-6 at the first positions. The frequencies are within one
    ulp: both packages take exp of the same f32 arguments, and XLA's CPU
    exp is not correctly rounded (5 of reduced whisper's 64 frequencies
    and 43 of the full width's 640 are an ulp off the f64 exp rounded to
    f32, where torch's is), so an angle at position p can differ by p
    ulp of its frequency, 1.2e-4 at p = 1500: past the first positions
    the bar is that propagated ulp, ``p * 2^-23 + 1e-6``."""
    pos = np.random.default_rng(d).integers(0, 1500, (3, 40))
    pos[0, :8] = np.arange(8)
    want = np.asarray(JT._sinusoidal(jnp.asarray(pos, jnp.int32), d),
                      np.float64)
    got = T._sinusoidal(t_(pos), d)
    assert got.dtype == torch.float32 and got.shape == (3, 40, d)
    got = got.double().numpy()
    close(got[0, :8], want[0, :8], ENC_TOL)
    bar = pos[..., None] * 2.0 ** -23 + ENC_TOL
    assert (np.abs(got - want) <= bar).all(), np.abs(got - want).max()


@pytest.mark.parametrize("flash", [True, False])
def test_encode_matches_reference(flash):
    """The encoder's output in f32: non-causal attention over the 16
    frames (the flash route's plain version, or the chunked softmax)."""
    jcfg, cfg, tree, tp = setup()
    jb, tb = batch(cfg, 2, 4, seed=1)
    want = jax.jit(functools.partial(JT.encode, compute_dtype=jnp.float32),
                   static_argnums=2)(tree, jb["frames"], jcfg)
    got = T.encode(tp, tb["frames"], cfg, compute_dtype=torch.float32,
                   flash=flash)
    assert got.shape == (2, cfg.n_frames, cfg.d_model)
    close(got, want, ENC_TOL)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_model_apply_train_mode_matches_reference(dtype, flash):
    jcfg, cfg, tree, tp = setup()
    jb, tb = batch(cfg, 2, 24, seed=2)
    jl, _, _ = japply("train", dtype)(tree, jb, cfg=jcfg)
    tl, _, _ = T.model_apply(tp, tb, cfg, mode="train",
                             compute_dtype=DTYPES[dtype][0], flash=flash)
    assert tl.shape == (2, 24, cfg.padded_vocab)
    if dtype == "float32":
        close(tl, jl)
    else:
        w = np.asarray(jl, np.float64)
        err = np.linalg.norm(tl.double().numpy() - w) / np.linalg.norm(w)
        assert err < BF16_LOGITS_L2, err


@pytest.mark.parametrize("flash", [True, False])
def test_prefill_and_decode_match_reference(flash):
    """The reference's ``test_whisper_decode`` and ``test_reduced_decode_
    matches_prefill`` composed: prefill 8 tokens into a cache (the cross
    keys and values written from the encoder), then 3 decode steps that
    read them from the cache, the last at per-row positions. Logits and
    every cache leaf within 1e-4 of the reference's; the logits within
    the reference's own 5e-2 of the port's train-mode forward over the
    same tokens."""
    jcfg, cfg, tree, tp = setup()
    b, s, extra = 2, 8, 3
    jb, tb = batch(cfg, b, s + extra, seed=3)
    toks = np.asarray(jb["tokens"])
    jc = JT.init_cache(jcfg, b, s + extra, dtype=jnp.float32)
    tc = T.init_cache(cfg, b, s + extra, dtype=torch.float32, device="cpu")
    steps_ = [("prefill", toks[:, :s], 0)] + [
        ("decode", toks[:, t:t + 1], t) for t in range(s, s + extra - 1)] + [
        ("decode", toks[:, s + extra - 1:], np.array([s + 2, s + 1],
                                                     np.int32))]
    got = []
    for mode, tk, pos in steps_:
        jbatch = {"tokens": jnp.asarray(tk), "cache_pos": jnp.asarray(pos)}
        tbatch = {"tokens": t_(tk).long(),
                  "cache_pos": pos if np.ndim(pos) == 0 else t_(pos).long()}
        if mode == "prefill":
            jbatch["frames"], tbatch["frames"] = jb["frames"], tb["frames"]
        jl, jc, _ = japply(mode)(tree, jbatch, cfg=jcfg, cache=jc)
        tl, tc, _ = T.model_apply(tp, tbatch, cfg, mode=mode, cache=tc,
                                  compute_dtype=torch.float32, flash=flash)
        assert tl.shape == (b, 1, cfg.padded_vocab)
        close(tl, jl)
        got.append(tl[:, 0])
    for path, leaf in leaf_paths(tc):
        close(leaf, dict(leaf_paths(jc))[path])
    assert bool(tc["cross_k"].abs().sum(-1).gt(0).all())
    full, _, _ = T.model_apply(tp, tb, cfg, mode="train",
                               compute_dtype=torch.float32, flash=flash)
    want = full[:, s - 1:s + extra].double().numpy()
    want[1, -1] = np.nan      # row 1's last step sat at another position
    got = torch.stack(got, 1).double().numpy()
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=REF_DECODE_TOL,
                               atol=REF_DECODE_TOL)


def test_bf16_prefill_runs_the_flash_kernel_non_causally(monkeypatch):
    """The main path's prefill (bf16): the flash wrapper gets the
    encoder's self-attention (non-causal, 16 keys), then each decoder
    layer's causal self-attention and its cross-attention (non-causal, the
    prompt's 5 queries over the 16 frames' keys); a decode step calls it
    never (its cross-attention reads the cache by the grouped softmax)."""
    _, cfg, _, tp = setup()
    seen = []
    real = attn.ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2], kw["causal"]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(attn.ops, "flash_attention", spy)
    _, tb = batch(cfg, 1, 5, seed=4)
    cache = T.init_cache(cfg, 1, 8, dtype=torch.bfloat16, device="cpu")
    T.model_apply(tp, dict(tb, cache_pos=0), cfg, mode="prefill",
                  cache=cache, compute_dtype=torch.bfloat16)
    f = cfg.n_frames
    assert seen == [(f, f, False)] * cfg.encoder_layers + [
        (5, 5, True), (5, f, False)] * cfg.n_layers
    seen.clear()
    T.model_apply(tp, {"tokens": tb["tokens"][:, :1], "cache_pos": 5}, cfg,
                  mode="decode", cache=cache, compute_dtype=torch.bfloat16)
    assert seen == []


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_lm_loss_and_every_gradient_leaf_match_reference():
    jcfg, cfg, tree, tp = setup()
    grads = check_loss_and_grads(jcfg, cfg, tree, tp, *batch(cfg, 2, 12, 6))
    for path in ("layers/cross/wk/kernel", "enc_layers/attn/wq/kernel"):
        assert float(grads[path].abs().max()) > 0, path


def test_three_train_steps_match_reference():
    """Three steps of a global batch of 4 in microbatches of 2, AdamW:
    losses, gradient norms and learning rates, then params and moments."""
    jcfg, cfg, tree, tp = setup()
    check_three_train_steps(jcfg, cfg, tree, tp,
                            lambda i: batch(cfg, 4, 12, seed=10 + i))


# ---------------------------------------------------------------------------
# serving and checkpoints
# ---------------------------------------------------------------------------

def test_engine_refuses_an_encoder_decoder_config():
    """The reference's Engine never reads frames (its prefill fails with a
    KeyError on ``batch["frames"]``); the port's says so up front, before
    it draws any weight."""
    _, cfg, _, _ = setup()
    with pytest.raises(ValueError, match="takes no encoder frames"):
        Engine(cfg, slots=2, cache_len=16, device="cpu")


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoint_crosses_between_the_packages(direction, tmp_path):
    """A reduced whisper tree (encoder layers and cross-attention
    included) saved by one package's checkpointer restores in the other's
    bit for bit."""
    _, cfg, tree, tp = setup()
    check_checkpoint_crosses(cfg, tree, tp, direction, tmp_path)
