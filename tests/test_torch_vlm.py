"""The port's VLM family (qwen2-vl-7b: M-RoPE over three position streams,
QKV bias, 28 heads over 4 KV heads at full width, stub image embeddings
merged at the sequence front) against the JAX reference at ``reduced()``
(2 layers, 8 image tokens, sections 4/6/6). One reference ``init_model``
tree, its zero QKV biases and unit norm scales set to seeded nonzero
values, is carried across by ``weights.lm_from_reference``. The JAX side
runs jitted, with no mesh set (under a mesh its sharding constraints fail
on this JAX: ROADMAP §3). The M-RoPE streams are seeded and distinct, so
that each section's rotation is seen.

Tolerances:
  * ``apply_mrope``: atol = rtol = 1e-6;
  * logits, caches, the loss and train-step params in f32: atol = rtol =
    1e-4 (both sides compute in f32 from the same weights and differ in
    the order of f32 sums); every gradient leaf within 1e-4 of its leaf's
    largest |g|;
  * train-mode logits in bf16 compute: relative L2 error under
    ``BF16_LOGITS_L2`` (measured 0.0072-0.0079);
  * greedy engine tokens: equal.
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
from repro.launch.serve import Engine as JEngine, Request as JRequest
from repro.nn import layers as jlayers
from repro.nn import module as jmodule
from repro.nn import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.launch.serve import Engine, Request
from repro_torch.nn import attention as attn
from repro_torch.nn import layers
from repro_torch.nn import module
from repro_torch.nn import transformer as T
from repro_torch.weights import lm_from_reference
from torch_threads import one_thread  # noqa: F401  (autouse)

ARCH = "qwen2-vl-7b"
ROPE_TOL = 1e-6
BF16_LOGITS_L2 = 2e-2
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@functools.lru_cache(maxsize=None)
def setup():
    """(JAX config, port config, numpy tree, the port's params from it)."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tree = nonzero_norms_and_biases(jax.tree_util.tree_map(np.asarray, jp),
                                    seed=7)
    return jcfg, cfg, tree, lm_from_reference(tree, cfg, device="cpu")


def batch(cfg, b, s, seed, image=True):
    """Seeded tokens (B, S), bf16 image embeddings (B, img_tokens, D) and
    distinct M-RoPE streams (3, B, S), as a JAX and a torch batch."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    pos = rng.integers(0, 3 * s, (3, b, s)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "mrope_positions": jnp.asarray(pos)}
    tb = {"tokens": t_(toks).long(), "mrope_positions": t_(pos)}
    if image:
        img = jnp.asarray(rng.standard_normal(
            (b, cfg.img_tokens, cfg.d_model)).astype(np.float32)).astype(
                jnp.bfloat16)
        jb["image_embeds"] = img
        tb["image_embeds"] = t_(img.astype(jnp.float32)).bfloat16()
    return jb, tb


@functools.lru_cache(maxsize=None)
def japply(mode, dtype="float32"):
    return jax.jit(functools.partial(JT.model_apply, mode=mode,
                                     compute_dtype=DTYPES[dtype][1]),
                   static_argnames=("cfg",))


# ---------------------------------------------------------------------------
# configs, trees, M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want, got = dataclasses.asdict(jcfg), dataclasses.asdict(cfg)
    assert got == {k: want[k] for k in got}
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert sum(cfg.mrope_sections) == cfg.head_dim // 2
    assert (cfg.family, cfg.n_heads // cfg.n_kv_heads) == (
        "vlm", 2 if reduced else 7)


def test_init_model_tree_matches_reference_layout():
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
    assert "layers/attn/wq/bias" in got


@pytest.mark.parametrize("dh,sections", [(32, (4, 6, 6)),
                                         (128, (16, 24, 24))])
def test_apply_mrope_matches_reference(dh, sections):
    """Three distinct streams, each driving its own section of the
    frequency slots; at three equal streams M-RoPE is ``apply_rope``."""
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 20, 4, dh)).astype(np.float32)
    pos = rng.integers(0, 2048, (3, 2, 20))
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections,
                               theta=1e6)
    got = layers.apply_mrope(t_(x), t_(pos), sections, theta=1e6)
    close(got, want, ROPE_TOL)
    flat = np.broadcast_to(pos[0], (3, 2, 20))
    same = layers.apply_mrope(t_(x), t_(flat), sections, theta=1e6)
    assert torch.equal(same, layers.apply_rope(t_(x), t_(pos[0]),
                                               theta=1e6))
    # each stream moves only its own section's slots
    moved = pos.copy()
    moved[1] += 1
    diff = (layers.apply_mrope(t_(x), t_(moved), sections, theta=1e6)
            != got).any(dim=(0, 1, 2))
    half = dh // 2
    lo, hi = sections[0], sections[0] + sections[1]
    assert diff[lo:hi].all() and diff[half + lo:half + hi].all()
    assert not diff[:lo].any() and not diff[hi:half].any()
    with pytest.raises(ValueError, match="sum"):
        layers.apply_mrope(t_(x), t_(pos), (4, 6, 5))


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_model_apply_train_mode_matches_reference(dtype, flash):
    """Image embeddings over the first 8 positions, distinct M-RoPE
    streams."""
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


def test_image_embeddings_longer_than_the_sequence_raise():
    _, cfg, _, tp = setup()
    _, tb = batch(cfg, 1, cfg.img_tokens - 1, seed=3)
    with pytest.raises(ValueError, match="image embeddings"):
        T.model_apply(tp, tb, cfg, mode="train")


@pytest.mark.parametrize("flash", [True, False])
def test_prefill_and_decode_match_reference(flash):
    """Prefill 12 tokens (image embeddings in front, M-RoPE streams) into
    a cache, then decode 3 tokens with their own streams, the last at
    per-row positions: logits and the cache within 1e-4."""
    jcfg, cfg, tree, tp = setup()
    b, s = 2, 12
    jb, tb = batch(cfg, b, s, seed=4)
    jc = JT.init_cache(jcfg, b, s + 4, dtype=jnp.float32)
    tc = T.init_cache(cfg, b, s + 4, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    steps_ = [(jb, tb, 0)]
    for pos in (s, s + 1, np.array([s + 2, s + 1], np.int32)):
        tk = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        mp = rng.integers(0, 40, (3, b, 1)).astype(np.int32)
        steps_.append(({"tokens": jnp.asarray(tk),
                        "mrope_positions": jnp.asarray(mp)},
                       {"tokens": t_(tk).long(), "mrope_positions": t_(mp)},
                       pos))
    for i, (jbatch, tbatch, pos) in enumerate(steps_):
        mode = "prefill" if i == 0 else "decode"
        jbatch = dict(jbatch, cache_pos=jnp.asarray(pos))
        tbatch = dict(tbatch, cache_pos=pos if np.ndim(pos) == 0
                      else t_(pos).long())
        jl, jc, _ = japply(mode)(tree, jbatch, cfg=jcfg, cache=jc)
        tl, tc, _ = T.model_apply(tp, tbatch, cfg, mode=mode, cache=tc,
                                  compute_dtype=torch.float32, flash=flash)
        close(tl, jl)
    for name in ("k", "v", "positions"):
        close(tc["kv"][name], jc["kv"][name])


def test_mrope_prefill_stays_on_the_flash_kernel(monkeypatch):
    """Passing M-RoPE streams does not take the prefill off the flash
    route: the causal mask is by sequence index, so the wrapper gets one
    causal call a layer, q over the unexpanded KV heads."""
    _, cfg, _, tp = setup()
    seen = []
    real = attn.ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), kw["causal"]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(attn.ops, "flash_attention", spy)
    _, tb = batch(cfg, 1, 10, seed=6)
    cache = T.init_cache(cfg, 1, 16, dtype=torch.bfloat16, device="cpu")
    T.model_apply(tp, dict(tb, cache_pos=0), cfg, mode="prefill",
                  cache=cache, compute_dtype=torch.bfloat16)
    T.model_apply(tp, tb, cfg, mode="train", compute_dtype=torch.bfloat16)
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert seen == [((1, h, 10, dh), (1, kv, 10, dh), True)] * (
        2 * cfg.n_layers)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_lm_loss_and_every_gradient_leaf_match_reference():
    jcfg, cfg, tree, tp = setup()
    check_loss_and_grads(jcfg, cfg, tree, tp, *batch(cfg, 2, 16, seed=8))


def test_three_train_steps_split_mrope_positions_as_the_reference():
    """Three steps of a global batch of 4 in microbatches of 2 with
    distinct M-RoPE streams in every row: the (3, B, S) positions are cut
    on their batch dim, as the reference's ``mrope_split`` cuts them, so
    each row keeps its own streams. Losses, gradient norms, learning
    rates, params and moments within 1e-4."""
    jcfg, cfg, tree, tp = setup()
    check_three_train_steps(jcfg, cfg, tree, tp,
                            lambda i: batch(cfg, 4, 12, seed=10 + i))


def test_microbatch_cuts_mrope_positions_on_their_batch_dim():
    pos = torch.arange(3 * 4 * 5).reshape(3, 4, 5)
    assert torch.equal(steps.microbatch("mrope_positions", pos, 2, 4),
                       pos[:, 2:4])
    toks = torch.arange(20).reshape(4, 5)
    assert torch.equal(steps.microbatch("tokens", toks, 2, 4), toks[2:4])


# ---------------------------------------------------------------------------
# serving and checkpoints
# ---------------------------------------------------------------------------

def test_engine_matches_reference_engine():
    """qwen2-vl served as a text model by both engines (the reference's
    with no mesh): two slots, three prompts (5, 6 and 40 tokens; the
    third waits for a free slot), f32; the greedy tokens are equal."""
    jcfg, cfg, tree, tp = setup()
    prompts = [[5, 9, 2, 14, 3], [7, 7, 1, 30, 11, 2],
               np.random.default_rng(7).integers(0, cfg.vocab, 40).tolist()]
    je = JEngine(jcfg, slots=2, cache_len=64, seed=0,
                 compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    je.params = jax.tree_util.tree_map(jnp.asarray, tree)
    te = Engine(cfg, slots=2, cache_len=64, params=tp,
                compute_dtype=torch.float32, cache_dtype=torch.float32,
                device="cpu")
    for i, p in enumerate(prompts):
        je.submit(JRequest(rid=i, prompt=p, max_new=5))
        te.submit(Request(rid=i, prompt=p, max_new=5))
    want = [r.out for r in sorted(je.run(), key=lambda r: r.rid)]
    got = [r.out for r in sorted(te.run(), key=lambda r: r.rid)]
    assert got == want
    assert all(len(o) == 5 for o in got)


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoint_crosses_between_the_packages(direction, tmp_path):
    _, cfg, tree, tp = setup()
    check_checkpoint_crosses(cfg, tree, tp, direction, tmp_path)
