"""The port's dense family past smollm: stablelm-12b (QK-norm, a quarter of
each head rotated, layernorm, swiglu; head dim 160 at full width),
glm4-9b (QKV bias, half rotary, 32 q heads over 2 KV heads) and
qwen1.5-110b (QKV bias, 64 q heads over 8, bf16 params and moments; three
train steps too), against the JAX reference at ``reduced()`` in f32
compute, stablelm again at ``reduced(head_dim=160)`` so that the CPU
route sees the full width's head dim (a rotary width of 40), and glm4 at
``reduced(head_dim=96)``, ``reduced(head_dim=256)``,
``reduced(head_dim=512)`` and ``reduced(head_dim=576)`` (rotary widths
48, 128, 256 and 288): phi-3-mini's head dim, Qwen3-Next's,
DeepSeek-V4's and sarvam-105b's, which kernel 7 takes on the card in
both dtypes (past 256 in column slices). One reference ``init_model`` tree is carried
across by ``weights.lm_from_reference``, after its zero biases and unit
scales (QKV biases, layernorm scales and biases, QK-norm and the other
norms' scales) are set to seeded nonzero values: the reference's init
would leave them unseen by the comparison. The JAX side runs jitted, with
no mesh set (under a mesh its sharding constraints fail on this JAX:
ROADMAP §3).

Also pins ``init_model``'s in-place build: each layer drawn into the
stacked leaves gives the bits of the list-and-``torch.stack`` build it
replaced (and of ``trunc_normal``'s scaling into a new tensor), for every
ported family.

Tolerance: atol = rtol = 1e-4 on logits and caches, as in
``test_torch_lm.py``: both sides compute in f32 from the same weights and
differ in the order of f32 sums. Greedy tokens must be equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import close, leaf_paths, nonzero_norms_and_biases, t_
from repro.configs.base import get_config as jget_config
from repro.launch.serve import Engine as JEngine, Request as JRequest
from repro.nn import module as jmodule
from repro.nn import transformer as JT
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as flash_kernels
from repro_torch.launch.serve import Engine, Request
from repro_torch.nn import attention as attn
from repro_torch.nn import layers, module
from repro_torch.nn import transformer as T
from repro_torch.weights import lm_from_reference
from torch_threads import one_thread  # noqa: F401  (autouse)

F32 = dict(compute_dtype=torch.float32)
ARCHS = ("stablelm-12b", "glm4-9b", "qwen1.5-110b")
# the reduced configs compared: (arch, reduced() overrides)
CASES = {"stablelm": ("stablelm-12b", {}), "glm4": ("glm4-9b", {}),
         "stablelm_dh160": ("stablelm-12b", {"head_dim": 160}),
         "glm4_dh96": ("glm4-9b", {"head_dim": 96}),
         "glm4_dh256": ("glm4-9b", {"head_dim": 256}),
         "glm4_dh512": ("glm4-9b", {"head_dim": 512}),
         "glm4_dh576": ("glm4-9b", {"head_dim": 576}),
         "qwen110b": ("qwen1.5-110b", {})}


@functools.lru_cache(maxsize=None)
def japply(mode):
    """The reference's ``model_apply`` in f32, jitted."""
    return jax.jit(functools.partial(JT.model_apply, mode=mode,
                                     compute_dtype=jnp.float32),
                   static_argnames=("cfg",))


@functools.lru_cache(maxsize=None)
def setup(case):
    """(JAX config, port config, numpy tree with nonzero norms and biases,
    the port's params from it)."""
    arch, kw = CASES[case]
    jcfg, cfg = jget_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tree = nonzero_norms_and_biases(jax.tree_util.tree_map(np.asarray, jp),
                                    seed=len(case))
    return jcfg, cfg, tree, lm_from_reference(tree, cfg, device="cpu")


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, reduced):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(cfg)
    assert got == {k: want[k] for k in got}
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert (cfg.head_dim, cfg.family) == (jcfg.head_dim, "dense")


def test_full_width_head_dims():
    """stablelm-12b's head dim is 160 (5120 / 32) and a quarter of it, 40,
    rotates; glm4-9b's is 128 with half rotated, over 2 KV heads (group
    16). Kernel 7 takes every head dim from 1 up in both dtypes, with no
    table of head dims left to consult (the reduced glm4 cases carry 512
    and 576 with rotary widths 256 and 288)."""
    s, g = get_config("stablelm-12b"), get_config("glm4-9b")
    assert layers.rope_freqs(s.head_dim, rotary_frac=s.rotary_frac)[1] == 40
    assert (s.head_dim, s.n_heads // s.n_kv_heads) == (160, 4)
    assert layers.rope_freqs(g.head_dim, rotary_frac=g.rotary_frac)[1] == 64
    assert (g.head_dim, g.n_heads // g.n_kv_heads) == (128, 16)
    for dh, rotary in ((512, 256), (576, 288)):
        cfg = get_config("glm4-9b").reduced(head_dim=dh)
        assert cfg.head_dim == dh
        assert layers.rope_freqs(dh, rotary_frac=cfg.rotary_frac)[1] == \
            rotary
    assert not hasattr(flash_kernels, "HEAD_DIMS")
    assert not hasattr(flash_kernels, "MAX_HEAD_DIM")


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_model_tree_matches_reference_layout(case):
    """The port's seeded tree has the reference's paths, shapes and dtypes
    (QKV biases, QK-norm scales, layernorm biases included) and its
    parameter count."""
    jcfg, cfg, tree, _ = setup(case)
    tp = T.init_model(torch.Generator().manual_seed(3), cfg, device="cpu")
    want = dict(leaf_paths(tree))
    got = dict(leaf_paths(tp))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).removeprefix("torch.") == \
            str(want[path].dtype), path
    assert module.param_count(tp) == jmodule.param_count(
        JT.init_model(jax.random.PRNGKey(0), jcfg))
    assert ("layers/attn/wq/bias" in got) == cfg.qkv_bias
    assert ("layers/attn/q_norm/scale" in got) == cfg.qk_norm
    assert ("layers/ln1/bias" in got) == (cfg.norm == "layernorm")


@pytest.mark.parametrize("case", ["stablelm", "glm4"])
def test_lm_from_reference_checks_the_config_leaves(case):
    """The carry checks the leaves the config implies: a QKV bias, a
    QK-norm scale or a layernorm bias that is missing or of the wrong
    shape raises, naming it."""
    _, cfg, tree, tp = setup(case)
    np.testing.assert_array_equal(tp["layers"]["ln1"]["scale"].numpy(),
                                  tree["layers"]["ln1"]["scale"])
    bad = {"stablelm": ("layers/attn/q_norm/scale", "layers/ln1/bias"),
           "glm4": ("layers/attn/wk/bias", "layers/attn/wv/bias")}[case]
    for path in bad:
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
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_model_apply_train_mode_matches_reference(case):
    """No cache: every position's logits, attention on the flash route."""
    jcfg, cfg, tree, tp = setup(case)
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 70))
    jl, _, _ = japply("train")(tree, {"tokens": jnp.asarray(toks, jnp.int32)},
                               cfg=jcfg)
    tl, _, _ = T.model_apply(tp, {"tokens": t_(toks)}, cfg, mode="train",
                             **F32)
    assert tl.shape == (2, 70, cfg.padded_vocab)
    close(tl, jl)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_apply_prefill_and_decode_match_reference(case):
    """Prefill 77 tokens into a cache (the flash route), then decode one
    token at an aligned position and one at per-row positions; logits and
    the cache within tolerance."""
    jcfg, cfg, tree, tp = setup(case)
    toks = np.random.default_rng(77).integers(0, cfg.vocab, (2, 77))
    jc = JT.init_cache(jcfg, 2, 96, dtype=jnp.float32)
    tc = T.init_cache(cfg, 2, 96, dtype=torch.float32, device="cpu")
    steps = [("prefill", toks, 0), ("decode", toks[:, :1], 77),
             ("decode", toks[:, 1:2], np.array([78, 75], np.int32))]
    for mode, tk, pos in steps:
        jl, jc, _ = japply(mode)(
            tree, {"tokens": jnp.asarray(tk, jnp.int32),
                   "cache_pos": jnp.asarray(pos)}, cfg=jcfg, cache=jc)
        tl, tc, _ = T.model_apply(
            tp, {"tokens": t_(tk).long(),
                 "cache_pos": pos if np.ndim(pos) == 0 else t_(pos).long()},
            cfg, mode=mode, cache=tc, **F32)
        assert tl.shape == (2, 1, cfg.padded_vocab)
        close(tl, jl)
    for name in ("k", "v", "positions"):
        close(tc["kv"][name], jc["kv"][name])


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_reference_engine(case):
    """The reference engine (no mesh) and the port's on one tree with
    nonzero norms and biases: two slots, three prompts (5, 6 and 77
    tokens; the third waits for a free slot), f32; the greedy tokens are
    equal, token for token."""
    jcfg, cfg, tree, tp = setup(case)
    prompts = [[5, 9, 2, 14, 3], [7, 7, 1, 30, 11, 2],
               np.random.default_rng(7).integers(0, cfg.vocab, 77).tolist()]
    je = JEngine(jcfg, slots=2, cache_len=128, seed=0,
                 compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    je.params = jax.tree_util.tree_map(jnp.asarray, tree)
    te = Engine(cfg, slots=2, cache_len=128, params=tp,
                compute_dtype=torch.float32, cache_dtype=torch.float32,
                device="cpu")
    for i, p in enumerate(prompts):
        je.submit(JRequest(rid=i, prompt=p, max_new=6))
        te.submit(Request(rid=i, prompt=p, max_new=6))
    want = [r.out for r in sorted(je.run(), key=lambda r: r.rid)]
    got = [r.out for r in sorted(te.run(), key=lambda r: r.rid)]
    assert got == want
    assert all(len(o) == 6 for o in got)


def test_bf16_prefill_at_dh160_reaches_flash_in_place(monkeypatch):
    """The full width's head dim on the main path's prefill (bf16 compute
    over a bf16 cache): the flash wrapper gets one call a layer, q the
    (B, S, H, 160) projection transposed and k, v slices of the cache,
    each a view TMA reads in place (``_tma_ready`` returns it), KV
    unexpanded."""
    _, cfg, _, tp = setup("stablelm_dh160")
    got = []
    real = attn.ops.flash_attention

    def spy(q, k, v, **kw):
        got.append((q, k, v))
        return real(q, k, v, **kw)
    monkeypatch.setattr(attn.ops, "flash_attention", spy)
    cache = T.init_cache(cfg, 1, 32, dtype=torch.bfloat16, device="cpu")
    T.model_apply(tp, {"tokens": torch.arange(10)[None], "cache_pos": 0},
                  cfg, mode="prefill", cache=cache,
                  compute_dtype=torch.bfloat16)
    assert len(got) == cfg.n_layers
    for q, k, v in got:
        assert q.shape == (1, cfg.n_heads, 10, 160)
        assert k.shape == v.shape == (1, cfg.n_kv_heads, 10, 160)
        assert q.dtype == k.dtype == torch.bfloat16
        assert not q.is_contiguous() and not k.is_contiguous()
        for z in (q, k, v):
            assert flash_kernels._tma_ready(z) is z


# ---------------------------------------------------------------------------
# init_model: the in-place build
# ---------------------------------------------------------------------------

def old_trunc_normal(gen, shape, std=0.02, dtype=torch.float32):
    """``trunc_normal`` as it was: scaled into a new tensor."""
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return x.to(dtype) * std


def stacked_build(gen, cfg):
    """``init_model`` as it was: every layer drawn into a list, then the
    leaves stacked."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)
    ks = module.KeyStream(gen)
    dtype = T.as_dtype(cfg.param_dtype)
    p = {"embed": layers.embedding_init(ks(), cfg.padded_vocab, cfg.d_model,
                                        dtype=dtype),
         "final_norm": T._norm_init(cfg, gen.device)}
    p["layers"] = stack([T.layer_init(ks(), cfg, dtype)
                         for _ in range(cfg.n_layers)])
    if not cfg.tie_embeddings:
        p["head"] = layers.linear_init(ks(), cfg.d_model, cfg.padded_vocab,
                                       dtype=dtype)
    return p


@pytest.mark.parametrize("arch", ["smollm-360m", "hymba-1.5b", "mamba2-130m",
                                  "stablelm-12b", "glm4-9b"])
def test_init_model_bits_equal_the_stacked_build(arch, monkeypatch):
    """Same seed, same bits: the in-place build keeps the generators'
    order (embedding, each layer, the head), so smollm's, hymba's and
    mamba2's seeded weights, and so their served tokens, are what they
    were."""
    cfg = get_config(arch).reduced(n_layers=3)
    got = T.init_model(torch.Generator().manual_seed(11), cfg, device="cpu")
    monkeypatch.setattr(module, "trunc_normal", old_trunc_normal)
    monkeypatch.setattr(layers, "trunc_normal", old_trunc_normal)
    want = stacked_build(torch.Generator().manual_seed(11), cfg)
    got, want = dict(leaf_paths(got)), dict(leaf_paths(want))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        assert torch.equal(got[path], leaf), path
    assert got["layers/ln1/scale"].shape[0] == 3


def test_init_cache_stacked_in_place():
    """The stacked cache built slot by slot: zeros, positions -1, SSM
    state and conv window zero, one (L, ...) leaf each."""
    for arch in ("stablelm-12b", "mamba2-130m"):
        cfg = get_config(arch).reduced(n_layers=3)
        cache = T.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
        for name, leaf in leaf_paths(cache):
            assert leaf.shape[:2] == (3, 2), name
            fill = -1 if name.endswith("positions") else 0
            assert bool((leaf == fill).all()), name


def test_qwen110b_three_train_steps_match_reference():
    """qwen1.5-110b at ``reduced()`` keeps its bf16 params and bf16 AdamW
    moments: three steps of a global batch of 4 in microbatches of 2 from
    the same tree and batches, in f32 compute. Losses, gradient norms and
    learning rates within 1e-4 (the first step's within 1e-5: later ones
    start from bf16 params that a rounding boundary may have sent either
    way); every param and moment, stored in bf16, within 1e-4 + 1e-4 x
    |value|, at most 1 in 10^4 elements off (by one bf16 ulp)."""
    from repro.launch import steps as jsteps
    from repro.optim import adamw as jadamw
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    jcfg, cfg, tree, tp = setup("qwen110b")
    jcfg = dataclasses.replace(jcfg, compute_dtype="float32")
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    assert tp["layers"]["attn"]["wq"]["kernel"].dtype == torch.bfloat16
    jts = jsteps.TrainSettings(microbatch=2, opt=jadamw.OptConfig(
        peak_lr=1e-3, warmup_steps=1, decay_steps=4,
        state_dtype=jnp.bfloat16))
    ts = steps.TrainSettings(microbatch=2, opt=adamw.OptConfig(
        peak_lr=1e-3, warmup_steps=1, decay_steps=4))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jo = jadamw.init(jp, jts.opt)
    to = adamw.init(tp, steps.opt_config(cfg, ts))
    assert to["m"]["embed"]["embedding"].dtype == torch.bfloat16
    jstep = jax.jit(jsteps.make_train_step(jcfg, jts))
    step = steps.make_train_step(cfg, ts)
    rng = np.random.default_rng(4)
    for i in range(3):
        toks = rng.integers(0, cfg.vocab, (4, 33))
        jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
        tb = {"tokens": t_(toks[:, :-1]).long(),
              "labels": t_(toks[:, 1:]).long()}
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, m = step(tp, to, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=1e-5 if i == 0 else 1e-4,
                                       err_msg=f"step {i} {k}")
    want = dict(jmodule.tree_paths({"p": jp, "o": jo}))
    got = dict(module.tree_paths({"p": tp, "o": to}))
    assert list(got) == list(want)
    misses = total = 0
    for path, t in got.items():
        w = np.asarray(want[path], np.float64)
        g = t.double().numpy()
        assert g.shape == w.shape, path
        misses += int((np.abs(g - w) > 1e-4 + 1e-4 * np.abs(w)).sum())
        total += w.size
    assert misses <= 1e-4 * total, (misses, total)
