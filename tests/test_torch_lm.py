"""The port's LM stack (``repro_torch.configs``, ``nn``, ``launch.serve``)
against the JAX reference at ``get_config("smollm-360m").reduced()`` in
f32, with one reference ``init_model`` tree carried across by
``weights.lm_from_reference``. The JAX side runs with no mesh set, where
its sharding hints are the identity (under a mesh its
``with_sharding_constraint`` fails on this JAX: ROADMAP §3).

Tolerance: atol = rtol = 1e-4 on logits and activations. Both sides
compute in f32 from the same weights; they differ in the order of f32
sums (XLA's and torch's matmuls, the flash route's plain version against
the chunked softmax), a few ulp a layer. Greedy tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.launch.serve import Engine as JEngine, Request as JRequest
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn import module as jmodule
from repro.nn import transformer as JT
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as flash_kernels
from repro_torch.launch import serve
from repro_torch.launch.serve import Engine, Request
from repro_torch.nn import attention as attn
from repro_torch.nn import layers
from repro_torch.nn import module
from repro_torch.nn import transformer as T
from repro_torch.weights import lm_from_reference
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-4
ARCH = "smollm-360m"
F32 = dict(compute_dtype=torch.float32)
JF32 = dict(compute_dtype=jnp.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def t_(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def cfgs():
    return jget_config(ARCH).reduced(), get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def trees(cfgs):
    jcfg, cfg = cfgs
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tp = lm_from_reference(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           device="cpu")
    return jp, tp


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(cfg)
    assert got == {k: want[k] for k in got}
    assert cfg.padded_vocab == jcfg.padded_vocab


def test_unported_configs_and_families_raise():
    """An arch id the port has no config for raises (spikformer-v2, the
    reference's vision config, is not an LM config of the port); every
    family the reference defines is ported, and any other raises."""
    with pytest.raises(KeyError, match="names no ArchConfig"):
        get_config("spikformer-v2")
    assert set(T.PORTED_FAMILIES) == {"dense", "moe", "ssm", "hybrid",
                                      "encdec", "vlm"}
    cfg = get_config(ARCH).reduced()
    gen = torch.Generator().manual_seed(0)
    bad = dataclasses.replace(cfg, family="retnet")
    with pytest.raises(NotImplementedError, match="not ported"):
        T.init_model(gen, bad, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        T.init_cache(bad, 1, 8, device="cpu")


def test_init_model_tree_matches_reference_layout(cfgs, trees):
    """Same paths, shapes and dtypes as the reference's tree; seeded."""
    jcfg, cfg = cfgs
    jp, _ = trees
    gen = torch.Generator().manual_seed(3)
    tp = T.init_model(gen, cfg, device="cpu")
    want = dict(jmodule.tree_paths(jp))

    def paths(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from paths(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v
    got = dict(paths(tp))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).removeprefix("torch.") == \
            str(want[path].dtype), path
    assert module.param_count(tp) == jmodule.param_count(jp)
    assert module.param_bytes(tp) == jmodule.param_bytes(jp)
    again = T.init_model(torch.Generator().manual_seed(3), cfg, device="cpu")
    for path, leaf in paths(again):
        assert torch.equal(leaf, got[path]), path
    # trunc_normal's spread: std 0.02, cut at 2 standard deviations
    emb = tp["embed"]["embedding"]
    assert float(emb.abs().max()) <= 0.04 + 1e-7
    assert abs(float(emb.std()) - 0.02 * 0.8796) < 1e-3


def test_lm_from_reference_checks_shapes(cfgs, trees):
    _, cfg = cfgs
    jp, tp = trees
    tree = jax.tree_util.tree_map(np.asarray, jp)
    wq = tp["layers"]["attn"]["wq"]["kernel"]
    assert wq.device.type == "cpu" and wq.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(),
                                  np.asarray(jp["layers"]["attn"]["wq"]["kernel"]))
    with pytest.raises(ValueError, match="layers/attn/wk/kernel"):
        lm_from_reference(tree, dataclasses.replace(cfg, n_kv_heads=4),
                          device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rotary_frac", [1.0, 0.5])
def test_rope_matches_reference(rotary_frac):
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 9, 4, 32)).astype(np.float32)
    pos = (np.arange(9)[None] + np.array([[0], [5]])).astype(np.int32)
    close(layers.apply_rope(t_(x), t_(pos), theta=10000.0,
                            rotary_frac=rotary_frac),
          jlayers.apply_rope(x, pos, theta=10000.0, rotary_frac=rotary_frac))


@pytest.mark.parametrize("name", ["rmsnorm", "layernorm", "swiglu", "gelu",
                                  "linear_bias", "embed_unembed"])
def test_layers_match_reference(name):
    r = np.random.default_rng(2)
    x = r.normal(size=(2, 5, 16)).astype(np.float32)
    scale = (1 + 0.1 * r.normal(size=16)).astype(np.float32)
    bias = (0.1 * r.normal(size=16)).astype(np.float32)
    if name == "rmsnorm":
        close(layers.rmsnorm({"scale": t_(scale)}, t_(x)),
              jlayers.rmsnorm({"scale": scale}, x))
    elif name == "layernorm":
        p = {"scale": scale, "bias": bias}
        close(layers.layernorm({k: t_(v) for k, v in p.items()}, t_(x)),
              jlayers.layernorm(p, x))
    elif name == "swiglu":
        close(layers.swiglu(t_(x), t_(x[::-1])), jlayers.swiglu(x, x[::-1]))
    elif name == "gelu":
        close(layers.gelu(t_(x)), jlayers.gelu(x))
    elif name == "linear_bias":
        p = {"kernel": r.normal(size=(16, 8)).astype(np.float32),
             "bias": bias[:8]}
        close(layers.linear({k: t_(v) for k, v in p.items()}, t_(x),
                            compute_dtype=torch.float32),
              jlayers.linear(p, x, compute_dtype=jnp.float32))
    else:
        table = r.normal(size=(40, 16)).astype(np.float32)
        ids = r.integers(0, 40, (2, 5)).astype(np.int32)
        close(layers.embed({"embedding": t_(table)}, t_(ids).long()),
              jlayers.embed({"embedding": table}, ids))
        close(layers.unembed({"embedding": t_(table)}, t_(x)),
              jlayers.unembed({"embedding": table}, x))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_inputs(seed, b, hq, kvh, sq, skv, dh=32):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, hq, sq, dh)).astype(np.float32),
            r.normal(size=(b, kvh, skv, dh)).astype(np.float32),
            r.normal(size=(b, kvh, skv, dh)).astype(np.float32))


@pytest.mark.parametrize("sq,skv", [(5, 5), (77, 77), (130, 130), (40, 96)])
def test_chunked_attention_flash_route_matches_reference(sq, skv):
    """Contiguous default positions, GQA 2: the flash route against the
    reference's chunked jnp softmax (chunk 64, so 130 rows take two
    chunks), and the port's plain chunked route against it too."""
    q, k, v = _attn_inputs(sq + skv, 2, 4, 2, sq, skv)
    want = jattn.chunked_attention(q, k, v, scale=32 ** -0.5, chunk=64)
    for flash in (True, False):
        got = attn.chunked_attention(t_(q), t_(k), t_(v), scale=32 ** -0.5,
                                     chunk=64, flash=flash)
        close(got, want)


def test_chunked_attention_per_row_positions_match_reference():
    """Per-row positions with empty (-1) key slots: the plain route, one
    query (decode, grouped) and several (chunked)."""
    r = np.random.default_rng(4)
    for sq in (1, 6):
        q, k, v = _attn_inputs(sq, 2, 4, 2, sq, 24)
        qpos = (np.array([[10], [3]]) + np.arange(sq)).astype(np.int32)
        kpos = np.where(r.random((2, 24)) < 0.7, np.arange(24), -1)
        kpos[:, 0] = 0
        kpos = kpos.astype(np.int32)
        want = jattn.chunked_attention(q, k, v, scale=0.2, q_positions=qpos,
                                       k_positions=kpos, chunk=64)
        got = attn.chunked_attention(t_(q), t_(k), t_(v), scale=0.2,
                                     q_positions=t_(qpos),
                                     k_positions=t_(kpos), chunk=64)
        close(got, want)


@pytest.mark.parametrize("pos", ["scalar", "rows", "rows_past_end"])
def test_cache_update_matches_reference(pos):
    """The aligned slice and the per-row scatter (continuous batching);
    a row's writes past the cache's end are dropped, as in the reference's
    scatter."""
    r = np.random.default_rng(5)
    length = 12
    s_new = 1 if pos != "rows" else 3
    k_new = r.normal(size=(2, 2, s_new, 8)).astype(np.float32)
    v_new = r.normal(size=(2, 2, s_new, 8)).astype(np.float32)
    at = {"scalar": 4, "rows": np.array([2, 9], np.int32),
          "rows_past_end": np.array([length, 5], np.int32)}[pos]
    jc = jattn.init_kv_cache(2, 2, length, 8, dtype=jnp.float32)
    jc = jattn.cache_update(jc, k_new, v_new, at)
    tc = attn.init_kv_cache(2, 2, length, 8, dtype=torch.float32)
    tc = attn.cache_update(tc, t_(k_new), t_(v_new),
                           at if pos == "scalar" else t_(at).long())
    for name in ("k", "v", "positions"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


def test_scalar_cache_update_refuses_overflow():
    tc = attn.init_kv_cache(1, 1, 4, 8, dtype=torch.float32)
    with pytest.raises(ValueError, match="do not fit"):
        attn.cache_update(tc, torch.zeros(1, 1, 3, 8), torch.zeros(1, 1, 3, 8),
                          2)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [5, 6, 77])
def test_model_apply_prefill_and_decode_match_reference(cfgs, trees, s):
    """Prefill into a cache (the flash route), then decode one token with
    an aligned position and one with per-row positions, both against the
    reference; logits and the cache within tolerance."""
    jcfg, cfg = cfgs
    jp, tp = trees
    r = np.random.default_rng(s)
    toks = r.integers(0, cfg.vocab, (2, s)).astype(np.int32)
    jc = JT.init_cache(jcfg, 2, 96, dtype=jnp.float32)
    tc = T.init_cache(cfg, 2, 96, dtype=torch.float32, device="cpu")
    steps = [("prefill", toks, 0),
             ("decode", toks[:, :1], s),
             ("decode", toks[:, 1:2], np.array([s + 1, s - 2], np.int32))]
    for mode, tk, pos in steps:
        jl, jc, _ = JT.model_apply(
            jp, {"tokens": jnp.asarray(tk), "cache_pos": jnp.asarray(pos)},
            jcfg, mode=mode, cache=jc, **JF32)
        tl, tc, _ = T.model_apply(
            tp, {"tokens": t_(tk).long(),
                 "cache_pos": pos if np.ndim(pos) == 0 else t_(pos).long()},
            cfg, mode=mode, cache=tc, **F32)
        assert tl.shape == (2, 1, cfg.padded_vocab)
        close(tl, jl)
    for name in ("k", "v", "positions"):
        close(tc["kv"][name], jc["kv"][name])


def test_model_apply_train_mode_matches_reference(cfgs, trees):
    """No cache: every position's logits, through the flash route."""
    jcfg, cfg = cfgs
    jp, tp = trees
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 70))
    jl, _, _ = JT.model_apply(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                              jcfg, mode="train", **JF32)
    tl, _, _ = T.model_apply(tp, {"tokens": t_(toks)}, cfg, mode="train",
                             **F32)
    assert tl.shape == (2, 70, cfg.padded_vocab)
    close(tl, jl)


def test_prefill_attention_routes_through_flash(cfgs, trees, monkeypatch):
    """The routing rule: prefill (with or without a cache at position 0)
    calls ``ops.flash_attention`` once a layer, decode and prefill at an
    offset never, and ``flash=False`` never."""
    _, cfg = cfgs
    _, tp = trees
    calls = []
    real = attn.ops.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(attn.ops, "flash_attention", spy)
    toks = torch.arange(10)[None] % cfg.vocab
    cache = T.init_cache(cfg, 1, 32, dtype=torch.float32, device="cpu")
    T.model_apply(tp, {"tokens": toks, "cache_pos": 0}, cfg, mode="prefill",
                  cache=cache, **F32)
    assert calls == [(1, cfg.n_heads, 10, cfg.head_dim)] * cfg.n_layers
    T.model_apply(tp, {"tokens": toks}, cfg, mode="train", **F32)
    assert len(calls) == 2 * cfg.n_layers
    calls.clear()
    T.model_apply(tp, {"tokens": toks[:, :1], "cache_pos": 10}, cfg,
                  mode="decode", cache=cache, **F32)
    T.model_apply(tp, {"tokens": toks[:, :4], "cache_pos": 11}, cfg,
                  mode="prefill", cache=cache, **F32)
    T.model_apply(tp, {"tokens": toks, "cache_pos": 0}, cfg, mode="prefill",
                  cache=T.init_cache(cfg, 1, 32, dtype=torch.float32,
                                     device="cpu"), flash=False, **F32)
    assert calls == []


def test_bf16_prefill_reaches_flash_without_copies(cfgs, trees, monkeypatch):
    """The main path's prefill (bf16 compute over a bf16 cache) hands the
    flash wrapper the transposed q and the cache slices as views that the
    tensor-core kernel's TMA reads in place: ``_tma_ready`` returns each
    operand itself and k and v share strides, so no copy precedes the
    kernel, and KV arrives unexpanded."""
    _, cfg = cfgs
    _, tp = trees
    got = []
    real = attn.ops.flash_attention

    def spy(q, k, v, **kw):
        got.append((q, k, v))
        return real(q, k, v, **kw)
    monkeypatch.setattr(attn.ops, "flash_attention", spy)
    toks = torch.arange(10)[None] % cfg.vocab
    cache = T.init_cache(cfg, 1, 32, dtype=torch.bfloat16, device="cpu")
    T.model_apply(tp, {"tokens": toks, "cache_pos": 0}, cfg, mode="prefill",
                  cache=cache, compute_dtype=torch.bfloat16)
    assert len(got) == cfg.n_layers
    for q, k, v in got:
        assert q.dtype == k.dtype == v.dtype == torch.bfloat16
        assert k.shape == (1, cfg.n_kv_heads, 10, cfg.head_dim)
        assert not q.is_contiguous()      # the (B, S, H, Dh) transpose
        # slices of the 32-slot cache, not copies of them
        assert not k.is_contiguous() and not v.is_contiguous()
        for z in (q, k, v):
            assert flash_kernels._tma_ready(z) is z
        assert k.stride() == v.stride()


@pytest.mark.parametrize("jit", [True, False])
def test_engine_matches_reference_engine(cfgs, jit):
    """The reference engine (no mesh) and the port's, on the reference
    engine's own weights: the prompts of the reference's
    ``test_engine_matches_sequential_generation`` plus a 77-token prompt,
    two slots (the third request waits for a free one), f32; the greedy
    tokens are equal, token for token, whether the port's engine is built
    with ``jit`` or not (on the CPU ``jit`` is recorded and both run
    eagerly)."""
    jcfg, cfg = cfgs
    prompts = [[5, 9, 2, 14, 3], [7, 7, 1, 30, 11, 2],
               np.random.default_rng(77).integers(0, cfg.vocab, 77).tolist()]
    je = JEngine(jcfg, slots=2, cache_len=128, seed=0,
                 compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    params = lm_from_reference(jax.tree_util.tree_map(np.asarray, je.params),
                               cfg, device="cpu")
    te = Engine(cfg, slots=2, cache_len=128, params=params,
                compute_dtype=torch.float32, cache_dtype=torch.float32,
                device="cpu", jit=jit)
    for i, p in enumerate(prompts):
        je.submit(JRequest(rid=i, prompt=p, max_new=6))
        te.submit(Request(rid=i, prompt=p, max_new=6))
    want = [r.out for r in sorted(je.run(), key=lambda r: r.rid)]
    got = [r.out for r in sorted(te.run(), key=lambda r: r.rid)]
    assert got == want
    assert all(len(o) == 6 for o in got)
    assert len(te.decode_step_s) >= 5
    assert te.jit is jit and te.graphs == {}


def test_entry_points_default_to_the_card(cfgs, trees, monkeypatch):
    """No device given means the card; without one they fail and name the
    CPU option (no silent fallback)."""
    jcfg, cfg = cfgs
    jp, _ = trees
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    for call in (lambda: T.init_model(torch.Generator(), cfg),
                 lambda: T.init_cache(cfg, 1, 8),
                 lambda: lm_from_reference(tree, cfg),
                 lambda: Engine(cfg, slots=1, cache_len=8),
                 lambda: serve.main(["--arch", ARCH, "--reduce"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("arch", [ARCH, "hymba-1.5b", "mamba2-130m",
                                  "stablelm-12b", "glm4-9b"])
def test_serve_main_on_the_cpu(capsys, arch):
    out = serve.main(["--arch", arch, "--reduce", "--device", "cpu",
                      "--requests", "3", "--slots", "2", "--prompt-len", "8",
                      "--max-new", "4"])
    assert out["requests"] == 3 and out["total_new_tokens"] == 12
    assert out["arch"] == f"{arch}-reduced"
    assert out["device"] == "cpu" and out["decode_steps"] >= 3
    assert '"requests": 3' in capsys.readouterr().out
