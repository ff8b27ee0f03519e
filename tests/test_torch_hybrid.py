"""The port's hybrid family (hymba-1.5b: attention with sliding windows,
ring caches and global layers beside a Mamba2 SSD mixer in every layer)
against the JAX reference, at ``reduced(n_layers=3)`` (window 32, global
layer 0, two windowed layers) in f32, one reference ``init_model`` tree
carried across by ``weights.lm_from_reference``. The JAX side runs
jitted, with no mesh set. (The engine's step bodies over these caches are
pinned in ``test_torch_lm_graph.py``.)

Tolerances: ring cache writes bit for bit (positions and k/v alike: they
are copies); attention within 1e-5; logits and caches within 1e-4, as in
``test_torch_lm.py``. Greedy tokens must be equal.

Also pins a fault of the reference (ROADMAP §3): a prompt longer than the
window, prefilled into a ring cache, attends over the ring it has just
truncated (``repro/nn/attention.py:264-268``, ``:357-363``), so its query
rows before the last ``window`` positions lose keys. The port attends over
the prompt's own keys, as the reference's train-mode forward does.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.launch.serve import Engine as JEngine, Request as JRequest
from repro.nn import attention as jattn
from repro.nn import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch.serve import Engine, Request
from repro_torch.nn import attention as attn
from repro_torch.nn import transformer as T
from repro_torch.weights import lm_from_reference
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-4
ATTN_TOL = 1e-5
ARCH = "hymba-1.5b"
LAYERS = 3


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def t_(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def japply(mode):
    """The reference's ``model_apply`` in f32, jitted."""
    return jax.jit(functools.partial(JT.model_apply, mode=mode,
                                     compute_dtype=jnp.float32),
                   static_argnames=("cfg",))


@pytest.fixture(scope="module")
def cfgs():
    return (jget_config(ARCH).reduced(n_layers=LAYERS),
            get_config(ARCH).reduced(n_layers=LAYERS))


@pytest.fixture(scope="module")
def trees(cfgs):
    jcfg, cfg = cfgs
    jp = JT.init_model(jax.random.PRNGKey(1), jcfg)
    tp = lm_from_reference(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           device="cpu")
    return jp, tp


def _paths(tree, prefix=""):
    if isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}/")
        return
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(cfg)
    assert got == {k: want[k] for k in got}


def test_init_model_and_cache_match_reference_layout(cfgs, trees):
    """Parameter paths, shapes and dtypes, and the per-layer cache list:
    the global layer's KV as long as the cache, the windowed layers' rings
    of ``min(window, length)``, f32 SSM state and conv window in each."""
    jcfg, cfg = cfgs
    jp, _ = trees
    tp = T.init_model(torch.Generator().manual_seed(3), cfg, device="cpu")
    for length in (24, 64):
        tc = T.init_cache(cfg, 2, length, device="cpu")
        assert isinstance(tc, list) and len(tc) == LAYERS
        assert [c["kv"]["k"].shape[2] for c in tc] == \
            [length] + [min(32, length)] * 2
        for got, want in ((tp, jp), (tc, JT.init_cache(jcfg, 2, length))):
            got, want = dict(_paths(got)), dict(_paths(want))
            assert got.keys() == want.keys()
            for path, leaf in got.items():
                assert tuple(leaf.shape) == want[path].shape, path
                assert str(leaf.dtype).removeprefix("torch.") == \
                    str(want[path].dtype), path


def test_lm_from_reference_checks_hybrid_shapes(cfgs, trees):
    _, cfg = cfgs
    jp, _ = trees
    tree = jax.tree_util.tree_map(np.asarray, jp)
    for bad, path in ((dict(n_heads=5), "layers/attn/wq/kernel"),
                      (dict(ssm_head_dim=16), "layers/ssm/in_proj")):
        with pytest.raises(ValueError, match=path):
            lm_from_reference(tree, dataclasses.replace(cfg, **bad),
                              device="cpu")


# ---------------------------------------------------------------------------
# ring caches and windowed attention
# ---------------------------------------------------------------------------

RING_CASES = {
    # name: (position after a 6-token write at 0, tokens of the write)
    "scalar": (6, 1),
    "scalar_wrap": (8, 1),
    "scalar_run": (6, 3),
    "scalar_run_wraps": (6, 5),
    "rows": (np.array([6, 13]), 1),
    "rows_run": (np.array([6, 11]), 3),
    "longer_than_ring": (0, 11),
    "longer_than_ring_at_offset": (6, 19),
}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_cache_update_matches_reference(case):
    """An 8-slot ring after a 6-token write at 0, then the case's write:
    scalar and per-row positions, a wrap, and writes longer than the ring
    (their last 8 tokens kept from ``pos + (S - 8)``). Every leaf equal to
    the reference's, bit for bit."""
    at, s_new = RING_CASES[case]
    r = np.random.default_rng(len(case))
    first = [r.normal(size=(2, 2, 6, 4)).astype(np.float32) for _ in "kv"]
    new = [r.normal(size=(2, 2, s_new, 4)).astype(np.float32) for _ in "kv"]
    jc = jattn.init_kv_cache(2, 2, 8, 4, dtype=jnp.float32)
    tc = attn.init_kv_cache(2, 2, 8, 4, dtype=torch.float32)
    jc = jattn.cache_update(jc, *first, 0, ring=True)
    tc = attn.cache_update(tc, *map(t_, first), 0, ring=True)
    jc = jattn.cache_update(jc, *new, jnp.asarray(at, jnp.int32), ring=True)
    tc = attn.cache_update(tc, *map(t_, new),
                           at if np.ndim(at) == 0 else t_(at).long(),
                           ring=True)
    for name in ("k", "v", "positions"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


def _attn_inputs(seed, sq, skv, dh=8):
    r = np.random.default_rng(seed)
    return (r.normal(size=(2, 4, sq, dh)).astype(np.float32),
            r.normal(size=(2, 2, skv, dh)).astype(np.float32),
            r.normal(size=(2, 2, skv, dh)).astype(np.float32))


@pytest.mark.parametrize("is_global", [False, True])
@pytest.mark.parametrize("sq", [1, 6])
def test_windowed_attention_with_positions_matches_reference(is_global, sq):
    """Per-row positions over a ring's slots (some empty), window 5: the
    grouped decode (one query) and the chunked softmax (six), a windowed
    and a global layer."""
    q, k, v = _attn_inputs(sq + 10 * is_global, sq, 12)
    qpos = (np.array([[20], [9]]) + np.arange(sq)).astype(np.int32)
    kpos = np.stack([np.arange(14, 26) % 12 + 12, np.arange(12)])
    kpos[1, 10:] = -1
    kpos = kpos.astype(np.int32)
    want = jattn.chunked_attention(q, k, v, scale=0.3, q_positions=qpos,
                                   k_positions=kpos, window=5,
                                   is_global=jnp.bool_(is_global), chunk=4)
    got = attn.chunked_attention(t_(q), t_(k), t_(v), scale=0.3,
                                 q_positions=t_(qpos), k_positions=t_(kpos),
                                 window=5, is_global=is_global, chunk=4)
    close(got, want, ATTN_TOL)


@pytest.mark.parametrize("window,is_global,flash_calls", [
    (40, False, 1), (16, False, 0), (16, True, 1)])
def test_windowed_default_positions_route(monkeypatch, window, is_global,
                                          flash_calls):
    """Contiguous positions over 40 keys: the flash route where no key
    lies past the window (or the layer is global), else the plain
    windowed softmax; both equal the reference's."""
    calls = []
    real = attn.ops.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(attn.ops, "flash_attention", spy)
    q, k, v = _attn_inputs(window, 40, 40)
    want = jattn.chunked_attention(q, k, v, scale=0.3, window=window,
                                   is_global=jnp.bool_(is_global), chunk=16)
    got = attn.chunked_attention(t_(q), t_(k), t_(v), scale=0.3,
                                 window=window, is_global=is_global, chunk=16)
    close(got, want, ATTN_TOL)
    assert len(calls) == flash_calls


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _serve(step, params, toks, s, extra, cache):
    logits, cache = step(params, toks[:, :s], 0, cache, "prefill")
    got = [logits]
    for t in range(s, s + extra):
        logits, cache = step(params, toks[:, t:t + 1], t, cache, "decode")
        got.append(logits)
    return np.stack(got, 1), cache


def port_step(cfg):
    def step(params, tk, pos, cache, mode):
        logits, cache, _ = T.model_apply(
            params, {"tokens": t_(tk).long(), "cache_pos": pos}, cfg,
            mode=mode, cache=cache, compute_dtype=torch.float32)
        return logits[:, -1].numpy(), cache
    return step


def ref_step(jcfg):
    def step(params, tk, pos, cache, mode):
        logits, cache, _ = japply(mode)(
            params, {"tokens": jnp.asarray(tk), "cache_pos": jnp.int32(pos)},
            cfg=jcfg, cache=cache)
        return np.asarray(logits[:, -1]), cache
    return step


def test_train_mode_logits_match_reference(cfgs, trees):
    """Every position's logits over 72 tokens, past the window twice."""
    jcfg, cfg = cfgs
    jp, tp = trees
    toks = np.random.default_rng(72).integers(0, cfg.vocab, (2, 72))
    jl, _, _ = japply("train")(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                               cfg=jcfg)
    tl, _, _ = T.model_apply(tp, {"tokens": t_(toks)}, cfg, mode="train",
                             compute_dtype=torch.float32)
    assert tl.shape == (2, 72, cfg.padded_vocab)
    close(tl, jl)


def test_prefill_and_decode_wrap_the_rings_like_the_reference(cfgs, trees):
    """A 24-token prompt, then 12 decode steps to position 35: the rings
    (32 slots) wrap. Logits within 1e-4 of the reference's serving and of
    its train-mode forward; every cache leaf within 1e-4 (positions
    exactly)."""
    jcfg, cfg = cfgs
    jp, tp = trees
    toks = np.random.default_rng(24).integers(0, cfg.vocab, (2, 36))
    toks = toks.astype(np.int32)
    got, tc = _serve(port_step(cfg), tp, toks, 24, 12,
                     T.init_cache(cfg, 2, 128, dtype=torch.float32,
                                  device="cpu"))
    want, jc = _serve(ref_step(jcfg), jp, toks, 24, 12,
                      JT.init_cache(jcfg, 2, 128, dtype=jnp.float32))
    close(got, want)
    jl, _, _ = japply("train")(jp, {"tokens": jnp.asarray(toks)}, cfg=jcfg)
    close(got[:, :-1], np.asarray(jl)[:, 23:35])
    got_leaves, want_leaves = dict(_paths(tc)), dict(_paths(jc))
    assert got_leaves.keys() == want_leaves.keys()
    for path, leaf in got_leaves.items():
        if path.endswith("positions"):
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(want_leaves[path]))
        else:
            close(leaf, want_leaves[path])
    assert int(tc[1]["kv"]["positions"].max()) == 35


def test_prompt_past_the_window_matches_train_mode(cfgs, trees):
    """The reference's fault: a 40-token prompt (window 32) into a
    128-token cache. The port's prefill and 4 decode steps agree with the
    reference's train-mode forward within 1e-4; the reference's own
    prefill misses it by more than 0.1."""
    jcfg, cfg = cfgs
    jp, tp = trees
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (2, 44), 0,
                                         jcfg.vocab))
    jl, _, _ = japply("train")(jp, {"tokens": jnp.asarray(toks)}, cfg=jcfg)
    want = np.asarray(jl)[:, 39:44]
    got, _ = _serve(port_step(cfg), tp, toks, 40, 4,
                    T.init_cache(cfg, 2, 128, dtype=torch.float32,
                                 device="cpu"))
    close(got, want)
    ref, _ = _serve(ref_step(jcfg), jp, toks, 40, 0,
                    JT.init_cache(jcfg, 2, 128, dtype=jnp.float32))
    assert float(np.abs(ref[:, 0] - want[:, 0]).max()) > 0.1


def test_prefill_attention_routes(cfgs, trees, monkeypatch):
    """A prompt within the window runs the flash kernel in every layer; a
    longer one only in the global layer (the windowed layers take the
    plain windowed softmax); decode never."""
    _, cfg = cfgs
    _, tp = trees
    calls = []
    real = attn.ops.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape[2])
        return real(*a, **kw)
    monkeypatch.setattr(attn.ops, "flash_attention", spy)
    cache = T.init_cache(cfg, 1, 64, dtype=torch.float32, device="cpu")
    for s, want in ((32, [32] * LAYERS), (40, [40])):
        calls.clear()
        T.model_apply(tp, {"tokens": torch.arange(s)[None], "cache_pos": 0},
                      cfg, mode="prefill", cache=cache,
                      compute_dtype=torch.float32)
        assert calls == want
    calls.clear()
    T.model_apply(tp, {"tokens": torch.tensor([[3]]), "cache_pos": 40}, cfg,
                  mode="decode", cache=cache, compute_dtype=torch.float32)
    assert calls == []


@pytest.mark.parametrize("jit", [True, False])
def test_engine_matches_reference_engine(cfgs, jit):
    """The reference engine (no mesh) and the port's on the reference
    engine's weights: prompts of 5, 30 and 32 tokens (within the window)
    through two slots and a 64-token cache, 8 new tokens each, so decode
    wraps the 32-slot rings; f32, greedy tokens equal with ``jit`` or
    not."""
    jcfg, cfg = cfgs
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (5, 30, 32)]
    je = JEngine(jcfg, slots=2, cache_len=64, seed=0,
                 compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    params = lm_from_reference(jax.tree_util.tree_map(np.asarray, je.params),
                               cfg, device="cpu")
    te = Engine(cfg, slots=2, cache_len=64, params=params,
                compute_dtype=torch.float32, cache_dtype=torch.float32,
                device="cpu", jit=jit)
    for i, p in enumerate(prompts):
        je.submit(JRequest(rid=i, prompt=p, max_new=8))
        te.submit(Request(rid=i, prompt=p, max_new=8))
    want = [r.out for r in sorted(je.run(), key=lambda r: r.rid)]
    got = [r.out for r in sorted(te.run(), key=lambda r: r.rid)]
    assert got == want and all(len(o) == 8 for o in got)
