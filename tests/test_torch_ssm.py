"""The port's Mamba2 SSD block (``repro_torch.nn.ssm``) and the SSM family
(mamba2-130m) against the JAX reference, in f32, on seeded numpy inputs;
one reference ``init_model`` tree carried across by
``weights.lm_from_reference``. The JAX side runs jitted, with no mesh set.

Tolerances: 1e-5 (atol = rtol) for the SSD scan and the SSM block, whose
sums are a few f32 terms deep; 1e-4 for logits, as in
``test_torch_lm.py``. Greedy tokens must be equal.

Also pins a fault of the reference (ROADMAP §3): its prefill keeps
``xbc[:, -(ssm_conv - 1):]`` as the conv window, two rows for a 2-token
prompt, and its decode then fails; the port left-pads the window with
zeros, the causal conv's own padding.
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
from repro.nn import ssm as jssm
from repro.nn import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch.serve import Engine, Request
from repro_torch.nn import ssm
from repro_torch.nn import transformer as T
from repro_torch.weights import lm_from_reference
from torch_threads import one_thread  # noqa: F401  (autouse)

SSD_TOL = 1e-5
TOL = 1e-4
ARCH = "mamba2-130m"


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def t_(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def japply(mode):
    """The reference's ``model_apply`` in f32, jitted (its eager ops each
    compile on first use, which costs far more)."""
    return jax.jit(functools.partial(JT.model_apply, mode=mode,
                                     compute_dtype=jnp.float32),
                   static_argnames=("cfg",))


@pytest.fixture(scope="module")
def cfgs():
    return jget_config(ARCH).reduced(), get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def trees(cfgs):
    jcfg, cfg = cfgs
    jp = JT.init_model(jax.random.PRNGKey(1), jcfg)
    tp = lm_from_reference(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           device="cpu")
    return jp, tp


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(cfg)
    assert got == {k: want[k] for k in got}
    assert ssm.ssm_dims(cfg) == jssm.ssm_dims(jcfg)


# ---------------------------------------------------------------------------
# the SSD block
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b, s, h, p, g, n):
    r = np.random.default_rng(seed)
    x = r.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(size=(b, s, h)))).astype(np.float32)
    a = -np.exp(np.log(np.arange(1, h + 1, dtype=np.float32)) / 4)
    bm = r.normal(size=(b, s, g, n)).astype(np.float32)
    cm = r.normal(size=(b, s, g, n)).astype(np.float32)
    s0 = r.normal(size=(b, h, p, n)).astype(np.float32)
    return x, dt, a.astype(np.float32), bm, cm, s0


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_reference(chunk, init):
    """Two groups over four heads, 32 steps: y and the final state."""
    x, dt, a, bm, cm, s0 = _ssd_inputs(chunk, 2, 32, 4, 8, 2, 6)
    s0 = s0 if init else None
    jy, js = jssm.ssd_chunked(x, dt, a, bm, cm, chunk=chunk, init_state=s0)
    ty, ts = ssm.ssd_chunked(t_(x), t_(dt), t_(a), t_(bm), t_(cm),
                             chunk=chunk,
                             init_state=None if s0 is None else t_(s0))
    close(ty, jy, SSD_TOL)
    close(ts, js, SSD_TOL)


def _ssm_params(cfg, seed):
    jp = jssm.ssm_init(jax.random.PRNGKey(seed), cfg)
    # a nonzero conv bias and spread dt biases, so that no term is trivial
    r = np.random.default_rng(seed)
    jp = dict(jp, conv_b=jnp.asarray(0.1 * r.normal(size=jp["conv_b"].shape),
                                     jnp.float32),
              dt_bias=jnp.asarray(r.normal(size=jp["dt_bias"].shape),
                                  jnp.float32))
    return jp, {k: (t_(v) if not isinstance(v, dict)
                    else {kk: t_(vv) for kk, vv in v.items()})
                for k, v in jax.tree_util.tree_map(np.asarray, jp).items()}


@pytest.mark.parametrize("arch", [ARCH, "hymba-1.5b"])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssm_apply_prefill_and_decode_match_reference(arch, chunk):
    """A 13-token prefill (not a multiple of the chunk), then three decode
    steps from its state and conv window: outputs, SSM states and conv
    windows within 1e-5."""
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp, tp = _ssm_params(jcfg, chunk)
    r = np.random.default_rng(chunk + 1)
    x = r.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    jy, jst, jcv = jssm.ssm_apply(jp, x[:, :13], jcfg, chunk=chunk,
                                  compute_dtype=jnp.float32)
    ty, tst, tcv = ssm.ssm_apply(tp, t_(x[:, :13]), cfg, chunk=chunk,
                                 compute_dtype=torch.float32)
    for got, want in ((ty, jy), (tst, jst), (tcv, jcv)):
        assert got.shape == want.shape
        close(got, want, SSD_TOL)
    for t in range(13, 16):
        jy, jst, jcv = jssm.ssm_apply(jp, x[:, t:t + 1], jcfg, state=jst,
                                      conv_state=jcv, decode=True,
                                      compute_dtype=jnp.float32)
        ty, tst, tcv = ssm.ssm_apply(tp, t_(x[:, t:t + 1]), cfg, state=tst,
                                     conv_state=tcv, decode=True,
                                     compute_dtype=torch.float32)
        for got, want in ((ty, jy), (tst, jst), (tcv, jcv)):
            close(got, want, SSD_TOL)


def test_short_prompt_conv_window_is_left_padded():
    """A 2-token prefill leaves a 3-row conv window: a zero row, then the
    two inputs (the reference keeps 2 rows)."""
    cfg = get_config(ARCH).reduced()
    jcfg = jget_config(ARCH).reduced()
    jp, tp = _ssm_params(jcfg, 3)
    x = np.random.default_rng(3).normal(size=(2, 2, cfg.d_model)).astype(
        np.float32)
    _, _, jcv = jssm.ssm_apply(jp, x, jcfg, compute_dtype=jnp.float32)
    _, _, tcv = ssm.ssm_apply(tp, t_(x), cfg, compute_dtype=torch.float32)
    assert jcv.shape[1] == 2 and tcv.shape[1] == cfg.ssm_conv - 1
    assert not bool(tcv[:, 0].any())
    close(tcv[:, 1:], jcv, SSD_TOL)


# ---------------------------------------------------------------------------
# the SSM family: mamba2-130m reduced
# ---------------------------------------------------------------------------

def test_init_model_and_cache_match_reference_layout(cfgs, trees):
    """Parameter paths, shapes and dtypes (the SSM leaves' f32 ``a_log``,
    ``dt_bias``, ``d_skip``), and the stacked cache's."""
    jcfg, cfg = cfgs
    jp, _ = trees
    tp = T.init_model(torch.Generator().manual_seed(3), cfg, device="cpu")

    def paths(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from paths(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v
    for got, want in ((tp, jp),
                      (T.init_cache(cfg, 2, 24, device="cpu"),
                       JT.init_cache(jcfg, 2, 24))):
        got, want = dict(paths(got)), dict(paths(want))
        assert got.keys() == want.keys()
        for path, leaf in got.items():
            assert tuple(leaf.shape) == want[path].shape, path
            assert str(leaf.dtype).removeprefix("torch.") == \
                str(want[path].dtype), path
    a_log = tp["layers"]["ssm"]["a_log"]
    assert torch.equal(a_log[0], torch.log(torch.arange(1., 9.)))


def test_lm_from_reference_checks_ssm_shapes(cfgs, trees):
    _, cfg = cfgs
    jp, tp = trees
    tree = jax.tree_util.tree_map(np.asarray, jp)
    assert torch.equal(tp["layers"]["ssm"]["in_proj"],
                       t_(jp["layers"]["ssm"]["in_proj"]))
    with pytest.raises(ValueError, match="layers/ssm/in_proj"):
        lm_from_reference(tree, dataclasses.replace(cfg, ssm_state=8),
                          device="cpu")
    with pytest.raises(ValueError, match="layers/ssm/conv_w"):
        lm_from_reference(tree, dataclasses.replace(cfg, ssm_conv=3),
                          device="cpu")


def _serve(params, cfg, toks, s, extra, cache_len, apply):
    """Prefill ``s`` tokens, then decode ``extra`` one at a time; each
    step's last logits."""
    cache = apply["cache"](cfg, toks.shape[0], cache_len)
    logits, cache = apply["step"](params, toks[:, :s], 0, cache, "prefill")
    got = [logits]
    for t in range(s, s + extra):
        logits, cache = apply["step"](params, toks[:, t:t + 1], t, cache,
                                      "decode")
        got.append(logits)
    return np.stack(got, 1), cache


def port_serving(cfg):
    def step(params, tk, pos, cache, mode):
        logits, cache, _ = T.model_apply(
            params, {"tokens": t_(tk).long(), "cache_pos": pos}, cfg,
            mode=mode, cache=cache, compute_dtype=torch.float32)
        return logits[:, -1].numpy(), cache
    return {"cache": lambda c, b, n: T.init_cache(c, b, n,
                                                  dtype=torch.float32,
                                                  device="cpu"),
            "step": step}


def ref_serving(jcfg):
    def step(params, tk, pos, cache, mode):
        logits, cache, _ = japply(mode)(
            params, {"tokens": jnp.asarray(tk), "cache_pos": jnp.int32(pos)},
            cfg=jcfg, cache=cache)
        return np.asarray(logits[:, -1]), cache
    return {"cache": lambda c, b, n: JT.init_cache(jcfg, b, n,
                                                   dtype=jnp.float32),
            "step": step}


@pytest.mark.parametrize("s", [2, 13, 40])
def test_model_matches_reference_train_and_serve(cfgs, trees, s):
    """Train-mode logits of every position, and prefill of ``s`` tokens
    then 4 decode steps, within 1e-4 of the reference's train-mode
    forward at those positions. ``s`` = 2 is the reference's fault: its
    own prefill then decode fails, so only the port serves it; elsewhere
    the caches (SSM states, conv windows) match the reference's."""
    jcfg, cfg = cfgs
    jp, tp = trees
    toks = np.random.default_rng(s).integers(0, cfg.vocab, (2, s + 4))
    toks = toks.astype(np.int32)
    jl, _, _ = japply("train")(jp, {"tokens": jnp.asarray(toks)}, cfg=jcfg)
    tl, _, _ = T.model_apply(tp, {"tokens": t_(toks).long()}, cfg,
                             mode="train", compute_dtype=torch.float32)
    close(tl, jl)
    got, tc = _serve(tp, cfg, toks, s, 4, 48, port_serving(cfg))
    close(got, np.asarray(jl)[:, s - 1:s + 4])
    if s < cfg.ssm_conv - 1:
        with pytest.raises(Exception, match="label 'k'|broadcast"):
            _serve(jp, jcfg, toks, s, 4, 48, ref_serving(jcfg))
        return
    want, jc = _serve(jp, jcfg, toks, s, 4, 48, ref_serving(jcfg))
    close(got, want)
    for name in ("ssm", "conv"):
        close(tc[name], jc[name])


@pytest.mark.parametrize("jit", [True, False])
def test_engine_matches_reference_engine(cfgs, jit):
    """The reference engine (no mesh) and the port's on the reference
    engine's weights: three prompts (3, 6 and 30 tokens) through two
    slots, 6 new tokens each, f32; greedy tokens equal whether the port's
    engine is built with ``jit`` or not."""
    jcfg, cfg = cfgs
    prompts = [[5, 9, 2], [7, 7, 1, 30, 11, 2],
               np.random.default_rng(30).integers(0, cfg.vocab, 30).tolist()]
    je = JEngine(jcfg, slots=2, cache_len=64, seed=0,
                 compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    params = lm_from_reference(jax.tree_util.tree_map(np.asarray, je.params),
                               cfg, device="cpu")
    te = Engine(cfg, slots=2, cache_len=64, params=params,
                compute_dtype=torch.float32, cache_dtype=torch.float32,
                device="cpu", jit=jit)
    for i, p in enumerate(prompts):
        je.submit(JRequest(rid=i, prompt=p, max_new=6))
        te.submit(Request(rid=i, prompt=p, max_new=6))
    want = [r.out for r in sorted(je.run(), key=lambda r: r.rid)]
    got = [r.out for r in sorted(te.run(), key=lambda r: r.rid)]
    assert got == want and all(len(o) == 6 for o in got)


def test_two_token_prompt_serves(cfgs, trees):
    """The reference's engine raises on a 2-token SSM prompt (its conv
    window has two rows, not three); the port's serves it, and its tokens
    are the greedy continuation under the reference's train-mode
    forward."""
    jcfg, cfg = cfgs
    jp, tp = trees
    je = JEngine(jcfg, slots=1, cache_len=16, seed=1,
                 compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    je.submit(JRequest(rid=0, prompt=[5, 9], max_new=4))
    with pytest.raises(Exception, match="shape|broadcast"):
        je.run()
    te = Engine(cfg, slots=1, cache_len=16, params=tp,
                compute_dtype=torch.float32, cache_dtype=torch.float32,
                device="cpu")
    te.submit(Request(rid=0, prompt=[5, 9], max_new=4))
    got = te.run()[0].out
    seq = [5, 9]
    for _ in range(4):
        jl, _, _ = japply("train")(
            jp, {"tokens": jnp.asarray([seq], jnp.int32)}, cfg=jcfg)
        seq.append(int(jnp.argmax(jl[0, -1])))
    assert got == seq[2:]
