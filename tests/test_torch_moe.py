"""The port's MoE family (``repro_torch.nn.moe``, the MoE layer in
``nn/transformer.py``, ``configs/qwen3_moe_30b_a3b.py``,
``configs/arctic_480b.py``) against the JAX reference.

``moe_apply`` alone runs at ``reduced()`` (8 experts, top-2, capacity
factor 8: nothing dropped) and at ``reduced(n_experts=16, top_k=8,
moe_capacity_factor=1.0)`` (tokens dropped), batch 2. Its routing is
compared first and exactly: each token's top-k experts ``idx``, the (E,
C) slot table ``tok`` and its ``valid`` mask, which the reference's
``moe_apply`` computes inside (read here by wrapping its ``jnp`` and
``jax.lax.top_k`` for one eager call); the gates within 1e-6 (an f32
softmax over f32 router sums taken in another order). Then its output and
aux losses: atol = rtol = 1e-4 in f32 compute, 2e-2 in bf16 (the experts'
products rounded to bf16 on both sides, in other orders). The combine
alone, fed the same bf16 slot outputs, is bit-equal to the reference's
``.at[].add``.

The whole model runs on one reference ``init_model`` tree carried across
by ``weights.lm_from_reference``, its unit norm scales set to seeded
values first: train, prefill and decode logits and aux within 1e-4 in f32
(qwen3-moe with and without drops; arctic's ``dense_parallel`` MLP beside
the experts, its params in bf16), and the port's engine gives the
reference engine's greedy tokens. The JAX side runs jitted with no mesh
set (ROADMAP §3), where its sharding hints are the identity.
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
from repro.nn import module as jmodule
from repro.nn import moe as jmoe
from repro.nn import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch.serve import Engine, Request
from repro_torch.nn import module, moe
from repro_torch.nn import transformer as T
from repro_torch.weights import from_reference, lm_from_reference
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-4
BF16_TOL = 2e-2
GATE_TOL = 1e-6
F32 = dict(compute_dtype=torch.float32)
QWEN, ARCTIC = "qwen3-moe-30b-a3b", "arctic-480b"
DROPS = dict(n_experts=16, top_k=8, moe_capacity_factor=1.0)
# the reduced configs compared: (arch, reduced() overrides)
CASES = {"qwen3": (QWEN, {}), "qwen3_drops": (QWEN, DROPS),
         "arctic": (ARCTIC, {})}
DTYPES = {"f32": (jnp.float32, torch.float32, TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def t_(x):
    return torch.from_numpy(np.array(x))


def as_f32(x):
    """A JAX array or a tensor of any float dtype as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def configs(case):
    arch, kw = CASES[case]
    return jget_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


@functools.lru_cache(maxsize=None)
def japply(mode):
    """The reference's ``model_apply`` in f32, jitted."""
    return jax.jit(functools.partial(JT.model_apply, mode=mode,
                                     compute_dtype=jnp.float32),
                   static_argnames=("cfg",))


def nonzero_scales(tree, seed):
    """The numpy tree with every norm ``scale`` leaf drawn from 1 + N(0,
    0.1^2), seeded (the reference's init leaves them 1)."""
    r = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                (1 + 0.1 * r.normal(size=v.shape)).astype(v.dtype)
                if k == "scale" else v for k, v in node.items()}
    return walk(tree)


@functools.lru_cache(maxsize=None)
def setup(case):
    """(JAX config, port config, numpy tree with nonzero norm scales, the
    port's params from it)."""
    jcfg, cfg = configs(case)
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tree = nonzero_scales(jax.tree_util.tree_map(np.asarray, jp),
                          seed=len(case))
    return jcfg, cfg, tree, lm_from_reference(tree, cfg, device="cpu")


def leaf_paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaf_paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


class _Recorder:
    """``jnp`` for the reference's ``moe`` module, keeping what
    ``take_along_axis`` and ``where`` return."""

    def __init__(self):
        self.takes, self.wheres = [], []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def take_along_axis(self, *a, **kw):
        self.takes.append(jnp.take_along_axis(*a, **kw))
        return self.takes[-1]

    def where(self, cond, *a):
        self.wheres.append((cond, jnp.where(cond, *a)))
        return self.wheres[-1][1]


def reference_moe(p, x, cfg, compute_dtype, monkeypatch):
    """One eager call of the reference's ``moe_apply``: (y, aux, routing),
    the routing being ``idx`` (top_k's), ``tok`` (its fourth
    take_along_axis: the slot table), ``valid`` and the gates (its one
    ``where``)."""
    rec, topk = _Recorder(), []
    real_top_k = jax.lax.top_k

    def top_k(*a, **kw):
        topk.append(real_top_k(*a, **kw))
        return topk[-1]
    with monkeypatch.context() as m:
        m.setattr(jmoe, "jnp", rec)
        m.setattr(jax.lax, "top_k", top_k)
        y, aux = jmoe.moe_apply(p, x, cfg, compute_dtype=compute_dtype)
    (valid, gate), = rec.wheres
    b, e = x.shape[0], cfg.n_experts
    routing = {"idx": np.asarray(topk[0][1]),
               "tok": np.asarray(rec.takes[3]).reshape(b, e, -1),
               "valid": np.asarray(valid), "gate": np.asarray(gate)}
    return y, aux, routing


def moe_inputs(case, jdtype, tdtype):
    """Reference expert params (f32) as numpy and tensors, and one (2, 40,
    d) input in the compute dtype on both sides."""
    jcfg, cfg = configs(case)
    jp = jax.tree_util.tree_map(
        np.asarray, jmoe.moe_init(jax.random.PRNGKey(1), jcfg))
    x = np.random.default_rng(2).normal(size=(2, 40, cfg.d_model))
    xj = jnp.asarray(x, jnp.float32).astype(jdtype)
    return jcfg, cfg, jp, from_reference(jp), xj, t_(as_f32(xj)).to(tdtype)


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", [QWEN, ARCTIC])
def test_config_matches_reference(arch, reduced):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(cfg)
    assert got == {k: want[k] for k in got}
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert cfg.family == "moe" and cfg.family in T.PORTED_FAMILIES


def test_full_width_configs():
    """qwen3-moe at full width: 128 experts top-8 over moe_d_ff 768, Dh
    128 (32 heads over 4), 30.5B params, 61.1 GB in bf16 weights (122 GB
    at its f32 ``param_dtype``); a 2048-token prefill's capacity is 161
    slots an expert, a decode row's 1. Arctic: the dense MLP beside the
    experts, bf16 params."""
    q, a = get_config(QWEN), get_config(ARCTIC)
    assert (q.n_experts, q.top_k, q.moe_d_ff, q.head_dim) == (128, 8, 768,
                                                              128)
    assert (q.param_dtype, a.param_dtype) == ("float32", "bfloat16")
    assert a.dense_parallel and not q.dense_parallel
    assert moe.capacity(2048, 8, 128, q.moe_capacity_factor) == 161
    assert moe.capacity(1, 8, 128, q.moe_capacity_factor) == 1
    expert = 3 * q.n_experts * q.d_model * q.moe_d_ff
    attn = q.d_model * q.head_dim * (2 * q.n_heads + 2 * q.n_kv_heads)
    per_layer = expert + attn + q.d_model * q.n_experts
    total = q.n_layers * per_layer + 2 * q.padded_vocab * q.d_model
    assert 30.4e9 < total < 30.6e9


@pytest.mark.parametrize("args", [(2048, 8, 128, 1.25), (1, 8, 128, 1.25),
                                  (40, 2, 8, 8.0), (40, 8, 16, 1.0),
                                  (77, 8, 16, 1.0), (1, 2, 128, 1.25),
                                  (3, 8, 4, 2.0)])
def test_capacity_matches_reference(args):
    assert moe.capacity(*args) == jmoe.capacity(*args)


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_model_tree_matches_reference_layout(case):
    """The port's seeded tree has the reference's paths, shapes and dtypes
    (the router f32 in arctic's bf16 model; the dense MLP only beside
    arctic's experts) and its parameter count."""
    jcfg, cfg, tree, _ = setup(case)
    tp = T.init_model(torch.Generator().manual_seed(3), cfg, device="cpu")
    want = dict(leaf_paths(tree))
    got = dict(leaf_paths(tp))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).removeprefix("torch.") == \
            str(want[path].dtype), path
    assert got["layers/moe/router"].dtype == torch.float32
    assert ("layers/mlp/gate/kernel" in got) == cfg.dense_parallel
    assert module.param_count(tp) == jmodule.param_count(
        JT.init_model(jax.random.PRNGKey(0), jcfg))


@pytest.mark.parametrize("case", ["qwen3_drops", "arctic"])
def test_lm_from_reference_checks_the_moe_leaves(case):
    """The carry checks the MoE leaves (and arctic's MLP beside them): a
    router, expert kernel or MLP kernel that is missing or of the wrong
    shape raises naming it, and so does a router not in f32."""
    _, cfg, tree, tp = setup(case)
    assert tp["layers"]["moe"]["w_down"].shape == (
        cfg.n_layers, cfg.n_experts, cfg.moe_d_ff, cfg.d_model)
    bad = ["layers/moe/router", "layers/moe/w_gate", "layers/moe/w_up",
           "layers/moe/w_down"]
    if cfg.dense_parallel:
        bad += ["layers/mlp/gate/kernel", "layers/mlp/down/kernel"]
    for path in bad:
        *parents, key = path.split("/")
        for change in ("drop", "reshape", "transpose"):
            t = jax.tree_util.tree_map(lambda x: x, tree)
            node = t
            for p in parents:
                node = node[p]
            if change == "drop":
                del node[key]
            elif change == "reshape":
                node[key] = node[key][..., :-1]
            else:
                node[key] = np.swapaxes(node[key], -1, -2)
            with pytest.raises(ValueError, match=path):
                lm_from_reference(t, cfg, device="cpu")
    t = jax.tree_util.tree_map(lambda x: x, tree)
    t["layers"]["moe"]["router"] = t["layers"]["moe"]["router"].astype(
        jnp.bfloat16)
    with pytest.raises(ValueError, match="router is kept f32"):
        lm_from_reference(t, cfg, device="cpu")


# ---------------------------------------------------------------------------
# the MoE layer alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["qwen3", "qwen3_drops"])
def test_moe_apply_routes_as_the_reference(case, dtype, monkeypatch):
    """Routing first, exactly: each token's experts, the slot table, which
    slots hold a token (so which tokens were dropped, in the reference's
    order), and the gates within GATE_TOL; then the output and the aux
    losses within the dtype's tolerance."""
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, cfg, jp, tp, xj, xt = moe_inputs(case, jdt, tdt)
    yj, auxj, want = reference_moe(jp, xj, jcfg, jdt, monkeypatch)
    r = moe.route(tp, xt, cfg)
    np.testing.assert_array_equal(r.idx.numpy(), want["idx"])
    np.testing.assert_array_equal(r.tok.numpy(), want["tok"])
    np.testing.assert_array_equal(r.valid.numpy(), want["valid"])
    np.testing.assert_allclose(r.gate.numpy(), want["gate"], rtol=0,
                               atol=GATE_TOL)
    dropped = int(r.dropped())
    assert dropped == r.idx.numel() - int(want["valid"].sum())
    assert (dropped > 0) == (case == "qwen3_drops")

    yt, auxt = moe.moe_apply(tp, xt, cfg, compute_dtype=tdt)
    assert yt.shape == xt.shape and yt.dtype == tdt
    close(as_f32(yt), as_f32(yj), tol)
    assert auxt.keys() == auxj.keys() == {"load_balance", "router_z"}
    for k in auxj:
        close(auxt[k], auxj[k], TOL if dtype == "f32" else BF16_TOL)


@pytest.mark.parametrize("case", ["qwen3", "qwen3_drops"])
def test_combine_is_bit_equal_to_the_reference_scatter_add(case):
    """The same bf16 slot outputs (spread over 2^+-6 in scale, zero in the
    empty slots as ``moe_apply`` leaves them) combined by the port and by
    the reference's ``zeros(bf16).at[rows, tok].add(out)``, eagerly and
    jitted: bit for bit. At top-8 an f32 sum rounded once is not (the
    reason for the one-at-a-time order)."""
    _, cfg = configs(case)
    tp = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 40, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    r = moe.route(tp, x, cfg)
    b, e, c = r.tok.shape
    n, s, d = e * c, x.shape[1], cfg.d_model
    rng = np.random.default_rng(3)
    out = rng.normal(size=(b, n, d)) * np.exp2(rng.integers(-6, 7, (b, n, 1)))
    out = t_(out.astype(np.float32)).bfloat16() * r.valid.reshape(b, n, 1)
    got = moe.combine(out, r.tok, r.valid, s, cfg.top_k)

    def scatter(out, tok):
        y = jnp.zeros((b, s, d), jnp.bfloat16)
        return y.at[jnp.arange(b)[:, None], tok].add(out)
    outj = jnp.asarray(out.float().numpy()).astype(jnp.bfloat16)
    tokj = jnp.asarray(r.tok.reshape(b, n).numpy())
    for fn in (scatter, jax.jit(scatter)):
        want = as_f32(fn(outj, tokj))
        np.testing.assert_array_equal(as_f32(got), want)
    if cfg.top_k > 2:    # two slots a token round once either way
        once = torch.zeros((1, s, d)).index_add_(
            1, r.tok.reshape(b, n)[0], out[:1].float())
        assert not np.array_equal(as_f32(once.bfloat16()), want[:1])


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def close_aux(got, want, tol=TOL):
    assert got.keys() == want.keys() == {"load_balance", "router_z"}
    for k in want:
        close(got[k], want[k], tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_apply_train_mode_matches_reference(case):
    """No cache: every position's logits and the aux losses averaged over
    the layers."""
    jcfg, cfg, tree, tp = setup(case)
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 70))
    jl, _, jaux = japply("train")(
        tree, {"tokens": jnp.asarray(toks, jnp.int32)}, cfg=jcfg)
    tl, _, taux = T.model_apply(tp, {"tokens": t_(toks)}, cfg, mode="train",
                                **F32)
    assert tl.shape == (2, 70, cfg.padded_vocab)
    close(tl, jl)
    close_aux(taux, jaux)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_apply_prefill_and_decode_match_reference(case):
    """Prefill 77 tokens into a cache, then decode one token at an aligned
    position and one at per-row positions; logits, aux and the cache
    within tolerance."""
    jcfg, cfg, tree, tp = setup(case)
    toks = np.random.default_rng(77).integers(0, cfg.vocab, (2, 77))
    jc = JT.init_cache(jcfg, 2, 96, dtype=jnp.float32)
    tc = T.init_cache(cfg, 2, 96, dtype=torch.float32, device="cpu")
    steps = [("prefill", toks, 0), ("decode", toks[:, :1], 77),
             ("decode", toks[:, 1:2], np.array([78, 75], np.int32))]
    for mode, tk, pos in steps:
        jl, jc, jaux = japply(mode)(
            tree, {"tokens": jnp.asarray(tk, jnp.int32),
                   "cache_pos": jnp.asarray(pos)}, cfg=jcfg, cache=jc)
        tl, tc, taux = T.model_apply(
            tp, {"tokens": t_(tk).long(),
                 "cache_pos": pos if np.ndim(pos) == 0 else t_(pos).long()},
            cfg, mode=mode, cache=tc, **F32)
        assert tl.shape == (2, 1, cfg.padded_vocab)
        close(tl, jl)
        close_aux(taux, jaux)
    for name in ("k", "v", "positions"):
        close(tc["kv"][name], jc["kv"][name])


@pytest.mark.parametrize("case", ["qwen3", "qwen3_drops"])
def test_engine_matches_reference_engine(case):
    """The reference engine (no mesh) and the port's on one tree: two
    slots, three prompts (5, 6 and 77 tokens; the third waits for a free
    slot and, in the drops case, overflows its experts' capacity), f32;
    the greedy tokens are equal, token for token."""
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


def test_dense_families_return_no_aux():
    """Only an MoE layer has aux losses: a dense model's are empty, as the
    reference's."""
    cfg = get_config("smollm-360m").reduced()
    tp = T.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    _, _, aux = T.model_apply(tp, {"tokens": torch.zeros((1, 4),
                                                          dtype=torch.long)},
                              cfg, **F32)
    assert aux == {}


# ---------------------------------------------------------------------------
# bf16 params: the experts drawn in slabs
# ---------------------------------------------------------------------------

def test_bf16_leaves_are_drawn_in_slabs(monkeypatch):
    """A bf16 leaf larger than a slab is drawn slab by slab along its first
    axis into the leaf (an f32 leaf at once, scaled in place): each slab's
    f32 draw is at most SLAB_BYTES, the values are those of a truncated
    normal times std, rounded to bf16, and a seed gives the same bits."""
    monkeypatch.setattr(module, "SLAB_BYTES", 4 * 3 * 20 * 7)
    shapes = []
    real = module._draw

    def spy(gen, shape):
        shapes.append(tuple(shape))
        return real(gen, shape)
    monkeypatch.setattr(module, "_draw", spy)
    x = module.trunc_normal(torch.Generator().manual_seed(4), (10, 20, 7),
                            std=0.5, dtype=torch.bfloat16)
    assert x.dtype == torch.bfloat16 and x.shape == (10, 20, 7)
    assert shapes == [(3, 20, 7)] * 3 + [(1, 20, 7)]
    assert float(x.float().abs().max()) <= 1.0
    assert torch.equal(x, module.trunc_normal(
        torch.Generator().manual_seed(4), (10, 20, 7), std=0.5,
        dtype=torch.bfloat16))
    shapes.clear()
    module.trunc_normal(torch.Generator().manual_seed(4), (10, 20, 7))
    assert shapes == [(10, 20, 7)]


def test_bf16_model_runs_in_f32_and_bf16_compute():
    """qwen3-moe reduced with the serving path's bf16 weights
    (``dataclasses.replace(cfg, param_dtype="bfloat16")``): the router and
    the layer norms stay f32, every other leaf is bf16 (the QK-norm scales
    too, as in the reference), and the prefill logits in
    f32 compute equal those of the f32 model whose weights are the bf16
    ones widened."""
    cfg = dataclasses.replace(get_config(QWEN).reduced(),
                              param_dtype="bfloat16")
    tp = T.init_model(torch.Generator().manual_seed(5), cfg, device="cpu")
    paths = dict(leaf_paths(tp))
    for path, leaf in paths.items():
        f32 = path.endswith("router") or (path.endswith("scale")
                                          and "/attn/" not in path)
        assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), path
    wide = jax.tree_util.tree_map(lambda x: x.float(), tp)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab,
                                                               (1, 30)))
    outs = [T.model_apply(p, {"tokens": toks}, cfg, mode="prefill",
                          cache=T.init_cache(cfg, 1, 32, dtype=torch.float32,
                                             device="cpu"), **F32)[0]
            for p in (tp, wide)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    logits, _, aux = T.model_apply(tp, {"tokens": toks}, cfg, mode="train",
                                   compute_dtype=torch.bfloat16)
    assert bool(torch.isfinite(logits).all()) and set(aux) == {
        "load_balance", "router_z"}


# ---------------------------------------------------------------------------
# the engine's step bodies: what a CUDA graph captures
# ---------------------------------------------------------------------------

HOST_READS = ("item", "tolist", "cpu", "numpy", "nonzero", "__int__",
              "__float__", "__index__", "__bool__")


def _host_read(*_args, **_kw):
    raise AssertionError("a host read in a step body")


def test_moe_step_bodies_make_no_host_read(monkeypatch):
    """The engine's prefill (77 tokens, past the experts' capacity) and
    decode bodies of reduced qwen3-moe with drops, in bf16 as served, run
    with every way of reading a tensor on the host patched to raise:
    routing, the slot table and the combine stay on the device, so
    ``Engine(jit=True)`` captures them whole. The results equal the
    unpatched run's."""
    _, cfg = configs("qwen3_drops")
    eng = Engine(cfg, slots=2, cache_len=96, seed=0, device="cpu")
    real_route = moe.route
    tokens = torch.tensor([np.random.default_rng(1).integers(
        0, cfg.vocab, 77).tolist()])
    inputs = torch.tensor([[3, 77], [5, 100]])
    routed = []
    with monkeypatch.context() as m:
        m.setattr(moe, "route", lambda *a: routed.append(
            real_route(*a)) or routed[-1])
        want = eng._prefill_body(tokens), eng._decode_body(inputs)
    assert len(routed) == 2 * cfg.n_layers
    assert int(routed[0].dropped()) > 0
    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, _host_read)
    got = eng._prefill_body(tokens), eng._decode_body(inputs)
    monkeypatch.undo()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
