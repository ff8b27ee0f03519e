"""The reference's default ``packed`` backend in the port, on the CPU: its
CPU branch held to the JAX package's ``PackedBackend(pallas=False)``.

- the occupancy readouts (``spike_occupancy``, ``chunk_occupancy``,
  ``value_chunk_occupancy``) give the reference's floats, bit for bit;
- ``sparse_budget``, ``choose_route`` and ``_resolve_route`` decide as the
  reference does over a grid of shapes, occupancies and constants;
- ``lut_matmul_sparse`` equals the reference's bit for bit, f32 and int16
  tables, on the sparse and the dense-fallback branch;
- the STDP score-LUT route equals the reference's bit for bit;
- ``calibrate_layer_occupancy`` gives the reference's mapping;
- ``forward_folded`` over ``packed``, routes chosen ("auto", with and
  without a calibration) or pinned ("lut_sparse" everywhere, "unpack"):
  packed spikes at every layer and labels bit-identical, logits within
  1e-5 (the head dot's order differs between XLA and torch, as
  ``tests/test_parity.py`` allows);
- ``SpikformerEngine``'s labels equal the reference's;
- the ``--firing-rates`` fit of ``compact_cost`` equals the reference
  script's from the same samples.

End-to-end cases feed both packages one reference tree whose kernels carry
fixed gains, so that the IAND residual stream still fires at the head.
"""
import itertools
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spikformer import SpikformerConfig as JConfig
from repro.core.spikformer import fold_inference_params as jfold
from repro.core.spikformer import init as jinit
from repro.infer import ExecutionPlan as JPlan
from repro.infer import backends as jbackends
from repro.infer import calibrate_layer_occupancy as jcalibrate
from repro.infer import compile as jcompile
from repro.infer.compile import lower as jlower
from repro.infer.quant import map_folded_layers as jmap_layers
from repro.infer.quant import quantize_folded as jquantize
from repro.kernels import lut_matmul as jlut
from repro.kernels import ops as jops
from repro.launch.serve_spikformer import SpikformerEngine as JEngine
from repro_torch.core.spike import pack_timesteps, structured_spikes
from repro_torch.core.spikformer import SpikformerConfig
from repro_torch.infer import ExecutionPlan, backends, compile
from repro_torch.infer import calibrate_layer_occupancy
from repro_torch.infer.compile import lower
from repro_torch.kernels import lut_matmul as lut
from repro_torch.kernels import ops
from repro_torch.launch import autotune_routes as tune
from repro_torch.launch.serve_spikformer import SpikformerEngine
from repro_torch.weights import from_reference

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "scripts"))
import autotune_routes as jtune  # noqa: E402  (the reference script)

GAIN, GAIN_RESIDUAL = 4.0, 0.7        # kernel gains; wo/fc2 get both
LOGITS_ATOL = LOGITS_RTOL = 1e-5      # tests/test_parity.py:115-117


def exact(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def t_(x):
    return torch.from_numpy(np.array(x))


def packed_spikes(seed, t, *shape, rate=0.3):
    """(G, *shape) uint8 plane groups of t-step iid spikes (dead bits 0),
    as numpy."""
    s = (np.random.default_rng(seed).random((t, *shape)) < rate)
    return pack_timesteps(torch.from_numpy(s)).numpy()


# ---------------------------------------------------------------------------
# occupancy readouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,k", [(1, 16), (4, 13), (9, 24), (17, 7)])
def test_occupancy_readouts_equal_reference(t, k):
    x = packed_spikes(t, t, 3, 5, k, rate=0.15)
    assert backends.spike_occupancy(t_(x), t) == \
        jbackends.spike_occupancy(jnp.asarray(x), t)
    got = backends.chunk_occupancy(t_(x), t)
    assert isinstance(got, float)
    assert got == jbackends.chunk_occupancy(jnp.asarray(x), t)
    img = np.random.default_rng(k).integers(0, 256, (2, 4, 4, k),
                                            dtype=np.uint8)
    img[0, :2] = 0                                  # some all-zero chunks
    assert backends.value_chunk_occupancy(t_(img)) == \
        jbackends.value_chunk_occupancy(jnp.asarray(img))


# ---------------------------------------------------------------------------
# the CPU branch's route decisions
# ---------------------------------------------------------------------------

SHAPES = [(64, 32, 16, 1, 8), (1568, 512, 512, 1, 4), (392, 1024, 512, 1, 4),
          (1568, 512, 2048, 1, 4), (1568, 2048, 512, 1, 4),
          (100352, 12, 64, 1, 8), (256, 40, 24, 2, 9), (32, 7, 5, 3, 17)]
OCCUPANCIES = [None, 0.0, 0.03, 0.1, 0.25, 0.6, 1.0]
CONSTANTS = {
    "default": {},
    "fitted": dict(gather_cost=1.5, transpose_cost=0.7, unpack_cost=30.0,
                   cache_penalty=6.0, compact_cost=3.0),
    "cheap_compact": dict(compact_cost=0.05, cache_bytes=1 << 16),
}


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_sparse_budget_and_choose_route_equal_reference(name):
    cc = lut.RouteConstants(**CONSTANTS[name])
    jcc = jlut.RouteConstants(**CONSTANTS[name])
    for c in (1, 2, 5, 64, 256):
        for occ in OCCUPANCIES[1:]:
            assert lut.sparse_budget(c, occ) == jlut.sparse_budget(c, occ)
    seen = set()
    for (m, k, n, g, t), occ, is_int, cap in itertools.product(
            SHAPES, OCCUPANCIES, (False, True), (lut.MAX_TABLE_BYTES, 1 << 20)):
        kw = dict(m=m, k=k, n=n, g=g, t=t, weights_are_int=is_int,
                  max_table_bytes=cap, occupancy=occ)
        got = lut.choose_route(constants=cc, **kw)
        assert got == jlut.choose_route(constants=jcc, **kw), kw
        seen.add(got)
    assert seen == {"lut", "lut_sparse", "unpack"}
    with pytest.raises(ValueError, match="occupancy"):
        lut.sparse_budget(4, 1.5)


@pytest.mark.parametrize("route", [None, "auto", "lut", "lut_sparse",
                                   "unpack", "dense"])
def test_resolve_route_equals_reference(route):
    """Every (table, occupancy, constants) combination resolves as the
    reference's ``_resolve_route``, or both raise."""
    w = np.random.default_rng(0).normal(size=(40, 24)).astype(np.float32)
    tables = {"none": (None, None),
              "table": (lut.build_lut(t_(w)), jlut.build_lut(jnp.asarray(w)))}
    for (tname, (tbl, jtbl)), occ, (m, k, n, g, t), cname in \
            itertools.product(tables.items(), (None, 0.05, 0.4), SHAPES[:4],
                              sorted(CONSTANTS)):
        kw = dict(m=m, k=k, n=n, g=g, t=t, weights_are_int=False,
                  occupancy=occ)
        try:
            want = jops._resolve_route(
                route, jtbl, constants=jlut.RouteConstants(
                    **CONSTANTS[cname]), **kw)
        except ValueError:
            with pytest.raises(ValueError):
                ops._resolve_route(route, tbl, constants=lut.RouteConstants(
                    **CONSTANTS[cname]), **kw)
            continue
        assert ops._resolve_route(route, tbl, constants=lut.RouteConstants(
            **CONSTANTS[cname]), **kw) == want, (tname, occ, cname)


# ---------------------------------------------------------------------------
# the zero-chunk-skipping gather and the STDP score LUT
# ---------------------------------------------------------------------------

def sparse_index_bytes(seed, rows, c, live):
    """(2, rows, c) uint8 index bytes with at most ``live`` nonzero chunks a
    row (random positions), and one row at ``live + 2`` when asked."""
    r = np.random.default_rng(seed)
    idx = np.zeros((2, rows, c), np.uint8)
    for p in range(2):
        for m in range(rows):
            pos = r.choice(c, size=r.integers(0, live + 1), replace=False)
            idx[p, m, pos] = r.integers(1, 256, len(pos))
    return idx


@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("branch", ["sparse", "fallback"])
def test_lut_matmul_sparse_bit_exact(dtype, branch):
    c, live, budget = 11, 3, 4
    idx = sparse_index_bytes(len(dtype) + len(branch), 33, c, live)
    if branch == "fallback":
        idx[1, 5, :budget + 2] = 7          # one row past the budget
    r = np.random.default_rng(3)
    w = (r.integers(-127, 128, (8 * c - 3, 20)).astype(np.int8)
         if dtype == "int16" else r.normal(size=(8 * c - 3, 20)).astype(
             np.float32))
    tbl, jtbl = lut.build_lut(t_(w)), jlut.build_lut(jnp.asarray(w))
    exact(tbl, jtbl)
    got = lut.lut_matmul_sparse(t_(idx), tbl, max_chunks=budget)
    want = jlut.lut_matmul_sparse(jnp.asarray(idx), jtbl, max_chunks=budget)
    assert got.dtype == torch.float32
    exact(got, want)
    exact(got, lut.lut_matmul(t_(idx), tbl))     # skipping is exact


@pytest.mark.parametrize("t,n", [(4, 130), (9, 128), (2, 40)])
def test_stdp_score_lut_route_bit_exact(t, n):
    """The CPU branch's score LUT ("lut", and "auto" from 128 tokens) equals
    the reference's and the plain unpack route, bit for bit."""
    b, h, dh = 2, 2, 12
    q, k, v = (packed_spikes(10 * t + i, t, b, h, n, dh) for i in range(3))
    for route in ("lut", "auto", "unpack"):
        got = ops.stdp_attention_packed(t_(q), t_(k), t_(v), t=t,
                                        scale=0.125, route=route,
                                        cpu_branch=True)
        want = jops.stdp_attention_packed(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), t=t, scale=0.125,
            pallas=False, route=route)
        exact(got, want, route)
    exact(got, ops.stdp_attention_packed(t_(q), t_(k), t_(v), t=t,
                                         scale=0.125, plain=True))
    with pytest.raises(ValueError, match="route"):
        ops.stdp_attention_packed(t_(q), t_(k), t_(v), t=t, scale=0.125,
                                  route="dense", cpu_branch=True)


def test_structured_spikes_hold_their_chunk_occupancy_contract():
    """``structured_spikes`` draws from a torch generator, so it is held to
    its docstring's contract, not to JAX's bits: the exact active-group
    count, silent inactive groups, dead bits zero, the overall firing rate
    near ``rate`` and the chunk occupancy tracking it ~1:1."""
    t, m, k = 8, 512, 256
    for rate in (0.05, 0.1, 0.2, 0.3):
        x = structured_spikes(torch.Generator().manual_seed(int(rate * 100)),
                              t=t, shape=(m, k), rate=rate)
        assert x.shape == (1, m, k) and x.dtype == torch.uint8
        groups = k // 8
        n_active = max(1, round(rate / 0.9 * groups))
        live = (x != 0).reshape(m, groups, 8).any(dim=(0, 2))
        assert int(live.sum()) == n_active
        fired = backends.spike_occupancy(x, t)
        assert abs(fired - rate) < 0.02, (rate, fired)
        occ = backends.chunk_occupancy(x, t)
        assert occ <= n_active / groups and occ > 0.8 * rate / 0.9
    x = structured_spikes(torch.Generator().manual_seed(0), t=9,
                          shape=(4, 16), rate=0.3)
    assert x.shape == (2, 4, 16) and not (x[1] & 0xFE).any()
    assert not structured_spikes(torch.Generator(), t=4, shape=(2, 8),
                                 rate=0.0).any()
    with pytest.raises(ValueError):
        structured_spikes(torch.Generator(), t=4, shape=(2, 12), rate=0.1)


# ---------------------------------------------------------------------------
# end to end: calibration and forward_folded over ``packed`` on the CPU
# ---------------------------------------------------------------------------

def firing_tree(jcfg, dtype):
    """The reference's folded tree with the gains that keep the residual
    stream firing, int8-quantized for ``dtype="int8"``."""
    def gain(path, layer):
        g = GAIN * (GAIN_RESIDUAL if path.endswith(("/wo", "/fc2")) else 1.0)
        return {**layer, "kernel": layer["kernel"] * g}

    tree = jmap_layers(jfold(jinit(jax.random.PRNGKey(0), jcfg), jcfg), gain)
    return jquantize(tree) if dtype == "int8" else tree


class Recorder:
    """Wraps a backend; records every layer's packed output (numpy) and the
    rates, in forward order."""

    def __init__(self, inner):
        self.inner, self.rows = inner, []

    def _rec(self, name, out):
        self.rows.append((name, np.asarray(out)))
        return out

    def sssc_lif(self, *a, **kw):
        return self._rec("sssc", self.inner.sssc_lif(*a, **kw))

    def zsc_lif(self, *a, **kw):
        return self._rec("zsc", self.inner.zsc_lif(*a, **kw))

    def wssl_lif(self, *a, **kw):
        return self._rec("wssl", self.inner.wssl_lif(*a, **kw))

    def stdp_lif(self, *a, **kw):
        return self._rec("stdp", self.inner.stdp_lif(*a, **kw))

    def residual(self, *a, **kw):
        return self._rec("residual", self.inner.residual(*a, **kw))

    def to_tokens(self, x):
        return self.inner.to_tokens(x)

    def rate(self, x, *, t):
        return self._rec("rate", self.inner.rate(x, t=t))


@pytest.fixture(scope="module")
def trees():
    """Per weight dtype: the reduced configs, the reference's gained tree,
    the port's copy of it, calibration images and both packages'
    calibrated occupancy."""
    out = {}
    jcfg, cfg = JConfig().scaled(), SpikformerConfig().scaled()
    imgs = np.random.default_rng(5).integers(0, 256, (4, 32, 32, 3),
                                             dtype=np.uint8)
    for dtype in ("float32", "int8"):
        jtree = firing_tree(jcfg, dtype)
        tree = from_reference(jax.tree_util.tree_map(np.asarray, jtree))
        jocc = jcalibrate(jtree, jcfg, jnp.asarray(imgs), folded=True)
        occ = calibrate_layer_occupancy(tree, cfg, imgs, folded=True,
                                        device="cpu")
        out[dtype] = (jcfg, cfg, jtree, tree, imgs, jocc, occ)
    return out


@pytest.fixture(scope="module")
def jmodels(trees):
    """``(dtype, plan fields) -> the reference's compiled model`` of
    ``trees[dtype]``, compiled once for the whole module (the reference's
    table builds dominate these cases)."""
    built = {}

    def get(dtype, **fields):
        key = (dtype, json.dumps(fields, sort_keys=True))
        if key not in built:
            jcfg, _, jtree, *_ = trees[dtype]
            built[key] = jcompile(jtree, jcfg, JPlan(**fields), folded=True)
        return built[key]
    return get


def calibrated_fields(jocc) -> dict:
    """The plan fields of the calibrated f32 case (the reference's default
    plan with the calibration, bucket 4)."""
    return dict(backend="packed", weight_dtype="float32", batch_buckets=(4,),
                route="auto", layer_occupancy=jocc)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_calibrate_layer_occupancy_equals_reference(trees, dtype):
    *_, jocc, occ = trees[dtype]
    assert list(occ) == list(jocc)
    assert occ == jocc
    assert all(isinstance(v, float) and 0 <= v <= 1 for v in occ.values())
    assert min(occ.values()) < max(occ.values())


# (name, weight dtype, plan fields beyond backend="packed", buckets (4,))
FORWARD_CASES = [
    ("f32-auto", "float32", {}),
    ("int8-auto", "int8", {}),
    ("f32-auto-calibrated", "float32", {"calibrated": True}),
    ("f32-lut_sparse", "float32", {"pin": "lut_sparse"}),
    ("int8-lut_sparse", "int8", {"pin": "lut_sparse"}),
    ("int8-unpack", "int8", {"route": "unpack"}),
]


@pytest.mark.parametrize("name,dtype,how", FORWARD_CASES,
                         ids=[c[0] for c in FORWARD_CASES])
def test_forward_folded_over_packed_matches_reference(trees, jmodels, name,
                                                      dtype, how):
    jcfg, cfg, jtree, tree, imgs, jocc, occ = trees[dtype]
    fields = dict(backend="packed", weight_dtype=dtype, batch_buckets=(4,),
                  route=how.get("route", "auto"))
    if how.get("calibrated") or how.get("pin"):
        fields["layer_occupancy"] = jocc
    if how.get("pin"):
        fields["routes"] = {p: how["pin"] for p in jocc}
    jmodel = jmodels(dtype, **fields)
    model = compile(tree, cfg, ExecutionPlan(**fields), folded=True,
                    device="cpu")
    assert model.backend.name == "packed" and model.backend.pallas is False
    assert model.plan.routes == jmodel.plan.routes
    if how.get("pin"):
        assert set(model.plan.routes.values()) == {"lut_sparse"}

    jrec, rec = Recorder(jmodel.backend), Recorder(model.backend)
    joccs = {p: jocc[p] for p, r in jmodel.plan.routes.items()
             if r == "lut_sparse"} or None
    jlogits = jlower(jmodel.folded, jcfg, jrec, jit=False,
                     layer_occupancy=joccs)(jmodel.folded, jnp.asarray(imgs))
    logits = lower(model.folded, cfg, rec, jit=False,
                   layer_occupancy=joccs)(model.folded, torch.from_numpy(imgs))
    assert [n for n, _ in rec.rows] == [n for n, _ in jrec.rows]
    for i, ((n, got), (_, want)) in enumerate(zip(rec.rows, jrec.rows)):
        exact(got, want, f"layer {i} ({n})")
    assert rec.rows[-2][1].any(), "the residual stream is silent"
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGITS_ATOL, rtol=LOGITS_RTOL)
    served = model.classify(imgs).numpy()
    exact(served, np.asarray(jlogits).argmax(-1))
    assert len(set(served.tolist())) > 1, "every label is one class"


def test_calibrated_plan_routes_some_layers_sparse(trees, jmodels):
    """With the calibration, ``choose_route`` sends some layers of the
    reduced config to the sparse gather (so the auto-calibrated case above
    runs it), exactly as the reference plans."""
    jcfg, cfg, jtree, tree, imgs, jocc, occ = trees["float32"]
    plan = ExecutionPlan(backend="packed", batch_buckets=(4,),
                         layer_occupancy=occ)
    model = compile(tree, cfg, plan, folded=True, device="cpu")
    jmodel = jmodels("float32", **calibrated_fields(jocc))
    assert model.plan.routes == jmodel.plan.routes
    assert "lut_sparse" in model.plan.routes.values()


def gained_params(params):
    """Training params with the folded gains applied to the kernels (the BN
    fold scales a kernel and leaves the bias alone, so this gains the
    folded tree the same way)."""
    out = jax.tree_util.tree_map(lambda a: a, params)
    for conv in out["scs"].values():
        conv["kernel"] = conv["kernel"] * GAIN
    for blk in out["blocks"].values():
        for grp in (blk["ssa"], blk["mlp"]):
            for name in ("wq", "wk", "wv", "wo", "fc1", "fc2"):
                if name in grp:
                    g = GAIN * (GAIN_RESIDUAL if name in ("wo", "fc2")
                                else 1.0)
                    grp[name]["kernel"] = grp[name]["kernel"] * g
    return out


def test_spikformer_engine_labels_equal_reference():
    """The reference's ``test_serve_engine_matches_compiled`` case through
    both packages: fused requests give the compiled model's labels, and
    the port's equal the reference's."""
    jcfg, cfg = JConfig().scaled(), SpikformerConfig().scaled()
    jparams = gained_params(jinit(jax.random.PRNGKey(0), jcfg))
    params = from_reference(jax.tree_util.tree_map(np.asarray, jparams))
    imgs = np.asarray(jax.random.randint(jax.random.PRNGKey(1),
                                         (5, 32, 32, 3), 0, 256, jnp.uint8))
    labels = []
    for eng in (JEngine(jparams, jcfg, batch_size=4, backend="packed"),
                SpikformerEngine(params, cfg, batch_size=4, backend="packed",
                                 device="cpu")):
        eng.submit(imgs[:3], rid=0)
        eng.submit(imgs[3:], rid=1)
        done = sorted(eng.run(), key=lambda r: r.rid)
        got = [lab for r in done for lab in r.labels]
        assert got == np.asarray(eng.session.classify(imgs)).tolist()
        labels.append(got)
    assert labels[1] == labels[0]
    assert len(set(labels[0])) > 1, "every label is one class"


# ---------------------------------------------------------------------------
# the --firing-rates fit
# ---------------------------------------------------------------------------

def synthetic_samples(seed):
    """Dense-grid and sparse samples generated from a known cost model
    with a little noise, in the autotuners' sample format."""
    r = np.random.default_rng(seed)
    alpha, unpack, gather, transpose, compact = 2e-10, 9.0, 3.5, 1.8, 12.0
    dense, sparse = [], []
    for m, k, n, g in jtune.GRID:
        t, c = 8 * g, -(-k // 8)
        tb = c * 256 * n * 4
        pen = 1.0 if tb <= (1 << 21) else 3.0
        noise = 1 + 0.03 * r.standard_normal(2)
        dense.append(dict(
            m=m, k=k, n=n, g=g, t=t, c=c, table_bytes=tb,
            unpack_s=alpha * t * m * k * (n + unpack) * noise[0],
            lut_s=alpha * (t * m * c * n * gather * pen
                           + g * m * k * transpose) * noise[1]))
        if k % 8:
            continue
        for rate in (0.1, 0.2, 0.3):
            occ = round(rate * 1.1, 4)
            budget = jlut.sparse_budget(c, occ)
            if budget >= c:
                continue
            sparse.append(dict(
                m=m, k=k, n=n, g=g, t=t, c=c, rate=rate, occupancy=occ,
                budget=budget, table_bytes=tb,
                lut_s=dense[-1]["lut_s"],
                sparse_s=alpha * (t * m * budget * n * gather * pen
                                  + g * m * k * transpose
                                  + t * m * c * budget * compact)
                * (1 + 0.03 * r.standard_normal())))
    return dense, sparse


@pytest.mark.parametrize("seed", [0, 1])
def test_firing_rates_fit_equals_reference(seed):
    dense, sparse = synthetic_samples(seed)
    assert len(sparse) >= 2
    base = tune.fit_constants(dense)
    jbase = jtune.fit_constants(dense)
    assert base.to_dict() == jbase.to_dict()
    got = tune.fit_compact_cost(dense, sparse, base=base)
    want = jtune.fit_compact_cost(dense, sparse, base=jbase)
    assert tune.plan_fragment(got) == {"route_constants": want.to_dict()}
    assert got.compact_cost != base.compact_cost      # the fit moved it
    agree = sum((jlut.choose_route(m=s["m"], k=s["k"], n=s["n"], g=s["g"],
                                   t=s["t"], constants=want,
                                   occupancy=s["occupancy"]) == "lut_sparse")
                == (s["sparse_s"] < s["lut_s"]) for s in sparse)
    assert tune.sparse_agreement(sparse, got) == f"{agree}/{len(sparse)}"
    # too few samples: the base comes back untouched, as in the reference
    assert tune.fit_compact_cost(dense, sparse[:1], base=base) == base


def test_firing_rates_cli_fits_on_the_cpu(capsys):
    """``--firing-rates`` through ``main`` on the CPU: sparse samples on
    structured spikes, a fragment ``ExecutionPlan.from_json`` of both
    packages loads."""
    constants = tune.main(["--device", "cpu", "--fast", "--repeats", "1",
                           "--firing-rates", "0.1,0.2"])
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["sparse_points"] >= 2
    assert summary["sparse_agreement"].endswith(f"/{summary['sparse_points']}")
    fragment = tune.plan_fragment(constants)
    assert ExecutionPlan.from_dict(fragment).route_constants == constants
    assert JPlan.from_dict(fragment).route_constants.to_dict() == \
        constants.to_dict()
