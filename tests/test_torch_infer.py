"""The port's inference stack against the JAX reference: int8
quantization, route planning and plan JSON, the whole ``packed_cuda`` path
at the reduced config against the reference's ``packed_pallas`` (its Pallas
kernels in interpret mode), and the serving engine.

End-to-end cases feed both packages one reference tree (folded, or folded
and quantized) whose kernels carry fixed gains: under ``init`` with random
images the reduced model's IAND residual stream falls silent and every
logit is zero, which would prove nothing. Each case asserts that the
network still fires at its last residual and that logits are non-zero."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spikformer import SpikformerConfig as JConfig
from repro.core.spikformer import fold_inference_params as jfold
from repro.core.spikformer import init as jinit
from repro.infer import ExecutionPlan as JPlan
from repro.infer import compile as jcompile
from repro.infer.compile import lower as jlower
from repro.infer.compile import plan_chunks as jplan_chunks
from repro.infer.compile import plan_route_tables as jplan_routes
from repro.infer.engine import StepAccounting as JAcct
from repro.infer.engine import serve_stats as jserve_stats
from repro.infer.quant import map_folded_layers as jmap_layers
from repro.infer.quant import quantize_folded as jquantize
from repro.infer.quant import quantize_layer as jquantize_layer
from repro_torch.core.spike import packed_occupancy
from repro_torch.core.spikformer import (SpikformerConfig,
                                         fold_inference_params, init)
from repro_torch.infer import (ExecutionPlan, MicroBatchEngine, compile,
                               plan_chunks)
from repro_torch.infer.compile import lower, plan_route_tables
from repro_torch.infer.engine import (assemble_batch, serve_stats,
                                      validate_images)
from repro_torch.infer.engine import StepAccounting
from repro_torch.infer.quant import (map_folded_layers, quantize_folded,
                                     quantize_layer)
from repro_torch.kernels import ops
from repro_torch.weights import from_reference
from torch_threads import one_thread  # noqa: F401  (autouse)

# the head dot ``rate @ head`` is the one float reduction outside the
# packed datapath, summed in another order by XLA and torch: rates are
# exact, logits agree to a few ulp
LOGIT_ATOL, LOGIT_RTOL = 1e-5, 1e-5
GAIN, GAIN_RESIDUAL = 4.0, 0.7        # kernel gains; wo/fc2 get both


def exact(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def firing_tree(jcfg, seed=0):
    """The reference's folded tree with gains that keep the residual
    stream firing."""
    folded = jfold(jinit(jax.random.PRNGKey(seed), jcfg), jcfg)

    def gain(path, layer):
        g = GAIN * (GAIN_RESIDUAL if path.endswith(("/wo", "/fc2")) else 1.0)
        return {**layer, "kernel": layer["kernel"] * g}

    return jmap_layers(folded, gain)


def images(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, cfg.img_size, cfg.img_size, cfg.in_channels),
        dtype=np.uint8)


def zero_tree(cfg, dtype):
    """A folded tree of zeros with ``cfg``'s layer shapes: what route
    planning reads, without paying for weights at full width."""
    def layer(k, n):
        d = {"kernel": np.zeros((k, n), dtype),
             "bias": np.zeros(n, np.float32)}
        if dtype == np.int8:
            d["scale"] = np.ones(n, np.float32)
        return d

    cin, scs = cfg.in_channels, {}
    for i, c in enumerate(cfg.scs_channels):
        scs[f"conv{i}"] = layer(4 * cin, c)
        cin = c
    d, h = cfg.dim, cfg.dim * cfg.mlp_ratio
    blocks = {f"b{i}": {"ssa": {w: layer(d, d) for w in ("wq", "wk", "wv",
                                                          "wo")},
                        "mlp": {"fc1": layer(d, h), "fc2": layer(h, d)}}
              for i in range(cfg.depth)}
    return {"scs": scs, "blocks": blocks,
            "head": {"kernel": np.zeros((d, cfg.num_classes), np.float32),
                     "bias": np.zeros(cfg.num_classes, np.float32)}}


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def test_quantize_folded_of_reference_tree_is_exact():
    jcfg = JConfig().scaled(depth=1)
    folded = firing_tree(jcfg)
    want = dict(leaves(to_numpy(jquantize(folded))))
    got = dict(leaves(quantize_folded(from_reference(to_numpy(folded)))))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].numpy().dtype == w.dtype, path
        exact(got[path], w, path)


def test_quantize_layer_rounds_half_to_even():
    """Column 0 has amax 127 (scale 1), so its values land exactly on
    halves: torch.round and jnp.round both round them to even."""
    k = np.array([[127.0, 1.0], [2.5, -3.0], [-3.5, 0.5], [0.5, 0.0]],
                 np.float32)
    layer = {"kernel": k, "bias": np.zeros(2, np.float32)}
    want = to_numpy(jquantize_layer(jax.tree_util.tree_map(jnp.asarray,
                                                           layer)))
    got = quantize_layer(from_reference(layer))
    exact(got["kernel"], want["kernel"])
    exact(got["scale"], want["scale"])
    assert got["kernel"][:, 0].tolist() == [127, 2, -4, 0]


def test_map_folded_layers_visits_the_reference_paths_in_order():
    jcfg = JConfig().scaled(depth=2)
    seen_j, seen_t = [], []
    folded = to_numpy(jfold(jinit(jax.random.PRNGKey(0), jcfg), jcfg))
    jmap_layers(folded, lambda p, l: seen_j.append(p) or l)
    map_folded_layers(from_reference(folded),
                      lambda p, l: seen_t.append(p) or l)
    assert seen_t == seen_j and len(seen_t) == 4 + 6 * 2


# ---------------------------------------------------------------------------
# route planning and plan JSON
# ---------------------------------------------------------------------------

PAPER_INT8_LUT = {"scs/conv0", "scs/conv1", "scs/conv2", "ssa/wq", "ssa/wk",
                  "ssa/wv", "ssa/wo"}


def paper_mix(routes):
    """True when ``routes`` is the paper config's int8 mix: conv0-2 and the
    SSA linears on the gather, conv3, fc1 and fc2 on the unpack dot."""
    return all((r == "lut") == any(p.endswith(s) for s in PAPER_INT8_LUT)
               for p, r in routes.items())


@pytest.mark.parametrize("dtype", [np.int8, np.float32], ids=["int8", "f32"])
def test_paper_config_routes_equal_the_pallas_plan(dtype):
    cfg, jcfg = SpikformerConfig(), JConfig()
    tree = zero_tree(cfg, dtype)
    _, want = jplan_routes(tree, jcfg, batch_size=8, build_tables=False,
                           pallas=True)
    _, got = plan_route_tables(from_reference(tree), cfg, batch_size=8,
                               build_tables=False)
    assert got == want
    if dtype == np.int8:
        assert paper_mix(got)
        # the launches per bucket-8 step that chip_smoke.py checks
        n_lut = sum(r == "lut" for r in got.values())
        assert (n_lut, len(got) - n_lut) == (35, 17)


@pytest.mark.parametrize("cap", [1 << 18, 1 << 24])
def test_reduced_config_routes_equal_the_pallas_plan(cap):
    cfg, jcfg = SpikformerConfig().scaled(), JConfig().scaled()
    tree = zero_tree(cfg, np.int8)
    _, want = jplan_routes(tree, jcfg, batch_size=4, max_table_bytes=cap,
                           build_tables=False, pallas=True)
    annotated, got = plan_route_tables(from_reference(tree), cfg,
                                       batch_size=4, max_table_bytes=cap)
    assert got == want
    # 1 << 18 reproduces the paper config's mix at the reduced widths
    assert paper_mix(got) == (cap == 1 << 18)
    for path, layer in leaves(annotated):
        if path.endswith("/lut"):
            assert layer.shape[1] == 256 and layer.dtype == torch.int16


def test_reference_plan_json_loads_and_replays():
    """A resolved ``packed_pallas`` plan written by the JAX package loads in
    the port, and its pinned routes are replayed, not re-derived: a
    "lut_sparse" pin (with its occupancy) runs the dense gather and gives
    the logits of a plain "lut" pin."""
    jcfg, cfg = JConfig().scaled(depth=1), SpikformerConfig().scaled(depth=1)
    qtree = jquantize(firing_tree(jcfg))
    jplan = jcompile(qtree, jcfg, JPlan(
        backend="packed_pallas", weight_dtype="int8", batch_buckets=(2,),
        max_table_bytes=1 << 18, backend_options={"interpret": True}),
        folded=True).plan
    plan = ExecutionPlan.from_json(jplan.to_json())
    assert plan.to_dict() == jplan.to_dict()
    assert plan.backend == "packed_pallas"
    routes = dict(plan.routes)
    pinned = {**routes, "scs/conv1": "unpack", "blocks/b0/ssa/wq": "unpack"}
    sparse = {**routes, "scs/conv2": "lut_sparse"}
    tree = from_reference(to_numpy(qtree))
    imgs = images(cfg, 2, seed=7)
    out = {}
    for name, pins, occ in (("replay", routes, None),
                            ("pinned", pinned, None),
                            ("sparse", sparse, {"scs/conv2": 0.5})):
        m = compile(tree, cfg, dataclasses.replace(
            plan, backend="packed_cuda", backend_options={}, routes=pins,
            layer_occupancy=occ), folded=True, device="cpu")
        assert m.plan.routes == pins, name
        out[name] = m.logits(imgs)
    exact(out["replay"], out["sparse"])
    exact(out["replay"], out["pinned"])   # int8: every route is exact
    with pytest.raises(ValueError, match="requires a calibrated occupancy"):
        compile(tree, cfg, dataclasses.replace(
            plan, backend="packed_cuda", backend_options={}, routes=sparse),
            folded=True, device="cpu")


def test_plan_fields_and_chunks_match_reference():
    jfields = [f.name for f in dataclasses.fields(JPlan)]
    assert [f.name for f in dataclasses.fields(ExecutionPlan)] == jfields
    p = ExecutionPlan(weight_dtype="int8", batch_buckets=(8, 1, 8))
    assert p.batch_buckets == (1, 8)
    assert ExecutionPlan.from_json(p.to_json()) == p
    with pytest.raises(ValueError, match="unknown ExecutionPlan keys"):
        ExecutionPlan.from_dict({"interpret": True})
    for buckets in ((1, 8), (2, 4, 8), (3,), (1, 5, 6)):
        for n in range(0, 20):
            assert plan_chunks(n, buckets) == jplan_chunks(n, buckets), (
                n, buckets)


# ---------------------------------------------------------------------------
# the whole path at the reduced config
# ---------------------------------------------------------------------------

class Recorder:
    """Wraps a backend (either package's) and keeps every layer's packed
    output and the popcount rates as numpy, in forward order. It exposes no
    ``mlp_pair_lif``, so both packages run the MLP as two layers (the
    reference's fused kernel is held to its own unfused path by the
    reference's tests and is not on the port's path)."""

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


# (name, scaled() overrides, weight dtype, plan fields)
E2E_CASES = [
    ("int8-paper-mix", {}, "int8", {"max_table_bytes": 1 << 18}),
    ("int8-unpack", {}, "int8", {"route": "unpack"}),
    ("f32-lut", {}, "float32", {"route": "lut"}),
    ("int8-T9", {"depth": 1, "dim": 32, "timesteps": 9}, "int8", {}),
]


@pytest.mark.parametrize("name,over,dtype,fields", E2E_CASES,
                         ids=[c[0] for c in E2E_CASES])
def test_packed_cuda_matches_packed_pallas_end_to_end(name, over, dtype,
                                                      fields):
    jcfg, cfg = JConfig().scaled(**over), SpikformerConfig().scaled(**over)
    jtree = firing_tree(jcfg)
    if dtype == "int8":
        jtree = jquantize(jtree)
    imgs = images(cfg, 4, seed=len(name))
    jmodel = jcompile(jtree, jcfg, JPlan(
        backend="packed_pallas", weight_dtype=dtype, batch_buckets=(4,),
        backend_options={"interpret": True}, **fields), folded=True)
    model = compile(from_reference(to_numpy(jtree)), cfg, ExecutionPlan(
        backend="packed_cuda", weight_dtype=dtype, batch_buckets=(4,),
        **fields), folded=True, device="cpu")
    assert model.plan.routes == jmodel.plan.routes
    if name == "int8-paper-mix":
        assert paper_mix(model.plan.routes)

    jrec, rec = Recorder(jmodel.backend), Recorder(model.backend)
    jlogits = jlower(jmodel.folded, jcfg, jrec, jit=False)(jmodel.folded,
                                                           jnp.asarray(imgs))
    logits = lower(model.folded, cfg, rec, jit=False)(
        model.folded, torch.from_numpy(imgs))
    assert [n for n, _ in rec.rows] == [n for n, _ in jrec.rows]
    for i, ((n, got), (_, want)) in enumerate(zip(rec.rows, jrec.rows)):
        assert got.dtype == want.dtype, (i, n)
        exact(got, want, f"layer {i} ({n})")
    final = rec.rows[-2][1]                        # the last residual
    assert packed_occupancy(final, cfg.timesteps) > 0, "the network is silent"

    want = np.asarray(jmodel.logits(imgs))         # packed_pallas, jitted
    np.testing.assert_allclose(np.asarray(jlogits), want, rtol=0, atol=0)
    got = model.logits(imgs).numpy()
    exact(got, logits)
    assert np.abs(got).max() > 0, "all logits are zero"
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    exact(got.argmax(-1), want.argmax(-1))


def test_port_fold_feeds_the_same_spikes_as_the_reference_fold():
    """The port's own fold of a training tree, held to a tolerance at the
    tree (rsqrt), gives the same int8 model as the reference's fold: the
    quantized kernels and every label agree."""
    jcfg, cfg = JConfig().scaled(depth=1), SpikformerConfig().scaled(depth=1)
    params = to_numpy(jinit(jax.random.PRNGKey(2), jcfg))
    jq = to_numpy(jquantize(jfold(params, jcfg)))
    q = quantize_folded(fold_inference_params(from_reference(params), cfg))
    for (path, got), (_, want) in zip(leaves(q), leaves(jq)):
        if path.endswith("/kernel") and want.dtype == np.int8:
            exact(got, want, path)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-7, err_msg=path)


def test_dispatches_per_step_match_the_plan(monkeypatch):
    """Each kernel wrapper is reached once per layer it serves: LIFs =
    4 SCS + 7 per block (q, k, v, attention, wo, fc1, fc2), gathers = LUT
    layers, int8 unpack dots = unpack layers (all on the s8 wrapper, none
    on the f32 one), STDP = one per block. chip_smoke.py holds the card's
    launch counters to the same formula."""
    cfg = SpikformerConfig().scaled()
    jtree = jquantize(firing_tree(JConfig().scaled()))
    model = compile(from_reference(to_numpy(jtree)), cfg, ExecutionPlan(
        weight_dtype="int8", batch_buckets=(2,), max_table_bytes=1 << 18),
        folded=True, device="cpu")
    calls = dict.fromkeys(("tflif", "lut", "unpack", "unpack_s8",
                           "stdp_packed"), 0)
    for name in calls:
        fn = getattr(ops._WRAPPERS, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(ops._WRAPPERS, name, counted)
    model.step(images(cfg, 2))
    n_lut = sum(r == "lut" for r in model.plan.routes.values())
    assert calls == {"tflif": len(cfg.scs_channels) + 7 * cfg.depth,
                     "lut": n_lut, "unpack": 0,
                     "unpack_s8": len(model.plan.routes) - n_lut,
                     "stdp_packed": cfg.depth}
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_model():
    cfg = SpikformerConfig().scaled(depth=1)
    folded = fold_inference_params(init(torch.Generator().manual_seed(2),
                                        cfg), cfg)
    folded = map_folded_layers(folded, lambda p, l: {
        **l, "kernel": l["kernel"] * GAIN * (
            GAIN_RESIDUAL if p.endswith(("/wo", "/fc2")) else 1.0)})
    return compile(folded, cfg, ExecutionPlan(
        weight_dtype="int8", batch_buckets=(1, 4)), folded=True,
        device="cpu")


def test_engine_answers_mixed_requests_like_classify(small_model):
    cfg = small_model.cfg
    sizes = (1, 4, 3, 2, 0, 5)
    reqs_imgs = [images(cfg, n, seed=10 + i) for i, n in enumerate(sizes)]
    engine = MicroBatchEngine(small_model)
    seen = []
    reqs = [engine.submit(x, on_image=lambda *a: seen.append(a))
            for x in reqs_imgs]
    engine.run()
    allimgs = np.concatenate(reqs_imgs)
    want = small_model.classify(allimgs).tolist()
    got = [lab for r in reqs for lab in r.result()]
    assert got == want
    assert len(set(want)) > 1, "labels do not depend on the images"
    assert len(seen) == sum(sizes)
    stats = engine.stats()
    jstats = jserve_stats(acct=JAcct(), done=[], buckets=(1, 4))
    assert stats.keys() == jstats.keys()
    assert stats["stats_version"] == jstats["stats_version"] == 3
    assert stats["requests"] == len(sizes) and stats["images"] == sum(sizes)
    # 15 images over buckets (1, 4): three 4-steps, then 3 as one padded
    # 4-step or three 1-steps, whichever wastes fewer rows
    assert stats["padded_rows"] == 0 and stats["batches"] == 6
    assert stats["latency_p50_s"] is not None
    assert serve_stats(acct=StepAccounting(), done=[],
                       buckets=(1,)).keys() == jstats.keys()


def test_engine_validates_requests(small_model):
    shape = small_model.input_shape()[1:]
    engine = MicroBatchEngine(small_model)
    with pytest.raises(ValueError, match="expects"):
        engine.submit(np.zeros((1, 8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="dtype float"):
        validate_images(np.zeros((1, *shape), np.float32), shape)
    with pytest.raises(ValueError, match="outside"):
        validate_images(np.full((1, *shape), 300, np.int32), shape)
    ok = validate_images(np.full((1, *shape), 9, np.int64), shape)
    assert ok.dtype == np.uint8
    req = engine.submit(ok, rid=5)
    with pytest.raises(ValueError, match="already in flight"):
        engine.submit(ok, rid=5)
    assert req.result() == small_model.classify(ok).tolist()
    batch, pad = assemble_batch([ok[0], ok[0]], 4)
    assert batch.shape == (4, *shape) and pad == 2 and not batch[2:].any()
    with pytest.raises(ValueError, match="not a bucket"):
        small_model.step(np.zeros((3, *shape), np.uint8))
