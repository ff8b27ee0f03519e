"""The rest of the port's ``compile()`` API against the JAX reference: the
layer-path orders, ``CompiledModel.profile_step``, ``bucket_for`` and
``weight_dtype``, ``jit`` (eager on the CPU), the step's device constants,
and the route autotuner (``repro_torch.launch.autotune_routes``): its CPU
fit against the reference script's, its card fit on synthetic samples, and
the fragment it writes loading and planning alike in both packages.

Every comparison is exact."""
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.spikformer import SpikformerConfig as JConfig
from repro.core.spikformer import fold_inference_params as jfold
from repro.core.spikformer import init as jinit
from repro.infer import ExecutionPlan as JPlan
from repro.infer import compile as jcompile
from repro.infer.compile import linear_layer_paths as jlinear_paths
from repro.infer.compile import plan_route_tables as jplan_routes
from repro.infer.compile import profile_layer_paths as jprofile_paths
from repro.infer.quant import map_folded_layers as jmap_layers
from repro.kernels.lut_matmul import RouteConstants as JConstants
from repro.obs.trace import Tracer
from repro_torch.core.lif import V_TH
from repro_torch.core.spikformer import SpikformerConfig
from repro_torch.device import constant
from repro_torch.infer import ExecutionPlan, compile
from repro_torch.infer.compile import (GraphedStep, layer_shape,
                                       linear_layer_paths, lower,
                                       plan_route_tables, profile_layer_paths)
from repro_torch.kernels import ops
from repro_torch.kernels.lut_matmul import (DEFAULT_ROUTE_CONSTANTS,
                                            RouteConstants, choose_cuda_route)
from repro_torch.launch import autotune_routes as tune
from repro_torch.weights import from_reference

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "scripts"))
import autotune_routes as jtune  # noqa: E402  (the reference script)
from torch_threads import one_thread  # noqa: F401  (autouse)

GAIN, GAIN_RESIDUAL = 4.0, 0.7        # kernel gains; wo/fc2 get both


def firing_tree(jcfg, seed=0):
    """The reference's folded tree with gains that keep the residual
    stream firing."""
    folded = jfold(jinit(jax.random.PRNGKey(seed), jcfg), jcfg)

    def gain(path, layer):
        g = GAIN * (GAIN_RESIDUAL if path.endswith(("/wo", "/fc2")) else 1.0)
        return {**layer, "kernel": layer["kernel"] * g}

    return jmap_layers(folded, gain)


def port_tree(jtree):
    return from_reference(jax.tree_util.tree_map(np.asarray, jtree))


def images(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, cfg.img_size, cfg.img_size, cfg.in_channels),
        dtype=np.uint8)


def zero_tree(cfg):
    """An int8 folded tree of zeros with ``cfg``'s layer shapes: what
    route planning reads."""
    def layer(k, n):
        return {"kernel": np.zeros((k, n), np.int8),
                "bias": np.zeros(n, np.float32),
                "scale": np.ones(n, np.float32)}

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


CONFIGS = {"paper": {}, "scaled": {"scaled": True},
           "scaled-t9": {"scaled": True, "timesteps": 9}}


def configs(name):
    over = dict(CONFIGS[name])
    if over.pop("scaled", False):
        return JConfig().scaled(**over), SpikformerConfig().scaled(**over)
    return JConfig(), SpikformerConfig()


class TickClock:
    """Advances 1.0 a call: pins every timed row to 1.0 seconds."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        self.now += 1.0
        return self.now


# ---------------------------------------------------------------------------
# layer paths and shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layer_paths_equal_the_reference(name):
    jcfg, cfg = configs(name)
    assert linear_layer_paths(cfg) == jlinear_paths(jcfg)
    assert profile_layer_paths(cfg) == jprofile_paths(jcfg)
    assert len(profile_layer_paths(cfg)) == len(linear_layer_paths(cfg)) \
        + cfg.depth


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layer_shape_plans_the_reference_routes(name):
    """``layer_shape`` (what route planning keys on) under the card's
    chooser gives the reference's ``choose_pallas_route`` plan, at two
    bucket sizes."""
    jcfg, cfg = configs(name)
    tree = zero_tree(cfg)
    for batch in (1, 8):
        _, want = jplan_routes(tree, jcfg, batch_size=batch,
                               build_tables=False, pallas=True)
        got = {}
        for path in linear_layer_paths(cfg):
            m, t, g = layer_shape(cfg, path, batch)
            k, n = tune.layer_dims(cfg, path)
            got[path] = choose_cuda_route(m=m, k=k, n=n, g=g, t=t,
                                          weights_are_int=True)
        assert got == want, batch


# ---------------------------------------------------------------------------
# profile_step, bucket_for, weight_dtype
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def profiled():
    """The port and the reference compiled from one reference tree at the
    reduced config, int8, under the port's planned routes (a mix of gather
    and unpack layers under a 64 KiB table cap) and one calibrated
    occupancy a layer."""
    jcfg, cfg = JConfig().scaled(depth=1), SpikformerConfig().scaled(depth=1)
    tree = firing_tree(jcfg)
    occ = {p: round(0.05 * (i + 1), 2)
           for i, p in enumerate(linear_layer_paths(cfg))}
    model = compile(port_tree(tree), cfg, ExecutionPlan(
        weight_dtype="int8", batch_buckets=(2, 4), max_table_bytes=1 << 16,
        layer_occupancy=occ), folded=True, device="cpu", jit=False)
    jmodel = jcompile(tree, jcfg, JPlan(
        backend="packed", weight_dtype="int8", batch_buckets=(2, 4),
        routes=model.plan.routes, layer_occupancy=occ), folded=True,
        jit=False)
    return cfg, model, jmodel


def test_profile_step_rows_equal_the_reference(profiled):
    """Path, route and occupancy columns equal the reference's
    ``profile_step`` under the same pinned routes; with a clock that ticks
    1.0 a call, every row (seconds included) and every ``("layer", path)``
    span does."""
    cfg, model, jmodel = profiled
    routes = set(model.plan.routes.values())
    assert routes == {"lut", "unpack"}, routes
    imgs = images(cfg, 2)
    rows = model.profile_step(imgs)
    jrows = jmodel.profile_step(imgs)
    cols = ("path", "route", "occupancy")
    assert ([tuple(r[c] for c in cols) for r in rows]
            == [tuple(r[c] for c in cols) for r in jrows])
    assert all(r["seconds"] > 0 for r in rows)

    tr, jtr = Tracer(), Tracer()
    rows = model.profile_step(imgs, tracer=tr, clock=TickClock())
    jrows = jmodel.profile_step(imgs, tracer=jtr, clock=TickClock())
    assert rows == jrows
    assert {r["seconds"] for r in rows} == {1.0}
    spans = [s for s in tr.spans() if s.category == "layer"]
    assert [s.name for s in spans] == [r["path"] for r in rows]
    assert [(s.name, s.t0, s.t1, s.value) for s in spans] == [
        (s.name, s.t0, s.t1, s.value) for s in jtr.spans()
        if s.category == "layer"]


class StubTracer:
    enabled = True

    def __init__(self):
        self.spans = []

    def span(self, category, name, **kw):
        self.spans.append((category, name, kw))


def test_profile_step_emits_one_span_a_row_and_rejects_other_batches(
        profiled):
    cfg, model, _ = profiled
    tracer = StubTracer()
    rows = model.profile_step(tracer=tracer)      # zeros at the largest bucket
    assert [r["path"] for r in rows] == profile_layer_paths(cfg)
    assert [(c, n) for c, n, _ in tracer.spans] == [
        ("layer", r["path"]) for r in rows]
    assert all(kw["value"] == r["seconds"]
               and kw["occupancy"] == r["occupancy"]
               for (_, _, kw), r in zip(tracer.spans, rows))
    disabled = StubTracer()
    disabled.enabled = False
    model.profile_step(images(cfg, 4), tracer=disabled)
    assert disabled.spans == []
    with pytest.raises(ValueError, match="bucket"):
        model.profile_step(images(cfg, 3))


def test_profile_step_runs_the_two_layer_mlp(profiled):
    """The timer exposes no ``mlp_pair_lif``: on a plan whose serving step
    fuses every MLP pair, a profiled forward still times fc1 and fc2 apart
    (a fused pair would leave the trace a row short, which raises)."""
    cfg = SpikformerConfig().scaled(depth=1)
    tree = port_tree(firing_tree(JConfig().scaled(depth=1)))
    model = compile(tree, cfg, ExecutionPlan(
        weight_dtype="float32", route="lut", batch_buckets=(2,)),
        folded=True, device="cpu")
    assert model.backend.fuse_mlp
    x = torch.zeros((1, 2, cfg.tokens, cfg.dim), dtype=torch.uint8)
    mlp = model.folded["blocks"]["b0"]["mlp"]
    assert model.backend.mlp_pair_lif(x, mlp["fc1"], mlp["fc2"],
                                      t=cfg.timesteps) is not None
    rows = model.profile_step(images(cfg, 2))
    assert [r["path"] for r in rows] == profile_layer_paths(cfg)
    assert [r["route"] for r in rows if "/mlp/" in r["path"]] == ["lut"] * 2


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("buckets", [(1, 8), (2, 4, 8), (4,)],
                         ids=["1-8", "2-4-8", "4"])
def test_bucket_for_and_weight_dtype_equal_the_reference(buckets, dtype):
    jcfg, cfg = JConfig().scaled(depth=1), SpikformerConfig().scaled(depth=1)
    tree = firing_tree(jcfg)
    jmodel = jcompile(tree, jcfg, JPlan(
        backend="packed", weight_dtype=dtype, batch_buckets=buckets),
        folded=True, jit=False)
    model = compile(port_tree(tree), cfg, ExecutionPlan(
        weight_dtype=dtype, batch_buckets=buckets), folded=True,
        device="cpu")
    assert model.weight_dtype == jmodel.weight_dtype == dtype
    assert ([model.bucket_for(n) for n in range(1, 12)]
            == [jmodel.bucket_for(n) for n in range(1, 12)])


# ---------------------------------------------------------------------------
# jit on the CPU, and the step's device constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", [
    {"weight_dtype": "int8"},
    {"weight_dtype": "float32", "route": "lut"},
    {"weight_dtype": "int8", "route": "unpack"}],
    ids=["int8", "lut", "unpack"])
def test_jit_and_eager_steps_give_equal_logits_on_the_cpu(plan):
    """``jit`` is recorded, the step is a ``GraphedStep`` that runs eagerly
    on the CPU (it captures nothing), and its logits equal the eager
    lowering's, at every bucket and through ``logits``' chunking."""
    cfg = SpikformerConfig().scaled(depth=1)
    tree = port_tree(firing_tree(JConfig().scaled(depth=1)))
    models = {jit: compile(tree, cfg, ExecutionPlan(batch_buckets=(1, 4),
                                                    **plan),
                           folded=True, device="cpu", jit=jit)
              for jit in (True, False)}
    assert models[True].jit and not models[False].jit
    assert isinstance(models[True]._fwd, GraphedStep)
    assert not isinstance(models[False]._fwd, GraphedStep)
    imgs = images(cfg, 6, seed=4)
    got, want = models[True].logits(imgs), models[False].logits(imgs)
    assert torch.equal(got, want)
    assert bool((want != 0).any()), "all logits are zero"
    for b in (1, 4):
        assert torch.equal(models[True].step(imgs[:b]),
                           models[False].step(imgs[:b]))
    assert models[True]._fwd.graphs == {}
    assert models[True].graph_launch_counts() == {}


def test_lower_jit_is_the_default_and_keeps_its_tree():
    cfg = SpikformerConfig().scaled(depth=1)
    model = compile(port_tree(firing_tree(JConfig().scaled(depth=1))), cfg,
                    ExecutionPlan(batch_buckets=(2,)), folded=True,
                    device="cpu")
    step = lower(model.folded, cfg, model.backend)
    assert isinstance(step, GraphedStep) and model.jit
    imgs = torch.from_numpy(images(cfg, 2))
    assert torch.equal(step(model.folded, imgs), model.step(imgs))
    eager = lower(model.folded, cfg, model.backend, jit=False)
    assert torch.equal(eager(model.folded, imgs), model.step(imgs))
    with pytest.raises(ValueError, match="tree"):
        step(dict(model.folded), imgs)


def test_step_constants_are_made_once_with_the_same_bits():
    """The LIF's scalar threshold and zero bias, the popcount table and the
    bit shifts come from one tensor a device, made once (no copy a call,
    none during a graph capture), with the bits the per-call copies had."""
    dev = torch.device("cpu")
    a, b = ops._period_vector(V_TH, (3, 5), dev), ops._period_vector(
        V_TH, (7,), dev)
    assert a is b and a.shape == (1,)
    assert torch.equal(a, torch.as_tensor(V_TH, dtype=torch.float32)[None])
    v = ops._channel_vector(1.0 / 3.0, 6, dev)
    assert v is ops._channel_vector(1.0 / 3.0, 6, dev)
    assert torch.equal(v, torch.full((6,), torch.tensor(
        1.0 / 3.0, dtype=torch.float32).item()))
    assert v.dtype == torch.float32
    bias = torch.arange(5, dtype=torch.float32)
    assert torch.equal(ops._channel_vector(bias, 5, dev), bias)
    made = []
    first = constant("test_const", dev, lambda d: made.append(d) or
                     torch.ones(2, device=d))
    assert constant("test_const", dev, lambda d: made.append(d)) is first
    assert made == [dev]


# ---------------------------------------------------------------------------
# the route autotuner
# ---------------------------------------------------------------------------

def synthetic_cpu_samples(true, alpha=1e-9):
    """Plain-route times generated from a known CPU cost model (the
    reference test's recipe)."""
    samples = []
    for m, k, n, g in [(64, 32, 16, 1), (256, 64, 64, 1), (512, 32, 32, 1),
                       (1024, 64, 32, 2), (2048, 32, 16, 1),
                       (256, 128, 128, 1)]:
        t, c = 8 * g, -(-k // 8)
        samples.append({
            "m": m, "k": k, "n": n, "g": g, "t": t, "c": c,
            "table_bytes": 32 * k * n,
            "unpack_s": alpha * t * m * k * (n + true.unpack_cost),
            "lut_s": alpha * (t * m * c * n * true.gather_cost
                              + g * m * k * true.transpose_cost)})
    return samples


def test_fit_constants_recovers_known_constants_as_the_reference_does():
    true = RouteConstants(gather_cost=6.0, transpose_cost=1.5,
                          unpack_cost=12.0)
    samples = synthetic_cpu_samples(true)
    fitted = tune.fit_constants(samples)
    assert fitted.gather_cost == pytest.approx(true.gather_cost, rel=0.05)
    assert fitted.unpack_cost == pytest.approx(true.unpack_cost, rel=0.15)
    assert fitted.to_dict() == jtune.fit_constants(samples).to_dict()
    # fewer than three samples cannot identify the model: the defaults
    assert tune.fit_constants(samples[:2]) == RouteConstants()


def synthetic_cuda_samples(gather, transpose, alpha=2.5e-15, grid=None):
    """Kernel times generated from a known card cost model over the paper
    config's grid."""
    samples = []
    for m, k, n, g, t in grid or tune.cuda_grid():
        c = -(-k // 8)
        samples.append({
            "m": m, "k": k, "n": n, "g": g, "t": t, "c": c,
            "weight_dtype": "int8", "table_bytes": 0,
            "cuda_dot_s": alpha * t * m * k * n,
            "cuda_lut_s": alpha * (t * m * c * n * gather
                                   + g * m * k * transpose)})
    return samples


def test_fit_cuda_constants_recovers_known_constants():
    fitted = tune.fit_cuda_constants(synthetic_cuda_samples(24.0, 6.0))
    assert fitted.pallas_dot_cost == 1.0
    assert fitted.pallas_gather_cost == pytest.approx(24.0, rel=1e-6)
    assert fitted.transpose_cost == pytest.approx(6.0, rel=1e-6)
    # every other key keeps the reference's default
    rest = {k: v for k, v in fitted.to_dict().items()
            if k not in ("pallas_gather_cost", "pallas_dot_cost",
                         "transpose_cost")}
    assert rest == {k: v for k, v in DEFAULT_ROUTE_CONSTANTS.to_dict().items()
                    if k in rest}
    fast = tune.fit_cuda_constants(synthetic_cuda_samples(
        24.0, 6.0, grid=tune.cuda_grid(fast=True)))
    assert fast.pallas_gather_cost == pytest.approx(24.0, rel=1e-6)


def test_fit_cuda_constants_keeps_what_the_samples_cannot_identify():
    # a transpose term the samples give as negative is not identified:
    # transpose_cost stays the base's and the gather absorbs the rest
    base = RouteConstants(transpose_cost=2.5)
    fitted = tune.fit_cuda_constants(synthetic_cuda_samples(10.0, -3.0),
                                     base=base)
    assert fitted.transpose_cost == 2.5
    assert 0 < fitted.pallas_gather_cost < 10.0
    # no positive unit, or too few samples: the base as it is
    bad = synthetic_cuda_samples(10.0, 1.0)
    for s in bad:
        s["cuda_dot_s"] = -s["cuda_dot_s"]
    assert tune.fit_cuda_constants(bad, base=base) == base
    assert tune.fit_cuda_constants(bad[:1], base=base) == base


def test_cuda_grid_holds_the_paper_layers_at_batch_8():
    cfg = SpikformerConfig()
    fast = tune.cuda_grid(fast=True)
    assert fast == [(100352, 12, 64, 1, 8), (25088, 256, 128, 1, 4),
                    (6272, 512, 256, 1, 4), (1568, 1024, 512, 1, 4),
                    (1568, 512, 512, 1, 4), (1568, 512, 2048, 1, 4),
                    (1568, 2048, 512, 1, 4)]
    full = tune.cuda_grid()
    assert full[:len(fast)] == fast and len(full) > len(fast)
    assert len(set(full)) == len(full)
    for path in linear_layer_paths(cfg):
        m, t, g = layer_shape(cfg, path, 8)
        assert (m, *tune.layer_dims(cfg, path), g, t) in fast


def test_cuda_agreement_and_route_sums():
    samples = synthetic_cuda_samples(24.0, 6.0)
    assert tune.cuda_agreement(samples, tune.fit_cuda_constants(samples)) \
        == f"{len(samples)}/{len(samples)}"
    rows = [{"route": "lut", "seconds": 1.0}, {"route": "stdp",
                                                "seconds": 2.0},
            {"route": "lut", "seconds": 1.0}]
    assert tune.route_sums(rows) == {
        "lut": {"layers": 2, "seconds": 2.0, "share": 0.5},
        "stdp": {"layers": 1, "seconds": 2.0, "share": 0.5}}


# constants whose fitted plan mixes routes at both configs
MIXED = {"gather": 7.5, "transpose": 6.0}


def test_cuda_fragment_loads_in_both_packages_and_plans_alike():
    """A fragment written from fitted constants holds only reference keys,
    loads in both ``ExecutionPlan.from_json``, and under it the port's
    routes equal the reference's ``choose_pallas_route`` routes at the
    paper config and the reduced one; the reduced model's ``packed_cuda``
    logits equal ``packed_plain``'s."""
    fitted = tune.fit_cuda_constants(synthetic_cuda_samples(
        MIXED["gather"], MIXED["transpose"]))
    text = json.dumps(tune.plan_fragment(fitted, "int8"), indent=1,
                      sort_keys=True)
    jplan, plan = JPlan.from_json(text), ExecutionPlan.from_json(text)
    assert set(json.loads(text)["route_constants"]) == set(
        JConstants().to_dict())
    assert plan.route_constants.to_dict() == jplan.route_constants.to_dict()
    assert plan.weight_dtype == jplan.weight_dtype == "int8"
    assert plan.route_constants != DEFAULT_ROUTE_CONSTANTS

    for jcfg, cfg, batch in ((JConfig(), SpikformerConfig(), 8),
                             (JConfig().scaled(), SpikformerConfig().scaled(),
                              4)):
        tree = zero_tree(cfg)
        _, want = jplan_routes(tree, jcfg, batch_size=batch,
                               build_tables=False, pallas=True,
                               constants=jplan.route_constants)
        _, got = plan_route_tables(from_reference(tree), cfg,
                                   batch_size=batch, build_tables=False,
                                   constants=plan.route_constants)
        assert got == want
        _, default = plan_route_tables(from_reference(tree), cfg,
                                       batch_size=batch, build_tables=False)
        assert set(got.values()) == {"lut", "unpack"}
        assert got != default

    jcfg, cfg = JConfig().scaled(), SpikformerConfig().scaled()
    tree = port_tree(firing_tree(jcfg))
    imgs = images(cfg, 4, seed=9)
    cuda, plain = (compile(tree, cfg, plan, folded=True, device="cpu",
                           batch_buckets=(4,), backend=b)
                   for b in ("packed_cuda", "packed_plain"))
    assert cuda.plan.routes == plain.plan.routes
    logits = cuda.logits(imgs)
    assert torch.equal(logits, plain.logits(imgs))
    assert bool((logits != 0).any()), "all logits are zero"


def test_plain_route_grid_and_profile_run_on_the_cpu(capsys):
    """The plain-route fit's timing and ``--profile`` run on the CPU when
    asked; the timings are host times of the plain routes, positive."""
    s = tune.measure_point(64, 32, 16, 1, repeats=1, device="cpu")
    assert s["unpack_s"] > 0 and s["lut_s"] > 0 and s["c"] == 4
    rows = tune.main(["--profile", "--device", "cpu"])
    assert [r["path"] for r in rows] == profile_layer_paths(
        SpikformerConfig().scaled())
    out = capsys.readouterr().out
    assert '"per_route"' in out
