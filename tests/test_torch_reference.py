"""The port's float reference backend against the JAX reference: the
unified-PE ops, the float LIF and the LUT fold emulation on seeded numpy
inputs, the whole ``reference`` backend layer by layer at the reduced
config, and the reference's own contract inside the port: ``reference``,
``packed_cuda`` and ``packed_cuda`` without the fused MLP step give
bit-identical logits on every int8 route and on the f32 LUT routes.

End-to-end cases feed both packages one reference tree whose kernels carry
fixed gains, so that the IAND residual stream still fires at the head
(under plain ``init`` every logit is zero, which would prove nothing)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lif as jlif
from repro.core import unified as junified
from repro.core.spikformer import SpikformerConfig as JConfig
from repro.core.spikformer import fold_inference_params as jfold
from repro.core.spikformer import init as jinit
from repro.infer import ExecutionPlan as JPlan
from repro.infer import compile as jcompile
from repro.infer.compile import lower as jlower
from repro.infer.quant import map_folded_layers as jmap_layers
from repro.infer.quant import quantize_folded as jquantize
from repro.kernels import lut_matmul as jlut
from repro_torch.core import lif, unified
from repro_torch.core.spike import pack_timesteps, packed_occupancy
from repro_torch.core.spikformer import SpikformerConfig
from repro_torch.infer import ExecutionPlan, compile
from repro_torch.infer import registry
from repro_torch.infer.backends import FloatBackend, PackedBackend
from repro_torch.infer.compile import lower
from repro_torch.kernels import lut_matmul as lut
from repro_torch.weights import from_reference
from torch_threads import one_thread  # noqa: F401  (autouse)

GAIN, GAIN_RESIDUAL = 4.0, 0.7        # kernel gains; wo/fc2 get both
# f32 weights in one dot: XLA and torch sum the same products in their own
# orders; |sums| stay below ~30 here (ulp ~2e-6)
F32_ATOL, F32_RTOL = 1e-5, 1e-6


def exact(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def t_(x):
    """numpy -> torch on the CPU, dtype kept."""
    return torch.from_numpy(np.array(x))


def spikes(seed, *shape, rate=0.3):
    return (np.random.default_rng(seed).random(shape) < rate).astype(
        np.float32)


def weights(seed, k, n, *, int_w):
    r = np.random.default_rng(seed)
    if int_w:
        return r.integers(-127, 128, (k, n)).astype(np.float32)
    return r.normal(size=(k, n)).astype(np.float32)


def close_or_exact(got, want, int_w):
    if int_w:
        exact(got, want)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=F32_ATOL, rtol=F32_RTOL)


# ---------------------------------------------------------------------------
# core: the unified-PE ops and the float LIF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int_w", [True, False], ids=["int", "f32"])
def test_unified_wssl_zsc_sssc_match_reference(int_w):
    """Integer-valued weights: every sum is an integer, exact. f32
    weights: one dot (and SSSC's 2^p sum) in another order, F32 tolerance
    (SSSC's magnitudes scale it by up to 255)."""
    s = spikes(1, 4, 2, 6, 6, 5)                          # (T, B, H, W, C)
    w = weights(2, 5, 7, int_w=int_w)
    bias = np.random.default_rng(3).normal(size=7).astype(np.float32)
    close_or_exact(unified.wssl(t_(s), t_(w), t_(bias)),
                   junified.wssl(jnp.asarray(s), jnp.asarray(w),
                                 jnp.asarray(bias)), int_w)
    kz = weights(4, 20, 7, int_w=int_w).reshape(2, 2, 5, 7)
    close_or_exact(unified.zsc(t_(s), t_(kz), t_(bias)),
                   junified.zsc(jnp.asarray(s), jnp.asarray(kz),
                                jnp.asarray(bias)), int_w)
    img = np.random.default_rng(5).integers(0, 256, (2, 6, 4, 3),
                                            dtype=np.uint8)
    ks = weights(6, 12, 7, int_w=int_w).reshape(2, 2, 3, 7)
    got = unified.sssc(t_(img), t_(ks), t_(bias))
    want = junified.sssc(jnp.asarray(img), jnp.asarray(ks), jnp.asarray(bias))
    if int_w:
        exact(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                                   rtol=1e-5)


def test_unified_stdp_matches_reference():
    """Binary q, k, v: integer sums, a power-of-two scale, exact."""
    q, k, v = (spikes(10 + i, 2, 3, 2, 11, 8) for i in range(3))
    exact(unified.stdp(t_(q), t_(k), t_(v), scale=0.125),
          junified.stdp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        scale=0.125))


@pytest.mark.parametrize("t", [1, 4, 9, 17])
def test_tflif_and_lif_step_match_reference(t):
    r = np.random.default_rng(t)
    x = (r.normal(size=(t, 3, 10)) * 1.5).astype(np.float32)
    vth = (0.5 + r.random(10)).astype(np.float32)
    for v_th in (1.0, vth):
        want = jlif.tflif(jnp.asarray(x), v_th=jnp.asarray(v_th))
        got = lif.tflif(t_(x), v_th=v_th if isinstance(v_th, float)
                        else t_(v_th))
        assert got.dtype == torch.float32
        exact(got, want)
    exact(lif.tflif(t_(np.moveaxis(x, 0, 1)), time_axis=1),
          jlif.tflif(jnp.asarray(np.moveaxis(x, 0, 1)), time_axis=1))
    v0 = (r.random((3, 10)) * 0.9).astype(np.float32)
    jv, js = jlif.lif_step(jnp.asarray(v0), jnp.asarray(x[0]),
                           v_th=jnp.asarray(vth))
    v1, s1 = lif.lif_step(t_(v0), t_(x[0]), v_th=t_(vth))
    exact(v1, jv)
    exact(s1, js)


@pytest.mark.parametrize("int_w", [True, False], ids=["int", "f32"])
@pytest.mark.parametrize("k", [8, 40, 61])
def test_lut_matmul_planes_matches_reference(k, int_w):
    """The chunk-by-chunk loop keeps the reference's per-element op order:
    exact for any weights, and equal to the gather over the same table."""
    planes = spikes(k, 3, 5, k)
    w = weights(k + 1, k, 6, int_w=int_w)
    got = lut.lut_matmul_planes(t_(planes), t_(w))
    exact(got, jlut.lut_matmul_planes(jnp.asarray(planes), jnp.asarray(w)))
    idx = lut.plane_indices(pack_timesteps(t_(planes)))[:3]
    exact(got, lut.lut_matmul(idx, lut.build_lut(t_(w))))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_declares_the_reference_backend():
    spec = registry.backend_spec("float")
    assert spec is registry.backend_spec("reference")
    assert spec.device_kinds == ("cuda", "cpu")
    assert spec.wants_lut_tables is False and spec.aliases == ("float",)
    assert registry.backend_spec("packed_cuda").wants_lut_tables is True
    cpu = torch.device("cpu")
    assert isinstance(registry.get_backend("float", device=cpu),
                      FloatBackend)
    with pytest.raises(ValueError, match="not on 'meta'"):
        registry.get_backend("reference", device=torch.device("meta"))
    with pytest.raises(ValueError, match="already registered"):
        registry.register_backend("probe", FloatBackend, aliases=("float",))
    assert "probe" not in registry._REGISTRY
    with pytest.raises(ValueError, match="already registered"):
        registry.register_backend("packed", FloatBackend)
    assert registry.backend_spec("packed").takes_device
    be = registry.get_backend("packed_cuda", device=cpu, fuse_mlp=False)
    assert isinstance(be, PackedBackend) and be.fuse_mlp is False
    with pytest.raises(TypeError):
        registry.get_backend("packed_cuda", device=cpu, fuse=False)
    with pytest.raises(TypeError):
        registry.get_backend("reference", device=cpu, fuse_mlp=False)


def test_reference_plan_with_fuse_mlp_option_compiles():
    """A plan the JAX package wrote with ``fuse_mlp`` off loads and
    compiles in the port with the option honoured, and the fused and
    unfused steps agree."""
    jcfg, cfg = JConfig().scaled(depth=1), SpikformerConfig().scaled(depth=1)
    jplan = JPlan(backend="packed_pallas", weight_dtype="float32",
                  batch_buckets=(2,), route="lut",
                  backend_options={"fuse_mlp": False})
    plan = ExecutionPlan.from_json(jplan.to_json())
    tree = from_reference(jax.tree_util.tree_map(
        np.asarray, firing_tree(jcfg)))
    unfused = compile(tree, cfg, plan, folded=True, device="cpu",
                      backend="packed_cuda")
    assert unfused.backend.fuse_mlp is False
    fused = compile(tree, cfg, plan, folded=True, device="cpu",
                    backend="packed_cuda", backend_options={})
    assert fused.backend.fuse_mlp is True
    imgs = images(cfg, 2, seed=3)
    exact(unfused.logits(imgs), fused.logits(imgs))


# ---------------------------------------------------------------------------
# the whole path at the reduced config
# ---------------------------------------------------------------------------

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


class Recorder:
    """Wraps a backend (either package's) and keeps every layer's output
    as numpy, in forward order. It exposes no ``mlp_pair_lif``, so the MLP
    runs as two layers and every layer is seen."""

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


def reference_trees(over, dtype):
    jcfg, cfg = JConfig().scaled(**over), SpikformerConfig().scaled(**over)
    jtree = firing_tree(jcfg)
    if dtype == "int8":
        jtree = jquantize(jtree)
    return jcfg, cfg, jtree, from_reference(
        jax.tree_util.tree_map(np.asarray, jtree))


# (name, scaled() overrides, weight dtype, route)
REFERENCE_CASES = [
    ("int8-auto", {}, "int8", "auto"),
    ("int8-unpack", {}, "int8", "unpack"),
    ("int8-lut", {}, "int8", "lut"),
    ("f32-lut", {}, "float32", "lut"),
    ("f32-lut-T9", {"depth": 1, "dim": 32, "timesteps": 9}, "float32", "lut"),
]


@pytest.mark.parametrize("name,over,dtype,route", REFERENCE_CASES,
                         ids=[c[0] for c in REFERENCE_CASES])
def test_reference_backend_matches_jax_reference(name, over, dtype, route):
    """Spikes at every layer and the popcount rates exact. The f32 LUT
    routes replay the gather's fold on both sides; int8 sums are integers
    whatever route each package's planner picks (the JAX reference plans
    "auto" with the CPU cost model, the port with the CUDA one)."""
    jcfg, cfg, jtree, tree = reference_trees(over, dtype)
    imgs = images(cfg, 4, seed=len(name))
    jmodel = jcompile(jtree, jcfg, JPlan(
        backend="reference", weight_dtype=dtype, batch_buckets=(4,),
        route=route), folded=True)
    model = compile(tree, cfg, ExecutionPlan(
        backend="reference", weight_dtype=dtype, batch_buckets=(4,),
        route=route), folded=True, device="cpu")
    if route != "auto":
        assert model.plan.routes == jmodel.plan.routes
    # the reference backend takes planner flags, never tables
    for blk in model.folded["blocks"].values():
        for layer in (*blk["ssa"].values(), *blk["mlp"].values()):
            assert layer.get("lut") in ((True,) if route == "lut" else
                                        (None, True))

    jrec, rec = Recorder(jmodel.backend), Recorder(model.backend)
    jlower(jmodel.folded, jcfg, jrec, jit=False)(jmodel.folded,
                                                 jnp.asarray(imgs))
    logits = lower(model.folded, cfg, rec, jit=False)(
        model.folded, torch.from_numpy(imgs))
    assert [n for n, _ in rec.rows] == [n for n, _ in jrec.rows]
    for i, ((n, got), (_, want)) in enumerate(zip(rec.rows, jrec.rows)):
        assert got.dtype == want.dtype, (i, n)
        exact(got, want, f"layer {i} ({n})")
    final = pack_timesteps(torch.from_numpy(rec.rows[-2][1]))
    assert packed_occupancy(final, cfg.timesteps) > 0, "the network is silent"
    assert bool((logits != 0).any()), "all logits are zero"


@pytest.mark.parametrize("name,over,dtype,route", REFERENCE_CASES,
                         ids=[c[0] for c in REFERENCE_CASES])
def test_reference_equals_packed_cuda_in_the_port(name, over, dtype, route):
    """The reference's own contract, inside the port: compiled from one
    plan, ``reference``, ``packed_cuda`` (fused MLP step where fc2 gathers)
    and ``packed_cuda`` unfused plan the same routes and give bit-identical
    logits, and packing the reference's spikes gives the packed backend's
    bytes at every layer."""
    _, cfg, _, tree = reference_trees(over, dtype)
    imgs = images(cfg, 4, seed=7 + len(name))
    plan = ExecutionPlan(weight_dtype=dtype, batch_buckets=(4,), route=route)
    models = {name: compile(tree, cfg, plan, folded=True, device="cpu",
                            backend=backend, backend_options=options)
              for name, backend, options in (
                  ("reference", "reference", {}),
                  ("packed_cuda", "packed_cuda", {}),
                  ("unfused", "packed_cuda", {"fuse_mlp": False}))}
    routes = models["reference"].plan.routes
    assert all(m.plan.routes == routes for m in models.values())
    logits = {k: m.logits(imgs) for k, m in models.items()}
    assert bool((logits["reference"] != 0).any()), "all logits are zero"
    exact(logits["packed_cuda"], logits["reference"])
    exact(logits["unfused"], logits["reference"])

    frec, prec = (Recorder(models[k].backend) for k in ("reference",
                                                        "packed_cuda"))
    lower(models["reference"].folded, cfg, frec, jit=False)(
        models["reference"].folded, torch.from_numpy(imgs))
    lower(models["packed_cuda"].folded, cfg, prec, jit=False)(
        models["packed_cuda"].folded, torch.from_numpy(imgs))
    for i, ((n, f), (_, p)) in enumerate(zip(frec.rows, prec.rows)):
        want = p if n == "rate" else pack_timesteps(torch.from_numpy(f))
        got = f if n == "rate" else p
        exact(got, want, f"layer {i} ({n})")
