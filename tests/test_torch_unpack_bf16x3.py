"""The f32 unpack route of the port (kernel 3 with f32 weights on the bf16
tensor cores, ``csrc/unpack_dot.cu``) against the JAX reference.

The kernel reads each f32 kernel as three bf16 terms, ``hi + mid + lo ==
w``, which the planner builds once per layer (``bf16x3_weights``). Here:
the split is exact over seeded weights of every magnitude it is meant to
hold and over the unpack-routed kernels of the reduced folded tree; the
planner refuses, naming the layer, a kernel it cannot hold; the plan
carries the split on exactly its f32 unpack layers other than conv0 where
the kernels lie on the card, and never on the CPU, without moving a route.

The kernel runs only on the card, so its arithmetic is emulated with the
model of the tensor cores' addition in ``scripts/wgmma_accumulation.py``:
a ``wgmma`` k16 aligns its 16 products and the accumulator to the largest
term, keeps 26 bits from its leading bit down, drops the rest, and rounds
the exact sum toward zero to f32. That model matches the kernel bit for
bit on an H100 (the script's two probes). Over it, the kernel's order
(each 16-deep slice's hi products from zero, added to a master f32 sum
with round-to-nearest adds; the lo, then mid, products into a second
accumulator over all of K, taken last) is held to the Pallas kernel it
replaces, ``_spike_matmul_grouped`` in interpret mode: bit for bit for
integer-valued weights, within the stated tolerance for f32 weights; and
at fc2's shape it sits closer to the f64 sum than the Pallas kernel does,
where one accumulator a K step sits farther. Inputs come from seeded
numpy."""
import importlib
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
from repro.infer import compile as jcompile
from repro.core.lif import bn_init
from repro.core.lif import fold_bn as jfold_bn
from repro.infer.quant import map_folded_layers as jmap_layers
from repro.kernels.spike_matmul import _spike_matmul_grouped as jgrouped
from repro.nn.layers import linear_init
from repro_torch.core.spike import unpack_timesteps
from repro_torch.core.spikformer import SpikformerConfig
from repro_torch.infer import ExecutionPlan, compile
from repro_torch.infer.compile import (plan_route_tables,
                                       strip_lut_annotations)
from repro_torch.infer.quant import map_folded_layers
from repro_torch.kernels import ops
from repro_torch.kernels.spike_matmul import (bf16x3_weights,
                                              spike_matmul_grouped)
from repro_torch.weights import from_reference

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "scripts"))
import wgmma_accumulation as wgmma  # noqa: E402  (the tensor cores' model)
from torch_threads import one_thread  # noqa: F401  (autouse)

compile_module = importlib.import_module("repro_torch.infer.compile")
GAIN, GAIN_RESIDUAL = 4.0, 0.7        # kernel gains; wo/fc2 get both
# f32 weights: the emulation sums 16-deep slices, the Pallas kernel
# 256-deep blocks; with normal weights and a 0.3 firing
# rate |sums| stay below ~60 at K = 2048 (ulp ~4e-6), so two orders differ
# by a few hundred ulp at most
F32_ATOL, F32_RTOL = 1e-4, 1e-5
# fc2 of the paper config: K 2048, N 512, its kernel's gain in the gained
# tree
FC2_K, FC2_N, FC2_GAIN = 2048, 512, GAIN * GAIN_RESIDUAL
# a weight whose low bits fall below bf16's subnormals
TINY = 2.0 ** -120 * (1.0 + 2.0 ** -20)
# a cap under every reduced layer's table: every layer but conv0 unpacks
SMALL_CAP = 1 << 10
SLICE = wgmma.SLICE             # the kernel's wgmma depth


def exact(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def terms(split: torch.Tensor) -> tuple:
    """The three (K, N) terms of a split, in f32."""
    return tuple(split[q].T.to(torch.float32) for q in range(3))


def assert_exact_split(w: torch.Tensor, split: torch.Tensor, what=""):
    k, n = w.shape
    assert split.dtype == torch.bfloat16 and split.shape == (3, n, k), what
    assert split.stride(2) == 1 and split.stride(1) % 8 == 0, what
    hi, mid, lo = terms(split)
    back = (hi + mid) + lo
    exact(back.view(torch.int32), w.view(torch.int32), what)
    exact(hi, w.to(torch.bfloat16).to(torch.float32), what)


def bf16x3_scheme(x_packed: torch.Tensor, w: torch.Tensor, t: int):
    """The kernel's arithmetic over the whole output (its tiles change no
    element's order), under the H100 model of a ``wgmma``."""
    planes = unpack_timesteps(x_packed, t)                     # (t, M, K)
    tt, m, k = planes.shape
    out = wgmma.kept_scheme(planes.reshape(tt * m, k), w, **wgmma.MODEL)
    return out.reshape(tt, m, -1)


def on_the_card(monkeypatch):
    """Plan as the card does: ``with_kmajor`` sees f32 kernels off the
    CPU (the split's build itself runs on the CPU tensors)."""
    monkeypatch.setattr(compile_module, "on_cpu", lambda *_: False)


def packed_inputs(t, m, k, seed):
    r = np.random.default_rng(seed)
    spikes = (r.random((t, m, k)) < 0.3).astype(np.uint8)
    g = -(-t // 8)
    pad = np.zeros((8 * g, m, k), np.uint8)
    pad[:t] = spikes
    return (pad.reshape(g, 8, m, k) << np.arange(8, dtype=np.uint8)[
        None, :, None, None]).sum(axis=1, dtype=np.uint8)   # (G, M, K)


def seeded_weights(kind: str, k: int, n: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    sign = np.where(r.random((k, n)) < 0.5, -1.0, 1.0)
    if kind == "normal":
        return r.standard_normal((k, n)).astype(np.float32)
    if kind == "uniform":
        return r.uniform(-1.0, 1.0, (k, n)).astype(np.float32)
    if kind == "small":        # 2^-110 .. 2^-100, every significand
        return (sign * np.exp2(r.uniform(-110, -100, (k, n)))).astype(
            np.float32)
    if kind == "huge":         # near 2^100
        return (sign * np.exp2(r.uniform(99, 100, (k, n)))).astype(
            np.float32)
    if kind == "zero":
        return np.zeros((k, n), np.float32)
    if kind == "integer":      # what int8 kernels cast to f32 hold
        return r.integers(-256, 257, (k, n)).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["normal", "uniform", "small", "huge",
                                  "zero", "integer"])
def test_split_is_exact(kind):
    """``hi + mid + lo == w`` bit for bit (each f32 significand, 24 bits,
    in three bf16 terms of 8); ``hi`` is the weight rounded to bf16. For
    integer weights of |w| <= 256, ``hi`` is the weight itself. K = 61
    pads each row to 64 elements."""
    w = torch.from_numpy(seeded_weights(kind, 61, 37, seed=len(kind)))
    split = bf16x3_weights(w)
    assert_exact_split(w, split, kind)
    if kind == "integer":
        assert not split[1:].any()
        exact(split[0].T.to(torch.float32), w)


def firing_tree(jcfg, seed=0):
    """The reference's f32 folded tree with gains that keep the residual
    stream firing."""
    def gain(path, layer):
        g = GAIN * (GAIN_RESIDUAL if path.endswith(("/wo", "/fc2")) else 1.0)
        return {**layer, "kernel": layer["kernel"] * g}

    return jmap_layers(jfold(jinit(jax.random.PRNGKey(seed), jcfg), jcfg),
                       gain)


@pytest.fixture(scope="module")
def reduced():
    jcfg, cfg = JConfig().scaled(), SpikformerConfig().scaled()
    jtree = firing_tree(jcfg)
    tree = from_reference(jax.tree_util.tree_map(np.asarray, jtree))
    return jcfg, cfg, jtree, tree


def test_plan_splits_exactly_its_f32_unpack_layers(reduced, monkeypatch):
    """Planned as on the card, the tree carries
    ``kernel_bf16x3`` on exactly the unpack-routed layers other than conv0,
    each the exact split of its kernel; the routes are those of the plan
    without it and of the JAX planner; ``strip_lut_annotations`` removes
    it; a plan compiled for the CPU carries none."""
    jcfg, cfg, jtree, tree = reduced
    _, plain_routes = plan_route_tables(tree, cfg, batch_size=4,
                                        max_table_bytes=SMALL_CAP)
    with monkeypatch.context() as card:
        on_the_card(card)
        annotated, routes = plan_route_tables(tree, cfg, batch_size=4,
                                              max_table_bytes=SMALL_CAP)
    jmodel = jcompile(jtree, jcfg, JPlan(batch_buckets=(4,),
                                         max_table_bytes=SMALL_CAP),
                      folded=True)
    assert routes == plain_routes == jmodel.plan.routes
    split_layers = []

    def check(path, layer):
        want = routes.get(path) == "unpack" and path != "scs/conv0"
        assert ("kernel_bf16x3" in layer) == want, path
        if want:
            split_layers.append(path)
            assert_exact_split(layer["kernel"], layer["kernel_bf16x3"], path)
        return layer

    map_folded_layers(annotated, check)
    assert "blocks/b0/mlp/fc1" in split_layers and len(split_layers) > 4
    stripped = strip_lut_annotations(annotated)
    map_folded_layers(stripped, lambda p, l: (
        l if "kernel_bf16x3" not in l and "lut" not in l
        else pytest.fail(p)))
    model = compile(tree, cfg, ExecutionPlan(backend="packed_cuda",
                                             batch_buckets=(4,),
                                             max_table_bytes=SMALL_CAP),
                    folded=True, device="cpu")
    assert model.plan.routes == routes
    map_folded_layers(model.folded, lambda p, l: (
        l if "kernel_bf16x3" not in l else pytest.fail(p)))


def test_planner_refuses_a_kernel_the_split_cannot_hold(reduced,
                                                        monkeypatch):
    """A weight of (1 + 2^-20) 2^-120 leaves its low bits, 2^-140, below
    bf16's smallest subnormal (2^-133): ``lo`` rounds to zero, the split
    is not exact, and the planner raises, naming the layer, rather than
    serve other sums. (2^-120 itself is one bf16 term.)"""
    _, cfg, _, tree = reduced
    path = "blocks/b1/ssa/wk"

    def tiny(p, layer):
        if p != path:
            return layer
        kernel = layer["kernel"].clone()
        kernel[3, 5] = TINY
        return {**layer, "kernel": kernel}

    bad = map_folded_layers(tree, tiny)
    with monkeypatch.context() as card:
        on_the_card(card)
        with pytest.raises(ValueError, match=path):
            plan_route_tables(bad, cfg, batch_size=4,
                              max_table_bytes=SMALL_CAP)
    with pytest.raises(ValueError, match="not the sum"):
        bf16x3_weights(torch.tensor([[TINY, 1.0]]))
    assert_exact_split(torch.tensor([[2.0 ** -120]]),
                       bf16x3_weights(torch.tensor([[2.0 ** -120]])))
    with pytest.raises(ValueError, match="float32"):
        bf16x3_weights(torch.zeros((4, 2), dtype=torch.float64))


def test_split_of_every_unpack_kernel_of_the_reduced_tree(reduced):
    """Every kernel the reduced default f32 plan could send to the unpack
    dot (all but conv0's) splits exactly."""
    _, _, _, tree = reduced
    seen = []

    def check(path, layer):
        if path != "scs/conv0":
            assert_exact_split(layer["kernel"], bf16x3_weights(
                layer["kernel"], name=path), path)
            seen.append(path)
        return layer

    map_folded_layers(tree, check)
    assert len(seen) == 3 + 6 * 2


# (t, M, K, N): ragged rows and columns, K off multiples of 16 and 64, the
# tail group of one plane at t = 9 and 17, and fc2 of the paper config at
# batch 8 (1568 rows, K 2048, N 512; one plane, since the emulation's 384
# slices a plane take seconds)
SCHEME_CASES = [(1, 37, 40, 19), (4, 21, 61, 13), (9, 130, 100, 70),
                (17, 33, 200, 129), (1, 1568, 2048, 512)]


@pytest.mark.parametrize("t,m,k,n", SCHEME_CASES)
@pytest.mark.parametrize("int_w", [True, False], ids=["int", "f32"])
def test_scheme_matches_pallas_grouped_kernel(t, m, k, n, int_w):
    """The emulation (the H100 model) against ``_spike_matmul_grouped`` in
    interpret mode:
    exact for integer-valued weights (|w| <= 256: hi == w, every partial
    sum an integer below 2^24, exact in any order); within atol 1e-4 +
    rtol 1e-5 for normal f32 weights. The wrapper's CPU branch (the plain
    f32 dot) takes the same inputs and launches nothing."""
    x = packed_inputs(t, m, k, seed=t + k)
    w = seeded_weights("integer" if int_w else "normal", k, n, seed=k + n)
    bm = 128 if m > 256 else 8
    want = np.asarray(jgrouped(jnp.asarray(x), jnp.asarray(w), bm=bm,
                               bn=128, bk=256, interpret=True))
    want = want.reshape(-1, m, n)[:t]
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = bf16x3_scheme(xt, wt, t)
    plain = spike_matmul_grouped(xt, wt, t=t)
    if int_w:
        exact(got, want)
        exact(plain, want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL,
                                   rtol=F32_RTOL)
        np.testing.assert_allclose(plain.numpy(), want, atol=F32_ATOL,
                                   rtol=F32_RTOL)
    assert ops.launch_counts()["unpack_dot"] == 0
    assert spike_matmul_grouped.split_builds == 0


def test_reduced_default_f32_plan_equals_reference_on_the_cpu(reduced):
    """The reference's default plan (``packed``, f32) at a table cap that
    sends every layer but conv0 to the unpack dot: on the CPU the port runs
    the reference's CPU branch, carries no split, and its logits equal the
    JAX package's (labels equal)."""
    jcfg, cfg, jtree, tree = reduced
    fields = dict(batch_buckets=(4,), max_table_bytes=SMALL_CAP)
    jmodel = jcompile(jtree, jcfg, JPlan(**fields), folded=True)
    model = compile(tree, cfg, ExecutionPlan(backend="packed", **fields),
                    folded=True, device="cpu")
    assert model.plan.routes == jmodel.plan.routes
    assert "unpack" in model.plan.routes.values()
    map_folded_layers(model.folded, lambda p, l: (
        l if "kernel_bf16x3" not in l else pytest.fail(p)))
    imgs = np.random.default_rng(7).integers(0, 256, (4, 32, 32, 3),
                                             dtype=np.uint8)
    want = np.asarray(jmodel.logits(jnp.asarray(imgs)))
    got = model.logits(imgs).numpy()
    assert np.abs(want).max() > 0, "the reference's logits are all zero"
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    exact(got.argmax(-1), want.argmax(-1))


def term_by_term(c, a, w, model):
    """``block_fma`` without its matmul path: every element's group of
    terms aligned and summed one by one."""
    r, n = c.shape
    c = c.double().reshape(-1)
    for g0 in range(0, a.shape[1], model["group"]):
        aa = a[:, g0:g0 + model["group"]].double()
        ww = w[g0:g0 + model["group"]].double()
        g = aa.shape[1]
        c = wgmma._aligned_sum(
            c, aa[:, None, :].expand(r, n, g).reshape(-1, g),
            ww.T[None].expand(r, n, g).reshape(-1, g),
            **{k: model[k] for k in ("bits", "align", "normalize")})
    return c.float().reshape(r, n)


@pytest.mark.parametrize("model", [
    wgmma.MODEL, dict(bits=24, group=8, align="rn", normalize="rn"),
    dict(bits=23, group=4, align="rz", normalize="rn")],
    ids=["h100", "b24-g8-rn", "b23-g4"])
def test_wgmma_model_matmul_path_equals_term_by_term(model):
    """The model's fast path (one f64 matmul where no term can hold a bit
    below the window) gives the term-by-term sum bit for bit: one slice
    from zero and from accumulators of several magnitudes over products of
    exponents 2^-40..2^0, and the kept scheme's lo/mid accumulator over
    fc2's K."""
    gen = torch.Generator().manual_seed(3)
    a, w = wgmma.fresh_inputs(gen, rows=24, cols=96)
    for scale in (None, 0.0, 2.0 ** -30, 2.0 ** -8, 1.0, 64.0):
        c = (torch.randn((24, 96), generator=gen) * (scale or 0.0)).float()
        got = wgmma.block_fma(None if scale is None else c, a.double(),
                              w.double(), **model)
        exact(got.view(torch.int32),
              term_by_term(c, a, w, model).view(torch.int32), str(scale))
    a, w = wgmma.fc2_inputs(gen, rows=8, cols=16, k=FC2_K)
    _, mid, lo = wgmma.split_terms(w)
    rest = want = torch.zeros((8, 16))
    for s0 in range(0, FC2_K, SLICE):
        aa = a[:, s0:s0 + SLICE].double()
        for term in (lo, mid):
            rest = wgmma.block_fma(rest, aa, term[s0:s0 + SLICE], **model)
            want = term_by_term(want, aa, term[s0:s0 + SLICE], model)
    exact(rest.view(torch.int32), want.view(torch.int32))


@pytest.fixture(scope="module")
def fc2_kernel():
    """fc2 of the paper config's gained tree, built as the reference
    builds it: lecun normal (2048, 512), its BN folded at init, times the
    gained tree's gain."""
    p = linear_init(jax.random.PRNGKey(0), FC2_K, FC2_N)
    kernel, _ = jfold_bn(p["kernel"], None, bn_init(FC2_N))
    return np.array(kernel * FC2_GAIN, np.float32)


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.3])
def test_single_accumulator_misses_where_the_kept_scheme_holds(fc2_kernel,
                                                               rate):
    """At fc2's shape (four planes of 25 rows at the firing rate) under
    the H100 model, each held to the f64 sum rounded once: the kept scheme
    (each slice's hi products from zero, added with round-to-nearest
    adds) sits closer to it than the Pallas kernel does, and one
    accumulator a 64-deep K step (lo, mid, hi of each slice into it, the
    design the card's logits gate refused) sits farther: its truncated
    adds reach the output's low bits. A plain f32 order is not enough to
    tell the two apart; this is."""
    t, m = 4, 25
    r = np.random.default_rng(int(rate * 10))
    spikes = (r.random((t, m, FC2_K)) < rate).astype(np.uint8)
    x = (spikes << np.arange(t, dtype=np.uint8)[:, None, None]).sum(
        0, dtype=np.uint8)[None]                              # (1, M, K)
    pallas = np.asarray(jgrouped(jnp.asarray(x), jnp.asarray(fc2_kernel),
                                 bm=8, bn=128, bk=256, interpret=True))
    planes = torch.from_numpy(spikes.reshape(t * m, FC2_K))
    w = torch.from_numpy(fc2_kernel)
    want = planes.double() @ w.double()

    def err(y):
        return float((torch.as_tensor(np.array(y)).reshape(t * m, -1)
                      .double() - want).abs().max())

    kept = wgmma.kept_scheme(planes, w, **wgmma.MODEL)
    single = wgmma.single_accumulator_scheme(planes, w, **wgmma.MODEL)
    e_pallas = err(pallas.reshape(-1, m, FC2_N)[:t])
    assert err(kept) <= e_pallas < err(single), (
        err(kept), e_pallas, err(single))
