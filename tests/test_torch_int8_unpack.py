"""The int8 unpack route of the port (kernel 3 on the int8 tensor cores,
``csrc/unpack_dot_s8.cu``) against the JAX reference.

The kernel runs only on the card, so here a plain emulation of its scheme
(spikes as u8 {0, 1} rows, the planes of a group stacked as extra rows of
A, the K-major int8 copy of the weights, int32 sums over 128-byte K steps,
one f32 conversion) is held bit for bit to the Pallas kernel it replaces,
``_spike_matmul_grouped`` in interpret mode, and to the wrapper's plain
version. Then the plans: the int8 default plan and the int8
``route="unpack"`` plan carry the K-major copy on exactly their unpack
layers, their routes stay the reference's, and their spikes and rates stay
exact against JAX ``packed_pallas``. Inputs come from seeded numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spike as jspike
from repro.core.spikformer import SpikformerConfig as JConfig
from repro.core.spikformer import fold_inference_params as jfold
from repro.core.spikformer import init as jinit
from repro.infer import ExecutionPlan as JPlan
from repro.infer import compile as jcompile
from repro.infer.compile import lower as jlower
from repro.infer.quant import map_folded_layers as jmap_layers
from repro.infer.quant import quantize_folded as jquantize
from repro.kernels.spike_matmul import _spike_matmul_grouped as jgrouped
from repro_torch.core.spike import unpack_timesteps
from repro_torch.core.spikformer import SpikformerConfig
from repro_torch.infer import ExecutionPlan, compile
from repro_torch.infer.compile import lower
from repro_torch.infer.quant import map_folded_layers
from repro_torch.kernels import ops, ref
from repro_torch.kernels.spike_matmul import (MAX_S8_K, kmajor_weights,
                                              spike_matmul_grouped_s8)
from repro_torch.weights import from_reference
from torch_threads import one_thread  # noqa: F401  (autouse)

# the kernel's tile: 128 A-rows (planes x rows), 128 columns, 128-byte K
BM = BN = BK = 128
GAIN, GAIN_RESIDUAL = 4.0, 0.7        # kernel gains; wo/fc2 get both
# the head dot ``rate @ head`` is a float reduction outside the packed
# datapath, summed in another order by XLA and torch: rates are exact,
# logits agree to a few ulp
LOGIT_ATOL, LOGIT_RTOL = 1e-5, 1e-5


def exact(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def s8_scheme(x_packed: torch.Tensor, w_kmajor: torch.Tensor, t: int):
    """The kernel's arithmetic, tile by tile: per plane group g with np
    live planes, a block covers rb = 128 // np rows of x and A-row
    ``p * rb + r`` holds bit p of row r as u8 {0, 1}; the K-major copy is
    read in 128-byte K steps (zero past K), products summed in int32; the
    epilogue converts to f32 and scatters A-row a to plane ``8g + a // rb``,
    row ``r0 + a % rb``."""
    g_n, m, k = x_packed.shape
    n = w_kmajor.shape[0]
    kp = -(-k // BK) * BK
    wk = torch.zeros((n, kp), dtype=torch.int32)
    wk[:, :k] = w_kmajor.to(torch.int32)
    out = torch.full((t, m, n), float("nan"))
    for g in range(g_n):
        np_ = min(8, t - 8 * g)
        rb = BM // np_
        for r0 in range(0, m, rb):
            a = torch.zeros((BM, kp), dtype=torch.int32)
            rows = x_packed[g, r0:r0 + rb].to(torch.int32)
            for p in range(np_):
                a[p * rb:p * rb + rows.shape[0], :k] = (rows >> p) & 1
            for c0 in range(0, n, BN):
                acc = torch.zeros((BM, min(BN, n - c0)), dtype=torch.int32)
                for k0 in range(0, kp, BK):
                    acc += a[:, k0:k0 + BK] @ wk[c0:c0 + BN, k0:k0 + BK].T
                for ai in range(np_ * rb):
                    p, row = ai // rb, r0 + ai % rb
                    if row < m:
                        out[8 * g + p, row, c0:c0 + BN] = acc[ai].to(
                            torch.float32)
    return out


def inputs(t, m, k, n, seed):
    r = np.random.default_rng(seed)
    spikes = (r.random((t, m, k)) < 0.3).astype(np.uint8)
    g = -(-t // 8)
    pad = np.zeros((8 * g, m, k), np.uint8)
    pad[:t] = spikes
    x = (pad.reshape(g, 8, m, k) << np.arange(8, dtype=np.uint8)[None, :,
                                                                  None, None]
         ).sum(axis=1, dtype=np.uint8)                  # (G, M, K) packed
    w = r.integers(-127, 128, (k, n)).astype(np.int8)
    return x, w, spikes


@pytest.mark.parametrize("k", [40, 61, 2048])
@pytest.mark.parametrize("t", [1, 4, 9, 17])
def test_s8_scheme_matches_pallas_grouped_kernel(t, k):
    """Bit for bit against ``_spike_matmul_grouped`` in interpret mode with
    the int-valued f32 weights (what the reference's backend casts int8 to):
    every int32 sum is an integer below 2^24, so its f32 conversion is the
    sum the f32 kernel forms in any order. K = 61 is not a multiple of 8,
    16 or 32; K = 2048 spans 16 K steps; T = 9 and 17 end in a tail group
    of one plane (rb = 128 rows)."""
    m, n = 37, 19
    x, w, spikes = inputs(t, m, k, n, seed=t * k)
    want = np.asarray(jgrouped(jnp.asarray(x), jnp.asarray(w, jnp.float32),
                               bm=128, bn=128, bk=256, interpret=True))
    want = want.reshape(-1, m, n)[:t]
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    wk = kmajor_weights(wt)
    assert torch.equal(wk, wt.T) and wk.stride() == (-(-k // 16) * 16, 1)
    got = s8_scheme(xt, wk, t)
    exact(got, want)
    exact(unpack_timesteps(xt, t), spikes)
    exact(spike_matmul_grouped_s8(xt, wk, t=t), want)
    assert ops.launch_counts()["unpack_dot_s8"] == 0


@pytest.mark.parametrize("t", [4, 9])
def test_int8_layer_past_the_s8_range_runs_in_f32(t):
    """An int8 unpack layer with K >= MAX_S8_K, where int8 sums may leave
    the range in which the s8 kernel is exact, goes to the f32 grouped
    unpack dot (on the CPU its plain version) instead of raising, as the
    reference computes every unpack layer in f32: the result equals
    ``spike_matmul_ref`` on the f32 cast. The s8 wrapper keeps its own
    refusal."""
    r = np.random.default_rng(t)
    k = MAX_S8_K
    spikes = (r.random((t, 2, k)) < 0.3).astype(np.uint8)
    x = torch.from_numpy(np.asarray(jax.device_get(jspike.pack_timesteps(
        jnp.asarray(spikes)))).copy())
    w = torch.from_numpy(r.integers(-127, 128, (k, 3)).astype(np.int8))
    ops.reset_launch_counts()
    got = ops.spike_linear(x, w, t=t, route="unpack")
    assert got.shape == (t, 2, 3)
    exact(got, ref.spike_matmul_ref(x, w.to(torch.float32), t=t))
    exact(ops.spike_linear(x, w, t=t, route="unpack", plain=True), got)
    assert ops.launch_counts()["unpack_dot_s8"] == 0


def test_s8_wrapper_refuses_what_is_not_exact_or_not_int8():
    """f32 weights take the f32 kernel, never this one; K stays below
    132,104, where 127 K < 2^24 keeps every sum exact; the K-major copy
    must match x's K and the groups must hold t planes."""
    x = torch.zeros((1, 3, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="int8"):
        spike_matmul_grouped_s8(x, torch.zeros((4, 16)), t=4)
    with pytest.raises(ValueError, match="int8"):
        kmajor_weights(torch.zeros((16, 4)))
    big = torch.zeros((1, 1, MAX_S8_K), dtype=torch.uint8)
    with pytest.raises(ValueError, match="exact only"):
        spike_matmul_grouped_s8(big, torch.zeros((1, MAX_S8_K),
                                                 dtype=torch.int8), t=4)
    assert 127 * (MAX_S8_K - 1) < 2 ** 24       # every sum exact below it
    with pytest.raises(ValueError, match="disagree on K"):
        spike_matmul_grouped_s8(x, torch.zeros((4, 15), dtype=torch.int8),
                                t=4)
    with pytest.raises(ValueError, match="plane groups"):
        spike_matmul_grouped_s8(x, torch.zeros((4, 16), dtype=torch.int8),
                                t=9)


def test_spike_linear_sends_int8_and_f32_weights_to_their_kernels(
        monkeypatch):
    """``ops.spike_linear`` on the unpack route: int8 weights reach the s8
    wrapper (over the K-major copy when given, one built when not), f32
    weights the f32 one; all equal the reference's Pallas branch."""
    t, m, k, n = 4, 10, 40, 6
    x, w, _ = inputs(t, m, k, n, seed=5)
    want = np.asarray(jgrouped(jnp.asarray(x), jnp.asarray(w, jnp.float32),
                               bm=128, bn=128, bk=256,
                               interpret=True)).reshape(-1, m, n)[:t]
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    calls = []
    for name in ("unpack", "unpack_s8"):
        def counted(*a, _fn=getattr(ops._WRAPPERS, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(ops._WRAPPERS, name, counted)
    exact(ops.spike_linear(xt, wt, t=t, route="unpack",
                           w_kmajor=kmajor_weights(wt)), want)
    exact(ops.spike_linear(xt, wt, t=t, route="unpack"), want)
    exact(ops.spike_linear(xt, wt.to(torch.float32), t=t, route="unpack"),
          want)
    assert calls == ["unpack_s8", "unpack_s8", "unpack"]


def firing_tree(jcfg, seed=0):
    """The reference's int8 folded tree with gains that keep the residual
    stream firing."""
    folded = jfold(jinit(jax.random.PRNGKey(seed), jcfg), jcfg)

    def gain(path, layer):
        g = GAIN * (GAIN_RESIDUAL if path.endswith(("/wo", "/fc2")) else 1.0)
        return {**layer, "kernel": layer["kernel"] * g}

    return jquantize(jmap_layers(folded, gain))


class Tap:
    """A backend with its per-layer packed outputs and rates recorded."""

    def __init__(self, inner):
        self.inner, self.rows = inner, []

    def __getattr__(self, name):
        fn = getattr(self.inner, name)
        if name == "mlp_pair_lif" or not callable(fn):
            raise AttributeError(name)   # both packages run the MLP unfused

        def rec(*a, **kw):
            out = fn(*a, **kw)
            if name not in ("to_tokens",):
                self.rows.append((name, np.asarray(out)))
            return out
        return rec


@pytest.mark.parametrize("fields", [{"max_table_bytes": 1 << 18},
                                    {"route": "unpack"}],
                         ids=["default-plan", "route-unpack"])
def test_int8_plans_carry_kmajor_copies_on_their_unpack_layers(fields):
    """The K-major leaf sits on exactly the int8 unpack layers (conv0's SSSC
    runs the shift-sum dot in f32 and gets none), equals ``kernel.T`` with
    rows 16 bytes apart, and moves no route: ``plan.routes`` equals the JAX
    plan's and replays to the same tree. Every layer's packed spikes and
    the rates equal JAX ``packed_pallas`` (interpret mode) bit for bit."""
    jcfg, cfg = JConfig().scaled(), SpikformerConfig().scaled()
    jtree = firing_tree(jcfg)
    jmodel = jcompile(jtree, jcfg, JPlan(
        backend="packed_pallas", weight_dtype="int8", batch_buckets=(4,),
        backend_options={"interpret": True}, **fields), folded=True)
    plan = ExecutionPlan(backend="packed_cuda", weight_dtype="int8",
                         batch_buckets=(4,), **fields)
    tree = from_reference(jax.tree_util.tree_map(np.asarray, jtree))
    model = compile(tree, cfg, plan, folded=True, device="cpu")
    assert model.plan.routes == jmodel.plan.routes
    unpack_layers = []

    def check(path, layer):
        unpack = "lut" not in layer and path != "scs/conv0"
        assert ("kernel_kmajor" in layer) == unpack, path
        if unpack:
            unpack_layers.append(path)
            kt = layer["kernel_kmajor"]
            assert torch.equal(kt, layer["kernel"].T), path
            assert kt.dtype == torch.int8 and kt.stride(0) % 16 == 0, path
        return layer

    map_folded_layers(model.folded, check)
    assert unpack_layers, "the plan has no int8 unpack layer"
    again = compile(model.folded, cfg, model.plan, folded=True, device="cpu")
    assert again.plan.routes == model.plan.routes

    imgs = np.random.default_rng(3).integers(0, 256, (4, 32, 32, 3),
                                             dtype=np.uint8)
    jtap, tap = Tap(jmodel.backend), Tap(model.backend)
    jlogits = jlower(jmodel.folded, jcfg, jtap, jit=False)(
        jmodel.folded, jnp.asarray(imgs))
    logits = lower(model.folded, cfg, tap, jit=False)(
        model.folded, torch.from_numpy(imgs))
    assert [n for n, _ in tap.rows] == [n for n, _ in jtap.rows]
    for i, ((n, got), (_, want)) in enumerate(zip(tap.rows, jtap.rows)):
        exact(got, want, f"layer {i} ({n})")
    assert np.abs(np.asarray(logits)).max() > 0, "all logits are zero"
    np.testing.assert_allclose(np.asarray(logits), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    exact(again.step(torch.from_numpy(imgs)), logits)
