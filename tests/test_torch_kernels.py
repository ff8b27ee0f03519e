"""The port's kernel modules against the JAX reference: the LUT primitives
and route chooser, the plain versions of the four CUDA kernels against the
Pallas kernels they replace (interpret mode, as the reference's own tests
run them) and against ``repro.kernels.ref``, and the ``ops`` entry points
against the reference's Pallas branch. Inputs come from seeded numpy and go
through both packages; every comparison is exact unless it states a
tolerance and its reason."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spike as jspike
from repro.kernels import lut_matmul as jlut
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.spike_matmul import _spike_matmul_grouped as jgrouped
from repro.kernels.spike_matmul import lut_gather_matmul as jgather
from repro.kernels.stdp_attention import stdp_attention as jstdp
from repro.kernels.tflif import tflif_fused as jtflif
from repro_torch.core import spike
from repro_torch.kernels import lut_matmul as lut
from repro_torch.kernels import ops, ref
from repro_torch.kernels.spike_matmul import (lut_gather_matmul,
                                              spike_matmul_grouped)
from repro_torch.kernels.stdp_attention import (STDP_F32_TOL,
                                                stdp_attention,
                                                stdp_attention_packed)
from repro_torch.kernels.tflif import tflif_fused, tflif_plain
from torch_threads import one_thread  # noqa: F401  (autouse)

# f32 weights through the unpack dot: the same products summed in another
# order. |sums| stay below ~20 at these shapes (ulp ~2e-6), so 1e-5 absolute
# plus 1e-6 relative covers a few roundings and nothing more.
F32_ATOL, F32_RTOL = 1e-5, 1e-6


def exact(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def t_(x):
    """numpy -> torch on the CPU, dtype kept."""
    return torch.from_numpy(np.array(x))


def packed_spikes(seed, t, *shape, rate=0.3):
    """(G, *shape) uint8 plane groups of a seeded T-step train."""
    r = np.random.default_rng(seed)
    s = (r.random((t, *shape)) < rate).astype(np.float32)
    return np.asarray(jspike.pack_timesteps(jnp.asarray(s)))


def weights(seed, k, n, *, int_w):
    r = np.random.default_rng(seed)
    if int_w:
        return r.integers(-127, 128, (k, n)).astype(np.int8)
    return r.normal(size=(k, n)).astype(np.float32)


# ---------------------------------------------------------------------------
# LUT primitives (bit-identical)
# ---------------------------------------------------------------------------

def test_bit_transpose8_matches_reference():
    """Every byte value, high bit included: the reference's wordwise form
    needs logical uint32 shifts, which torch's int32 lacks."""
    r = np.random.default_rng(0)
    b = r.integers(0, 256, (7, 5, 8), dtype=np.uint8)
    b[0, 0] = 0xFF
    b[0, 1] = 0x80
    got = lut.bit_transpose8(t_(b))
    exact(got, jlut.bit_transpose8(jnp.asarray(b)))
    exact(lut.bit_transpose8(got), b)          # an involution


@pytest.mark.parametrize("t", [1, 4, 9, 17])
@pytest.mark.parametrize("k", [13, 16])
def test_plane_indices_match_reference(t, k):
    x = packed_spikes(t * 10 + k, t, 3, 5, k)            # (G, 3, 5, K)
    got = lut.plane_indices(t_(x))
    assert got.dtype == torch.uint8
    exact(got, jlut.plane_indices(jnp.asarray(x)))
    # the SSSC use: value bytes as a single group
    img = np.random.default_rng(k).integers(0, 256, (1, 11, k), np.uint8)
    exact(lut.plane_indices(t_(img)), jlut.plane_indices(jnp.asarray(img)))


@pytest.mark.parametrize("int_w", [True, False], ids=["int16", "f32"])
@pytest.mark.parametrize("k", [13, 24])
def test_build_lut_matches_reference(int_w, k):
    w = weights(k, k, 9, int_w=int_w)
    got = lut.build_lut(t_(w))
    want = np.asarray(jlut.build_lut(jnp.asarray(w)))
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    exact(got, want)


@pytest.mark.parametrize("int_w", [True, False], ids=["int16", "f32"])
@pytest.mark.parametrize("t", [1, 4, 9, 17])
def test_lut_matmul_matches_reference(int_w, t):
    k, n = 21, 11                                  # K not a multiple of 8
    x = packed_spikes(t, t, 2, 7, k)
    w = weights(t + 1, k, n, int_w=int_w)
    idx = lut.plane_indices(t_(x))[:t]
    tbl = lut.build_lut(t_(w))
    want = jlut.lut_matmul(jnp.asarray(idx.numpy()),
                           jnp.asarray(tbl.numpy()))
    exact(lut.lut_matmul(idx, tbl), want)
    with pytest.raises(ValueError):
        lut.lut_matmul(idx[..., :-1], tbl)


def test_shift_sum_fold_matches_reference():
    per = np.random.default_rng(3).normal(size=(8, 6, 5)).astype(np.float32)
    exact(lut.shift_sum_fold(t_(per)), jlut.shift_sum_fold(jnp.asarray(per)))


def test_chunk_and_table_sizes_match_reference():
    for k in (1, 7, 8, 9, 512, 2048):
        assert lut.num_k_chunks(k) == jlut.num_k_chunks(k)
        for int_w in (True, False):
            assert (lut.table_bytes(k, 33, int_w)
                    == jlut.table_bytes(k, 33, int_w))
    assert lut.MAX_TABLE_BYTES == jlut.MAX_TABLE_BYTES
    assert lut.K_CHUNK == jlut.K_CHUNK
    with pytest.raises(ValueError):
        lut.num_k_chunks(0)


# ---------------------------------------------------------------------------
# Route choice
# ---------------------------------------------------------------------------

def test_route_constants_share_the_reference_key_set():
    want = jlut.RouteConstants().to_dict()
    assert lut.RouteConstants().to_dict() == want
    custom = dataclasses.replace(jlut.RouteConstants(), pallas_gather_cost=7.5,
                                 transpose_cost=0.25).to_dict()
    assert lut.RouteConstants.from_dict(custom).to_dict() == custom
    with pytest.raises(ValueError, match="unknown route-constant"):
        lut.RouteConstants.from_dict({**want, "bogus": 1.0})


# (m, k, n, g, t): the paper config's layers at batch 8 (conv0 SSSC with 8
# value planes, conv1-3, SSA, fc1, fc2), the reduced config, and tails
ROUTE_SHAPES = [
    (8 * 112 * 112, 12, 64, 1, 8), (8 * 56 * 56, 256, 128, 1, 4),
    (8 * 28 * 28, 512, 256, 1, 4), (8 * 14 * 14, 1024, 512, 1, 4),
    (8 * 196, 512, 512, 1, 4), (8 * 196, 512, 2048, 1, 4),
    (8 * 196, 2048, 512, 1, 4), (4 * 4, 64, 256, 1, 4), (3, 9, 5, 2, 9),
    (1, 1, 1, 1, 1), (64, 33, 12, 3, 17),
]


@pytest.mark.parametrize("m,k,n,g,t", ROUTE_SHAPES)
def test_choose_cuda_route_equals_choose_pallas_route(m, k, n, g, t):
    fitted = {"pallas_gather_cost": 0.5, "transpose_cost": 9.0}
    for int_w in (True, False):
        for cap in (lut.MAX_TABLE_BYTES, 1 << 18):
            for extra in ({}, fitted):
                kw = dict(m=m, k=k, n=n, g=g, t=t, weights_are_int=int_w,
                          max_table_bytes=cap)
                got = lut.choose_cuda_route(
                    **kw, constants=lut.RouteConstants(**extra))
                want = jlut.choose_pallas_route(
                    **kw, constants=jlut.RouteConstants(**extra))
                assert got == want, (kw, extra)


def test_resolve_route_cuda_follows_the_pallas_contract():
    tbl = lut.build_lut(t_(weights(0, 16, 4, int_w=True)))
    jtbl = jnp.asarray(tbl.numpy())
    shape = dict(m=8 * 196, k=512, n=512, g=1, t=4, weights_are_int=True)
    for route in (None, "auto", "lut", "lut_sparse", "unpack"):
        for have in (True, False):
            got = ops._resolve_route_cuda(route, tbl if have else None,
                                          **shape)
            want = jops._resolve_route_pallas(route, jtbl if have else None,
                                              **shape)
            assert got == want, (route, have)
    # a planner flag is not a table
    assert ops._resolve_route_cuda(None, True, **shape) == "unpack"
    with pytest.raises(ValueError, match="unknown packed-matmul route"):
        ops._resolve_route_cuda("dense", None, **shape)


# ---------------------------------------------------------------------------
# The four kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 8, 9, 17])
def test_tflif_matches_pallas_kernel(t):
    """M = 1100 is not a multiple of the reference's 1024-neuron block nor
    of the CUDA kernel's 256-thread block; v_th is a per-neuron vector (the
    int8 scale fold)."""
    r = np.random.default_rng(t)
    m = 1100
    x = (r.normal(size=(t, m)) * 1.5).astype(np.float32)
    bias = (r.normal(size=m) * 0.2).astype(np.float32)
    vth = (0.5 + r.random(m)).astype(np.float32)
    want = np.asarray(jtflif(jnp.asarray(x), jnp.asarray(bias),
                             v_th=jnp.asarray(vth), interpret=True))
    got = tflif_fused(t_(x), t_(bias), t_(vth))
    assert got.dtype == torch.uint8 and got.shape == (-(-t // 8), m)
    exact(got, want)
    exact(got, jref.tflif_ref(jnp.asarray(x), jnp.asarray(bias),
                              v_th=jnp.asarray(vth)))
    assert 0 < spike.packed_occupancy(got, t) < 1


def test_tflif_period_vectors_match_full_vectors():
    """Per-channel bias/v_th over a channels-last layout (what the int8
    fold passes) equal the reference given the broadcast (M,) vectors."""
    r = np.random.default_rng(11)
    t, rows, ch = 9, 5, 12
    x = (r.normal(size=(t, rows * ch)) * 1.5).astype(np.float32)
    bias = (r.normal(size=ch) * 0.2).astype(np.float32)
    vth = (0.5 + r.random(ch)).astype(np.float32)
    want = jtflif(jnp.asarray(x), jnp.asarray(np.tile(bias, rows)),
                  v_th=jnp.asarray(np.tile(vth, rows)), interpret=True)
    exact(tflif_fused(t_(x), t_(bias), t_(vth)), want)
    scalar = jtflif(jnp.asarray(x), None, v_th=1.0, interpret=True)
    exact(tflif_fused(t_(x), torch.zeros(1), torch.ones(1)), scalar)
    with pytest.raises(ValueError, match="does not tile"):
        tflif_fused(t_(x), torch.zeros(7), torch.ones(1))


@pytest.mark.parametrize("int_w", [True, False], ids=["int16", "f32"])
def test_lut_gather_matches_pallas_kernel(int_w):
    """Ragged M, N and C against small Pallas blocks, so the reference's
    padding and the port's masking both engage."""
    t, m, k, n = 4, 37, 100, 19
    x = packed_spikes(5, t, m, k, rate=0.2)
    w = weights(6, k, n, int_w=int_w)
    idx = lut.plane_indices(t_(x))[:t].contiguous()          # (4, 37, 13)
    tbl = lut.build_lut(t_(w))
    want = jgather(jnp.asarray(idx.numpy()), jnp.asarray(tbl.numpy()),
                   bm=16, bn=8, bc=4, interpret=True)
    got = lut_gather_matmul(idx, tbl)
    assert got.dtype == torch.float32 and got.shape == (t, m, n)
    exact(got, want)
    exact(got, jlut.lut_matmul_pallas(jnp.asarray(idx.numpy()),
                                      jnp.asarray(tbl.numpy())))


@pytest.mark.parametrize("t", [1, 4, 9])
def test_unpack_dot_matches_pallas_kernel(t):
    """Integer-valued weights (the int8 path): exact. f32 weights: the
    stated tolerance. The port writes only the t live planes, which is all
    the reference's ``ops.spike_linear`` keeps of its (G, 8, M, N)."""
    m, k, n = 21, 40, 13
    x = packed_spikes(t + 20, t, m, k)
    for int_w in (True, False):
        w = weights(t + 21, k, n, int_w=int_w).astype(np.float32)
        full = jgrouped(jnp.asarray(x), jnp.asarray(w), bm=8, bn=8, bk=16,
                        interpret=True)
        want = np.asarray(full).reshape(-1, m, n)[:t]
        got = spike_matmul_grouped(t_(x), t_(w), t=t)
        assert got.shape == (t, m, n)
        if int_w:
            exact(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL,
                                       rtol=F32_RTOL)
        # the plain version is the reference's unpack route: one dot
        planes = jspike.unpack_timesteps(jnp.asarray(x), t)
        one_dot = (planes.reshape(t * m, k) @ jnp.asarray(w)).reshape(t, m, n)
        plain = ref.spike_matmul_ref(t_(x), t_(w), t=t)
        if int_w:
            exact(plain, one_dot)
        else:
            np.testing.assert_allclose(plain.numpy(), one_dot, atol=F32_ATOL,
                                       rtol=F32_RTOL)
    with pytest.raises(ValueError, match="plane groups"):
        spike_matmul_grouped(t_(x), t_(w), t=t + 8)


@pytest.mark.parametrize("bh,dh", [(3, 16), (2, 64)])
def test_stdp_matches_pallas_kernel(bh, dh):
    """N = 196 (the paper config's tokens): the reference pads to 256 at
    its default bq = bkv = 128 and is exact there; every sum is an integer
    and the scale a power of two, so the port is exact too."""
    r = np.random.default_rng(bh * dh)
    n = 196
    q, k, v = ((r.random((bh, n, dh)) < 0.2).astype(np.float32)
               for _ in range(3))
    want = jstdp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.125,
                 interpret=True)
    got = stdp_attention(t_(q), t_(k), t_(v), scale=0.125)
    exact(got, want)
    exact(got, jref.stdp_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), scale=0.125))
    assert float(got.abs().max()) > 0


@pytest.mark.parametrize("bh,dh", [(3, 16), (2, 64)])
def test_stdp_real_values_match_pallas_kernel(bh, dh):
    """Real-valued operands at N = 196 and the reference's default tiles
    (bq = bkv = 128, where no KV row is dropped), against the Pallas kernel
    in interpret mode and ``repro.kernels.ref``: within ``STDP_F32_TOL``
    times (|Q| |K|^T) |V| * scale, which bounds any f32 order of the two
    sums (the split-TF32 kernel is held to the same on the card)."""
    r = np.random.default_rng(bh * dh + 1)
    q, k, v = (r.normal(size=(bh, 196, dh)).astype(np.float32)
               for _ in range(3))
    got = stdp_attention(t_(q), t_(k), t_(v), scale=0.125)
    bound = STDP_F32_TOL * ref.stdp_attention_ref(
        t_(np.abs(q)), t_(np.abs(k)), t_(np.abs(v)), scale=0.125)
    for want in (jstdp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       scale=0.125, interpret=True),
                 jref.stdp_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), scale=0.125)):
        assert bool(((got - t_(want)).abs() <= bound).all())
    assert float(got.abs().max()) > 0


def test_stdp_has_no_kv_drop_at_unequal_tiles():
    """The reference kernel drops KV rows when bq != bkv (N=100, bq=128,
    bkv=64); the port's plain version and kernel walk every KV row."""
    r = np.random.default_rng(100)
    q, k, v = ((r.random((2, 100, 8)) < 0.3).astype(np.float32)
               for _ in range(3))
    oracle = np.asarray(jref.stdp_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.125))
    faulty = np.asarray(jstdp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              scale=0.125, bq=128, bkv=64, interpret=True))
    assert np.abs(faulty - oracle).max() > 0         # the reference fault
    exact(stdp_attention(t_(q), t_(k), t_(v), scale=0.125), oracle)


# ---------------------------------------------------------------------------
# ops entry points against the reference's Pallas branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route,int_w", [("lut", True), ("lut", False),
                                         ("unpack", True),
                                         ("lut_sparse", True)])
def test_spike_linear_matches_pallas_branch(route, int_w):
    t, k, n = 4, 20, 6
    x = packed_spikes(7, t, 2, 5, k)                    # (1, 2, 5, K)
    w = weights(8, k, n, int_w=int_w)
    bias = np.random.default_rng(9).normal(size=n).astype(np.float32)
    tbl = None if route == "unpack" else lut.build_lut(t_(w))
    want = jops.spike_linear(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), t=t, pallas=True,
        route=route, table=None if tbl is None else jnp.asarray(tbl.numpy()))
    got = ops.spike_linear(t_(x), t_(w), t_(bias), t=t, route=route,
                           table=tbl)
    assert got.shape == (t, 2, 5, n)
    exact(got, want)
    exact(ops.spike_linear(t_(x), t_(w), t_(bias), t=t, route=route,
                           table=tbl, plain=True), got)


@pytest.mark.parametrize("route", ["lut", "unpack"])
def test_sssc_linear_matches_pallas_branch(route):
    """Integer weights: exact on both routes (the unpack route is the
    shift-sum kernel on both sides, summed in other orders; every sum is
    an integer)."""
    r = np.random.default_rng(12)
    img = r.integers(0, 256, (2, 3, 4, 12), dtype=np.uint8)
    w = weights(13, 12, 8, int_w=True)
    tbl = lut.build_lut(t_(w)) if route == "lut" else None
    want = jops.sssc_linear(
        jnp.asarray(img), jnp.asarray(w), None, pallas=True, route=route,
        table=None if tbl is None else jnp.asarray(tbl.numpy()))
    exact(ops.sssc_linear(t_(img), t_(w), None, route=route, table=tbl), want)


@pytest.mark.parametrize("t", [4, 9])
def test_tflif_pack_matches_pallas_branch(t):
    r = np.random.default_rng(t)
    acc = (r.normal(size=(t, 2, 3, 10)) * 1.5).astype(np.float32)
    bias = (r.normal(size=10) * 0.3).astype(np.float32)
    scale = (0.5 + r.random(10)).astype(np.float32)
    jb, jv = jnp.asarray(bias) / jnp.asarray(scale), 1.0 / jnp.asarray(scale)
    want = jops.tflif_pack(jnp.asarray(acc), jb, v_th=jv, pallas=True)
    got = ops.tflif_pack(t_(acc), t_(bias) / t_(scale),
                         v_th=1.0 / t_(scale))
    exact(got, want)
    exact(ops.tflif_pack(t_(acc)), jops.tflif_pack(jnp.asarray(acc),
                                                   pallas=True))
    exact(ops.tflif_pack(t_(acc), t=2), jops.tflif_pack(jnp.asarray(acc),
                                                        t=2, pallas=True))


@pytest.mark.parametrize("t", [4, 9])
def test_stdp_attention_packed_matches_pallas_branch(t):
    qkv = [packed_spikes(30 + i, t, 2, 3, 13, 8) for i in range(3)]
    want = jops.stdp_attention_packed(*map(jnp.asarray, qkv), t=t,
                                      scale=0.125, pallas=True)
    got = ops.stdp_attention_packed(*map(t_, qkv), t=t, scale=0.125)
    assert got.shape == (t, 2, 3, 13, 8)
    exact(got, want)


@pytest.mark.parametrize("t", [1, 4, 9, 17])
@pytest.mark.parametrize("n,dh", [(1, 7), (1, 64), (1, 128), (65, 7),
                                  (65, 64), (65, 128), (196, 7), (196, 64),
                                  (196, 128)])
def test_stdp_packed_entry_matches_reference_exactly(t, n, dh):
    """The packed STDP entry on CPU operands (its plain version) against
    the reference's ``ops.stdp_attention_packed`` on its CPU route, bit
    for bit; the operands are the backend's layout, a permuted (G, B, H,
    N, Dh) view of (G, B, N, H * Dh)."""
    x = packed_spikes(t * 1000 + n + dh, t, 2, n, 2 * dh)   # (G, 2, N, 2Dh)
    qkv = [x, np.roll(x, 1, axis=2), np.roll(x, 3, axis=3)]
    views = [z.reshape(-1, 2, n, 2, dh).transpose(0, 1, 3, 2, 4)
             for z in qkv]
    want = jops.stdp_attention_packed(*map(jnp.asarray, views), t=t,
                                      scale=0.125)
    got = stdp_attention_packed(*(t_(z).reshape(-1, 2, n, 2, dh).permute(
        0, 1, 3, 2, 4) for z in qkv), t=t, scale=0.125)
    assert got.shape == (t, 2, 2, n, dh)
    exact(got, want)
    assert float(got.abs().max()) > 0


@pytest.mark.parametrize("case", ["n_dh", "dh", "devices", "groups",
                                  "dtype"])
def test_stdp_packed_wrapper_refuses_what_is_not_exact(case):
    """N * Dh >= 2^24 or Dh > 2048 would leave exact fp16 scores or f32
    sums; operands on two devices have no kernel; the group count must
    hold t planes; operands are uint8."""
    z = torch.zeros((1, 2, 8, 16), dtype=torch.uint8)
    q = k = v = z
    if case == "n_dh":
        q = k = v = torch.zeros((1, 1, 2 ** 14, 2 ** 10),
                                dtype=torch.uint8).expand(1, 1, 2 ** 14,
                                                          2 ** 10)
    elif case == "dh":
        q = k = v = torch.zeros((1, 1, 2, 2049), dtype=torch.uint8)
    elif case == "devices":
        k = torch.empty(z.shape, dtype=torch.uint8, device="meta")
    elif case == "groups":
        q = k = v = torch.zeros((2, 2, 8, 16), dtype=torch.uint8)
    else:
        q = z.to(torch.float32)
    match = {"n_dh": "exact only", "dh": "exact only",
             "devices": "several devices", "groups": "plane groups",
             "dtype": "uint8"}[case]
    with pytest.raises(ValueError, match=match):
        stdp_attention_packed(q, k, v, t=4, scale=0.125)


# ---------------------------------------------------------------------------
# wrapper hygiene
# ---------------------------------------------------------------------------

def test_cpu_operands_run_plain_versions_and_count_no_launch():
    ops.reset_launch_counts()
    t = 4
    x = t_(packed_spikes(40, t, 9, 16))
    w = t_(weights(41, 16, 5, int_w=True))
    ops.spike_linear(x, w, t=t, route="lut")
    ops.spike_linear(x, w, t=t, route="unpack")
    ops.tflif_pack(torch.ones(t, 9, 5))
    ops.stdp_attention_packed(x[:, None], x[:, None], x[:, None], t=t,
                              scale=0.125)
    ops.tflif_lut(torch.ones(t, 9, 16), table=lut.build_lut(w))
    ops.sssc_linear(x[0], w, route="unpack")
    ops.spike_matmul(x[0], w, mode="per_plane")
    qkv = torch.ones(2, 9, 32)
    ops.flash_attention(qkv, qkv, qkv, scale=0.125)
    names = {"tflif", "lut_gather", "unpack_dot", "unpack_dot_s8", "stdp",
             "stdp_packed", "fused_lif_lut", "shift_sum",
             "flash_attention_tc", "flash_attention_f32"}
    assert ops.launch_counts() == dict.fromkeys(names, 0)
    assert set(ops.KERNELS) == names


def test_wrappers_check_dtype_rank_contiguity_and_device():
    idx = torch.zeros((2, 3, 4), dtype=torch.uint8)
    tbl = torch.zeros((4, 256, 5), dtype=torch.int16)
    with pytest.raises(ValueError, match="idx must be"):
        lut_gather_matmul(idx.to(torch.int32), tbl)
    with pytest.raises(ValueError, match="table must be"):
        lut_gather_matmul(idx, tbl.to(torch.int32))
    with pytest.raises(ValueError, match="do not match"):
        lut_gather_matmul(idx[..., :3].contiguous(), tbl)
    with pytest.raises(ValueError, match="contiguous"):
        lut_gather_matmul(idx.transpose(0, 1), tbl)
    x = torch.zeros((1, 3, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="w must be"):
        spike_matmul_grouped(x, torch.zeros((8, 2), dtype=torch.float64), t=4)
    with pytest.raises(ValueError, match="disagree on K"):
        spike_matmul_grouped(x, torch.zeros((7, 2)), t=4)
    q = torch.zeros((2, 5, 4))
    with pytest.raises(ValueError, match="does not match q"):
        stdp_attention(q, q, torch.zeros((2, 5, 3)), scale=1.0)
    with pytest.raises(ValueError, match="x must be"):
        tflif_fused(torch.zeros(4, 6, 2), torch.zeros(1), torch.ones(1))
    # a tensor on neither the CPU nor a card has no kernel and no plain
    # fallback: the wrapper refuses it
    meta = torch.empty((4, 6), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tflif_fused(meta, torch.zeros(1, device="meta"),
                    torch.ones(1, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        tflif_fused(torch.zeros(4, 6), torch.zeros(1, device="meta"),
                    torch.ones(1))


def test_tflif_plain_equals_reference_op_order():
    """``tflif_plain`` over period vectors equals ``ref.tflif_ref`` over
    the same values broadcast per neuron."""
    r = np.random.default_rng(50)
    x = t_((r.normal(size=(5, 24)) * 2).astype(np.float32))
    b = t_(r.normal(size=6).astype(np.float32))
    v = t_((0.5 + r.random(6)).astype(np.float32))
    exact(tflif_plain(x, b, v), ref.tflif_ref(x, b.repeat(4), v_th=v.repeat(4)))
