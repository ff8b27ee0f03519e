"""The port's fused fc1 -> LIF -> fc2 step (kernel 5) and 2-D
``spike_matmul`` (kernel 6) against the JAX reference: their plain
versions, which the CPU runs, against the Pallas kernels they replace in
interpret mode, and the ``ops`` entry points that reach them against the
reference's Pallas branch. Inputs come from seeded numpy and go through
both packages; every comparison is exact unless it states a tolerance and
its reason."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lut_matmul as jlut
from repro.kernels import ops as jops
from repro.kernels.fused import tflif_lut_matmul as jfused
from repro.kernels.spike_matmul import spike_matmul as jspike_matmul
from repro_torch.infer.backends import PackedBackend
from repro_torch.kernels import fused
from repro_torch.kernels import lut_matmul as lut
from repro_torch.kernels import ops
from repro_torch.kernels.fused import tflif_lut_matmul, tflif_lut_plain
from repro_torch.kernels.spike_matmul import shift_sum_matmul, spike_matmul
from torch_threads import one_thread  # noqa: F401  (autouse)

# f32 weights, K <= 64. per_plane: each plane's dot of 0-or-w terms, summed
# in XLA's and torch's own orders; |sums| stay below ~10 (ulp ~1e-6), so
# atol 1e-5 covers a few roundings. shift_sum: the reference's one dot over
# byte values against the plain version's per-plane dots scaled by 2^p;
# each plane's rounding error is scaled by up to 2^7, so the absolute error
# is about 8 planes x 2^7 x ulp(8) ~ 1e-3 whatever the result's size (5.5e-4
# measured): atol 1e-3 + rtol 1e-5, the tolerance the card's check holds
# the kernel to, and the reference's own shift_sum tests' atol.
F32_TOL = {"per_plane": (1e-5, 1e-6), "shift_sum": (1e-3, 1e-5)}


def exact(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def t_(x):
    """numpy -> torch on the CPU, dtype kept."""
    return torch.from_numpy(np.array(x))


def weights(seed, k, n, *, int_w):
    r = np.random.default_rng(seed)
    if int_w:
        return r.integers(-127, 128, (k, n)).astype(np.int8)
    return r.normal(size=(k, n)).astype(np.float32)


def lif_inputs(seed, t, r, k):
    """fc1-like accumulators, bias and a per-channel threshold (the int8
    scale fold)."""
    g = np.random.default_rng(seed)
    x = (g.normal(size=(t, r, k)) * 1.5).astype(np.float32)
    bias = (g.normal(size=k) * 0.3).astype(np.float32)
    vth = (0.5 + g.random(k)).astype(np.float32)
    return x, bias, vth


# ---------------------------------------------------------------------------
# kernel 5: the fused TFLIF -> pack -> LUT gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int_w", [True, False], ids=["int16", "f32"])
@pytest.mark.parametrize("k", [40, 61])
@pytest.mark.parametrize("t", [1, 4, 9, 17])
def test_fused_matches_pallas_kernel(t, k, int_w):
    """Both outputs exact: the spikes (membrane across group boundaries
    at T = 9 and 17; K = 61 pads a ragged chunk) and the fc2 accumulators
    (int32 fold for int16 tables, the defined f32 fold otherwise)."""
    r, n = 12, 9
    x, bias, vth = lif_inputs(t * k, t, r, k)
    w = weights(k + t, k, n, int_w=int_w)
    tbl = np.asarray(jlut.build_lut(jnp.asarray(w)))
    want_s, want_a = jfused(jnp.asarray(x), jnp.asarray(bias),
                            jnp.asarray(tbl), v_th=jnp.asarray(vth),
                            interpret=True)
    got_s, got_a = tflif_lut_matmul(t_(x), t_(bias), t_(tbl), t_(vth))
    assert got_s.dtype == torch.uint8 and got_s.shape == (-(-t // 8), r, k)
    assert got_a.shape == (t, r, n)
    exact(got_s, want_s)
    exact(got_a, want_a)
    assert ops.launch_counts()["fused_lif_lut"] == 0


def fused_schedule(x, bias, table, vth, *, rows, bn, tau=2.0, group=8,
                   max_cluster=8):
    """Plain emulation of ``csrc/fused_lif_lut.cu``'s schedule: per row
    tile of ``rows`` rows, the LIF runs once, group by group of ``group``
    chunks, each chunk's share taken by one rank of the cluster of column
    tiles (index bytes kept per (step, row, chunk)); then each column tile
    of ``bn`` columns folds its (256, bn) table slabs in ascending chunk
    order, int32 for int16 tables, f32 from chunk 0's entry otherwise."""
    t, r, k = x.shape
    c_n, _, n = table.shape
    tiles = max(1, -(-n // bn))
    cluster = min(max_cluster, tiles)
    acc_dt = torch.float32 if table.is_floating_point() else torch.int32
    spikes = torch.zeros((-(-t // 8), r, k), dtype=torch.uint8)
    out = torch.empty((t, r, n))
    pad = c_n * 8 - k
    xp = torch.nn.functional.pad(x, (0, pad))
    bp = torch.nn.functional.pad(bias, (0, pad))
    vp = torch.nn.functional.pad(vth, (0, pad), value=1.0)
    for r0 in range(0, r, rows):
        rr = slice(r0, min(r, r0 + rows))
        idx = torch.zeros((t, rr.stop - r0, c_n), dtype=torch.uint8)
        for g0 in range(0, c_n, group):
            for rank in range(cluster):
                for c in range(g0 + rank, min(g0 + group, c_n), cluster):
                    kk = slice(8 * c, 8 * c + 8)
                    v = torch.zeros((rr.stop - r0, 8))
                    for step in range(t):
                        h = v + (xp[step, rr, kk] + bp[kk] - v) / tau
                        s = h >= vp[kk]
                        v = torch.where(s, 0.0, h)
                        bits = s.to(torch.uint8) << torch.arange(
                            8, dtype=torch.uint8)
                        idx[step, :, c] = bits.sum(-1, dtype=torch.uint8)
                        live = s[:, :min(8, k - 8 * c)].to(torch.uint8)
                        spikes[step // 8, rr, 8 * c:8 * c + live.shape[1]] |= (
                            live << (step % 8))
        for j in range(tiles):
            cols = slice(j * bn, min(n, (j + 1) * bn))
            a = None
            for c in range(c_n):
                g = table[c, :, cols][idx[:, :, c].long()].to(acc_dt)
                a = g if c == 0 else a + g
            out[:, rr, cols] = a.to(torch.float32)
    return spikes, out


@pytest.mark.parametrize("int_w", [True, False], ids=["int16", "f32"])
@pytest.mark.parametrize("k,n", [(61, 37), (133, 9)])
@pytest.mark.parametrize("t", [1, 4, 9, 17])
def test_fused_slab_schedule_matches_plain_and_pallas(t, k, n, int_w):
    """Kernel 5's schedule (LIF once per row tile shared across the
    cluster, slabs of column tiles folded in ascending chunk order) gives
    both outputs of ``tflif_lut_plain`` and of the Pallas kernel in
    interpret mode bit for bit: at the kernel's own tile (1024 / TT rows,
    32 columns) and at small tiles that cut rows, columns and chunk groups
    (K = 133: 17 chunks, three groups; N = 37 not a multiple of 8)."""
    r = 21
    x, bias, vth = lif_inputs(t * k + n, t, r, k)
    w = weights(k + n, k, n, int_w=int_w)
    tbl = np.asarray(jlut.build_lut(jnp.asarray(w)))
    want_s, want_a = jfused(jnp.asarray(x), jnp.asarray(bias),
                            jnp.asarray(tbl), v_th=jnp.asarray(vth),
                            interpret=True)
    plain_s, plain_a = tflif_lut_plain(t_(x), t_(bias), t_(tbl), t_(vth))
    exact(plain_s, want_s)
    exact(plain_a, want_a)
    tt = max(4, 1 << (t - 1).bit_length())
    for rows, bn in ((1024 // tt, 32), (8, 8), (5, 4)):
        got_s, got_a = fused_schedule(t_(x), t_(bias), t_(tbl), t_(vth),
                                      rows=rows, bn=bn)
        exact(got_s, want_s, f"spikes, tile ({rows}, {bn})")
        exact(got_a, want_a, f"accumulators, tile ({rows}, {bn})")


def test_fused_range_guard_sends_long_trains_to_two_layers():
    """``fused_fits`` is the one range test of the fused kernel: T <= 64
    (its registers hold every step) and at most 65,535 row tiles. Outside
    it ``mlp_pair_lif`` returns None on any device, so ``forward_folded``
    runs fc1 and fc2 as two layers (bit-identical) instead of the kernel
    raising on the card."""
    r_max = fused._GRID_LIMIT * fused._rows_per_block(4)
    assert fused.fused_fits(64, 100) and not fused.fused_fits(65, 100)
    assert fused.fused_fits(4, r_max) and not fused.fused_fits(4, r_max + 1)
    k, n = 16, 8
    fc1 = {"kernel": torch.ones(8, k), "bias": torch.zeros(k)}
    w2 = torch.ones(k, n)
    fc2 = {"kernel": w2, "bias": torch.zeros(n), "lut": lut.build_lut(w2)}
    backend = PackedBackend()
    assert backend.mlp_pair_lif(torch.zeros((9, 1, 3, 8), dtype=torch.uint8),
                                fc1, fc2, t=65) is None
    wide = torch.zeros((1, 1, 1, 8), dtype=torch.uint8).expand(
        1, 1, r_max + 1, 8)                         # rows past the grid
    assert backend.mlp_pair_lif(wide, fc1, fc2, t=4) is None
    x4 = torch.full((1, 1, 3, 8), 5, dtype=torch.uint8)
    fused_out = backend.mlp_pair_lif(x4, fc1, fc2, t=4)
    assert fused_out is not None
    two = backend.wssl_lif(backend.wssl_lif(x4, fc1["kernel"], fc1["bias"],
                                            t=4),
                           w2, fc2["bias"], t=4, lut=fc2["lut"])
    exact(fused_out, two)


def test_fused_plain_is_the_unfused_composition():
    """The plain version equals ``tflif_pack`` then ``spike_linear`` over
    the table: what ``mlp_pair_lif`` replaces."""
    t, r, k, n = 4, 7, 24, 5
    x, bias, vth = lif_inputs(3, t, r, k)
    w = t_(weights(4, k, n, int_w=False))
    tbl = lut.build_lut(w)
    spikes, acc = tflif_lut_plain(t_(x), t_(bias), tbl, t_(vth))
    exact(spikes, ops.tflif_pack(t_(x), t_(bias), v_th=t_(vth)))
    exact(acc, ops.spike_linear(spikes, w, t=t, table=tbl))


@pytest.mark.parametrize("int_w", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("t", [4, 9])
def test_tflif_lut_matches_pallas_branch(t, int_w):
    """``ops.tflif_lut`` over (T, B, N, K) accumulators with a scalar and a
    per-channel threshold, against the reference's Pallas branch."""
    k, n = 20, 6
    x, bias, vth = lif_inputs(20 + t, t, 6, k)
    x = x.reshape(t, 2, 3, k)
    w = weights(21, k, n, int_w=int_w)
    tbl = lut.build_lut(t_(w))
    jtbl = jnp.asarray(tbl.numpy())
    for v in (1.0, vth):
        ws, wa = jops.tflif_lut(jnp.asarray(x), jnp.asarray(bias), table=jtbl,
                                v_th=jnp.asarray(v), pallas=True)
        gs, ga = ops.tflif_lut(t_(x), t_(bias), table=tbl,
                               v_th=v if isinstance(v, float) else t_(v))
        assert gs.shape == (-(-t // 8), 2, 3, k) and ga.shape == (t, 2, 3, n)
        exact(gs, ws)
        exact(ga, wa)
    ws, wa = jops.tflif_lut(jnp.asarray(x), None, table=jtbl, t=2,
                            pallas=True)
    gs, ga = ops.tflif_lut(t_(x), None, table=tbl, t=2, plain=True)
    exact(gs, ws)
    exact(ga, wa)


def test_tflif_lut_needs_a_real_table():
    x = torch.zeros((4, 3, 16))
    for table in (None, True, torch.zeros(3)):
        with pytest.raises(ValueError, match="requires a real"):
            ops.tflif_lut(x, table=table)


def test_fused_wrapper_checks_its_operands():
    x, k = torch.zeros((4, 3, 16)), torch.zeros(16)
    tbl = torch.zeros((2, 256, 5), dtype=torch.int16)
    with pytest.raises(ValueError, match="x must be"):
        tflif_lut_matmul(x.double(), k, tbl, k)
    with pytest.raises(ValueError, match="table must be"):
        tflif_lut_matmul(x, k, tbl.to(torch.int32), k)
    with pytest.raises(ValueError, match="must both be"):
        tflif_lut_matmul(x, k[:8], tbl, k)
    with pytest.raises(ValueError, match="does not match table"):
        tflif_lut_matmul(x, k, tbl[:1], k)


# ---------------------------------------------------------------------------
# kernel 6: the 2-D spike_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int_w", [True, False], ids=["int", "f32"])
@pytest.mark.parametrize("mode", ["shift_sum", "per_plane"])
@pytest.mark.parametrize("m,k,n", [(50, 12, 16), (9, 64, 33)])
def test_spike_matmul_matches_pallas_kernel(m, k, n, mode, int_w):
    """Exact for integer-valued weights (integer sums); f32 weights within
    ``F32_TOL[mode]``."""
    x = np.random.default_rng(m * k).integers(0, 256, (m, k), dtype=np.uint8)
    w = weights(n, k, n, int_w=int_w).astype(np.float32)
    want = np.asarray(jspike_matmul(jnp.asarray(x), jnp.asarray(w),
                                    mode=mode, interpret=True))
    got = spike_matmul(t_(x), t_(w), mode=mode)
    assert got.shape == want.shape
    if int_w:
        exact(got, want)
    else:
        atol, rtol = F32_TOL[mode]
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=rtol)
    exact(ops.spike_matmul(t_(x), t_(w), mode=mode), got)


@pytest.mark.parametrize("int_w", [True, False], ids=["int8", "f32"])
def test_sssc_unpack_route_matches_pallas_branch(int_w):
    """``ops.sssc_linear(route="unpack")`` is the shift-sum dot on both
    sides now: exact for int8 weights, ``F32_TOL["shift_sum"]`` for f32
    (it used to run 8 per-plane dots folded by ``shift_sum_fold``)."""
    r = np.random.default_rng(31)
    img = r.integers(0, 256, (2, 3, 4, 12), dtype=np.uint8)
    w = weights(32, 12, 8, int_w=int_w)
    bias = r.normal(size=8).astype(np.float32)
    want = np.asarray(jops.sssc_linear(jnp.asarray(img), jnp.asarray(w),
                                       jnp.asarray(bias), pallas=True,
                                       route="unpack"))
    got = ops.sssc_linear(t_(img), t_(w), t_(bias), route="unpack")
    assert got.shape == (2, 3, 4, 8)
    if int_w:
        exact(got, want)
    else:
        atol, rtol = F32_TOL["shift_sum"]
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=rtol)
    exact(ops.sssc_linear(t_(img), t_(w), t_(bias), route="unpack",
                          plain=True), got)


def test_spike_matmul_wrappers_check_their_operands():
    x = torch.zeros((5, 12), dtype=torch.uint8)
    w = torch.zeros((12, 4))
    with pytest.raises(ValueError, match="x must be"):
        shift_sum_matmul(x.to(torch.int32), w)
    with pytest.raises(ValueError, match="x must be"):
        shift_sum_matmul(x[None], w)
    with pytest.raises(ValueError, match="w must be"):
        shift_sum_matmul(x, w.double())
    with pytest.raises(ValueError, match="disagree on K"):
        shift_sum_matmul(x, w[:11])
    with pytest.raises(ValueError, match="x must be"):
        spike_matmul(x[None], w, mode="per_plane")
    with pytest.raises(ValueError, match="unknown spike_matmul mode"):
        spike_matmul(x, w, mode="sum")
    meta = torch.empty((5, 12), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        shift_sum_matmul(meta, torch.zeros((12, 4), device="meta"))
