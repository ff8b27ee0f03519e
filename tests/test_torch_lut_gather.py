"""Kernel 2, the byte-LUT gather, against the JAX reference on the CPU: a
plain emulation of ``csrc/lut_gather.cu``'s schedule and of its packed
entry's in-register bit transpose, held bit for bit to the Pallas
``lut_gather_matmul`` in interpret mode, to ``lut.plane_indices`` and to
the plain versions the wrappers run on CPU operands. Inputs come from
seeded numpy and go through both packages; every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spike as jspike
from repro.kernels import lut_matmul as jlut
from repro.kernels.spike_matmul import lut_gather_matmul as jgather
from repro_torch.kernels import lut_matmul as lut
from repro_torch.kernels import ops
from repro_torch.kernels.spike_matmul import (lut_gather_matmul,
                                              lut_gather_packed,
                                              lut_gather_packed_plain)
from torch_threads import one_thread  # noqa: F401  (autouse)


def exact(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def packed_spikes(seed, t, m, k, rate=0.3):
    """(G, M, K) uint8 plane groups of a seeded T-step train."""
    r = np.random.default_rng(seed)
    s = (r.random((t, m, k)) < rate).astype(np.float32)
    return np.array(jspike.pack_timesteps(jnp.asarray(s)))


def table_of(seed, k, n, *, int_w):
    r = np.random.default_rng(seed)
    w = (r.integers(-127, 128, (k, n)).astype(np.int8) if int_w
         else r.normal(size=(k, n)).astype(np.float32))
    return np.array(jlut.build_lut(jnp.asarray(w)))


# ---------------------------------------------------------------------------
# plain emulations of the kernel
# ---------------------------------------------------------------------------

def bit_transpose8(x: np.ndarray) -> np.ndarray:
    """The kernel's 8x8 bit transpose of uint64 words (byte i = row i ->
    byte j = column j), step for step, in numpy."""
    x = x.astype(np.uint64)
    for shift, mask in ((7, 0x00AA00AA00AA00AA), (14, 0x0000CCCC0000CCCC),
                        (28, 0x00000000F0F0F0F0)):
        s, m = np.uint64(shift), np.uint64(mask)
        t = (x ^ (x >> s)) & m
        x = x ^ t ^ (t << s)
    return x


def packed_index_words(x_packed: np.ndarray, t: int) -> np.ndarray:
    """The packed entry's index bytes: the 8 packed bytes of each (group,
    row, chunk), zero past K, read as one little-endian word, transposed,
    and split into its 8 plane bytes; the first t planes kept. (t, M, C)."""
    g, m, k = x_packed.shape
    c = -(-k // 8)
    xb = np.zeros((g, m, 8 * c), np.uint8)
    xb[..., :k] = x_packed
    words = xb.reshape(g, m, c, 8).view("<u8")[..., 0]          # (G, M, C)
    tr = bit_transpose8(words)
    planes = np.stack([(tr >> np.uint64(8 * j)) & np.uint64(0xFF)
                       for j in range(8)], axis=1)               # (G, 8, M, C)
    return planes.reshape(g * 8, m, c)[:t].astype(np.uint8)


def kernel_schedule(idx: np.ndarray, table: np.ndarray, *, rows=None,
                    ct=32, tiles_per_block=3):
    """Plain emulation of ``csrc/lut_gather.cu``: tiles of ``rows`` rows
    (all their planes, in blocks of TT = 4, 8 or 16) by 32 f32 or 64 int16
    columns, walked rows fastest by blocks that take every
    ``tiles_per_block``-th tile; index bytes staged as words of 4 planes,
    ``ct`` chunks a group, and read back by shift and mask; each chunk's
    (256, BN) slab zero past N; int16 slabs read as 32-bit words of two
    columns, the low half sign-extended and the high half
    arithmetic-shifted into two int32 sums; f32 folds starting from -0.0;
    chunks in ascending order."""
    p, m, c = idx.shape
    n = table.shape[2]
    i16 = table.dtype == np.int16
    cpl = 2 if i16 else 1
    tt = 4 if p <= 4 else 8 if p <= 8 else 16
    rows = rows or 1024 // (tt * cpl)
    bn = 32 * cpl
    row_tiles, col_tiles = -(-m // rows), -(-n // bn)
    tiles = row_tiles * col_tiles
    tbl = np.zeros((c, 256, col_tiles * bn), table.dtype)
    tbl[..., :n] = table
    out = np.full((p, m, n), np.nan, np.float32)
    order = [tile for b in range(tiles_per_block)
             for tile in range(b, tiles, tiles_per_block)]
    assert sorted(order) == list(range(tiles))
    for tile in order:
        r0 = (tile % row_tiles) * rows
        col0 = (tile // row_tiles) * bn
        r1, c1 = min(m, r0 + rows), min(n, col0 + bn)
        for pb in range(-(-p // tt)):
            np_ = min(tt, p - pb * tt)
            acc = (np.zeros((np_, r1 - r0, bn), np.int32) if i16
                   else np.full((np_, r1 - r0, bn), -0.0, np.float32))
            for g0 in range(0, c, ct):
                cw = min(ct, c - g0)
                # words of 4 planes a (row, chunk), dead planes zero
                words = np.zeros((-(-tt // 4), r1 - r0, cw), np.uint32)
                for pl in range(np_):
                    words[pl // 4] |= idx[pb * tt + pl, r0:r1,
                                          g0:g0 + cw].astype(np.uint32) << (
                                              8 * (pl % 4))
                for cc in range(cw):
                    slab = np.ascontiguousarray(
                        tbl[g0 + cc, :, col0:col0 + bn])         # (256, BN)
                    for pl in range(np_):
                        b = (words[pl // 4, :, cc] >> (8 * (pl % 4))) & 0xFF
                        if i16:
                            u = slab.view(np.uint32)[b]           # (rows, 32)
                            lo = (u & 0xFFFF).astype(np.uint16).view(np.int16)
                            hi = u.view(np.int32) >> 16
                            acc[pl, :, 0::2] += lo.astype(np.int32)
                            acc[pl, :, 1::2] += hi
                        else:
                            acc[pl] = acc[pl] + slab[b]
            out[pb * tt:pb * tt + np_, r0:r1, col0:c1] = (
                acc[..., :c1 - col0].astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [12, 100, 512])
@pytest.mark.parametrize("t", [1, 4, 8, 9, 17])
def test_packed_entry_transpose_matches_plane_indices(t, k):
    """The packed entry's in-register transpose forms exactly the index
    bytes ``plane_indices`` forms in torch and the reference forms in JAX,
    K not a multiple of 8 reading as zero bits."""
    x = packed_spikes(t * k, t, 23, k)
    got = packed_index_words(x, t)
    exact(got, lut.plane_indices(torch.from_numpy(x))[:t])
    exact(got, np.asarray(jlut.plane_indices(jnp.asarray(x)))[:t])


@pytest.mark.parametrize("int_w", [True, False], ids=["int16", "f32"])
@pytest.mark.parametrize("k", [12, 100, 512])
@pytest.mark.parametrize("t", [1, 4, 8, 9, 17])
def test_gather_schedule_matches_pallas(t, k, int_w):
    """The kernel's schedule on both entries' index bytes gives the Pallas
    gather's result (interpret mode, small tiles) bit for bit: at the
    kernel's own tile and at tiles that cut rows (37 rows: partial tiles),
    columns (N = 67, odd: a partial column tile, and for int16 a partial
    two-column word) and chunk groups (K = 512: 64 chunks in groups of 8),
    with several tiles a block."""
    m, n = 37, 67
    x = packed_spikes(1000 + t * k, t, m, k)
    tbl = table_of(k + n, k, n, int_w=int_w)
    idx = packed_index_words(x, t)
    want = np.asarray(jgather(jnp.asarray(idx), jnp.asarray(tbl), bm=16,
                              bn=16, bc=16, interpret=True))
    exact(lut.lut_matmul(torch.from_numpy(idx), torch.from_numpy(tbl)), want)
    for rows, ct in ((None, 32), (8, 8), (16, 3)):
        exact(kernel_schedule(idx, tbl, rows=rows, ct=ct), want,
              f"rows {rows}, {ct} chunks a group")


@pytest.mark.parametrize("int_w", [True, False], ids=["int16", "f32"])
@pytest.mark.parametrize("t", [4, 9])
def test_packed_wrapper_matches_pallas_on_the_cpu(t, int_w):
    """``lut_gather_packed`` (its plain version on CPU operands) and
    ``lut_gather_matmul`` on the same planes give the Pallas gather's
    result; neither counts a launch."""
    m, k, n = 30, 100, 19
    x = packed_spikes(t + n, t, m, k)
    tbl = table_of(t, k, n, int_w=int_w)
    want = np.asarray(jgather(jnp.asarray(packed_index_words(x, t)),
                              jnp.asarray(tbl), bm=8, bn=8, bc=4,
                              interpret=True))
    xt, tt = torch.from_numpy(x), torch.from_numpy(tbl)
    ops.reset_launch_counts()
    exact(lut_gather_packed(xt, tt, t=t), want)
    exact(lut_gather_packed_plain(xt, tt, t=t), want)
    exact(lut_gather_matmul(lut.plane_indices(xt)[:t].contiguous(), tt), want)
    assert ops.launch_counts()["lut_gather"] == 0


def test_packed_wrapper_checks_its_operands():
    x = torch.zeros((1, 3, 16), dtype=torch.uint8)
    tbl = torch.zeros((2, 256, 5), dtype=torch.int16)
    with pytest.raises(ValueError, match="x_packed must be"):
        lut_gather_packed(x.to(torch.int32), tbl, t=4)
    with pytest.raises(ValueError, match="table must be"):
        lut_gather_packed(x, tbl.to(torch.int32), t=4)
    with pytest.raises(ValueError, match="does not match table"):
        lut_gather_packed(x, tbl[:1], t=4)
    with pytest.raises(ValueError, match="plane groups"):
        lut_gather_packed(x, tbl, t=9)
    with pytest.raises(ValueError, match=r"not \(C, 256, N\)"):
        lut_gather_packed(x, tbl[:, :128].contiguous(), t=4)
