"""Byte-LUT matmul primitives and the route chooser (port of
``repro.kernels.lut_matmul``).

One packed byte *selects* a precomputed partial sum over its 8-row weight
chunk: ``table[c, b, :]`` holds the sum of the rows of chunk c whose bit is
set in byte b, so a spiking matmul becomes gather-and-accumulate. The
time-packed activations are turned into K-packed index bytes by an 8x8 bit
transpose (``plane_indices``). The reduction tree is defined: ascending-bit
folds inside a chunk (``build_lut``), ascending-chunk adds across chunks
(``lut_matmul``), so every route that replays it is bit-exact. Integer
kernels give int16 tables accumulated in int32.

``lut_matmul`` is the plain version of the CUDA gather kernel
(``kernels.spike_matmul.lut_gather_matmul``). ``lut_matmul_sparse``, the
zero-chunk-skipping gather, and ``choose_route``, the cost model that
weighs it, belong to the reference's CPU branch (``kernels.ops``'s
``cpu_branch``); ``choose_cuda_route`` is the card's chooser.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..device import constant

K_CHUNK = 8  # weight rows selected by one byte — the PE fan-in of the paper
MAX_TABLE_BYTES = 1 << 24  # 16 MiB per-layer table cap


def num_k_chunks(k: int) -> int:
    """Number of 8-row weight chunks (= LUT gather steps) for K input rows."""
    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")
    return -(-k // K_CHUNK)


def table_bytes(k: int, n: int, weights_are_int: bool) -> int:
    """Size of the cached LUT for a (K, N) kernel."""
    return num_k_chunks(k) * 256 * n * (2 if weights_are_int else 4)


def is_int_kernel(w: torch.Tensor) -> bool:
    return not (w.is_floating_point() or w.is_complex())


def _pad_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-pad the trailing (K) axis up to a multiple of 8."""
    pad = num_k_chunks(k) * K_CHUNK - k
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _bit_spread(device) -> torch.Tensor:
    """(8, 256) int64: row i, entry v holds bit j of v at bit i of byte j
    (little-endian) of a 64-bit word."""
    v = torch.arange(256, dtype=torch.int64, device=device)
    j = torch.arange(8, dtype=torch.int64, device=device)
    spread = (((v[:, None] >> j) & 1) << (8 * j)).sum(-1)       # (256,)
    return spread[None, :] << torch.arange(8, dtype=torch.int64,
                                            device=device)[:, None]


def bit_transpose8(b: torch.Tensor) -> torch.Tensor:
    """Transpose 8x8 bit matrices held as 8 bytes, over leading axes:
    ``out[..., j]`` bit i == ``b[..., i]`` bit j. Each byte i of a matrix
    looks up the 64-bit word that spreads its bits to bit i of bytes 0-7
    (``_bit_spread``, made once a device); the 8 words of a matrix hold
    disjoint bits, so their sum is the transposed matrix as one
    little-endian word. Five torch calls whatever the size (a CPU step is
    thousands of short calls; the swap network of Hacker's Delight 7-3
    took eighteen)."""
    spread = constant("bit_spread8", b.device, _bit_spread)
    offsets = constant("bit_spread8_rows", b.device, lambda d: torch.arange(
        0, 8 * 256, 256, dtype=torch.int64, device=d))
    rows = b.to(torch.int64) + offsets          # byte i of value v: i*256+v
    words = spread.view(-1).index_select(0, rows.view(-1)).view(rows.shape)
    return words.sum(-1, keepdim=True).view(torch.uint8)


def plane_indices(x_packed: torch.Tensor) -> torch.Tensor:
    """(G, ..., K) time-packed plane groups -> (G*8, ..., C) per-plane LUT
    index bytes, C = ceil(K/8): bit i of ``[p, ..., c]`` = plane p of input
    ``8c + i``. Planes past the live count are zero bytes; callers slice
    ``[:t]``."""
    g, k = x_packed.shape[0], x_packed.shape[-1]
    lead = x_packed.shape[1:-1]
    c = num_k_chunks(k)
    x = _pad_k(x_packed, k).reshape(g, *lead, c, K_CHUNK)
    idx = bit_transpose8(x)                               # [..., j] bit i
    return torch.movedim(idx, -1, 1).reshape(g * K_CHUNK, *lead, c)


def build_lut(w: torch.Tensor) -> torch.Tensor:
    """(K, N) kernel -> (C, 256, N) chunk-partial-sum table, built by the
    ascending-bit fold; int16 for integer kernels, f32 otherwise."""
    k, n = w.shape
    c = num_k_chunks(k)
    dt = torch.int16 if is_int_kernel(w) else torch.float32
    wc = _pad_k(w.to(dt).T, k).T.reshape(c, K_CHUNK, n)
    codes = torch.arange(256, dtype=torch.int64, device=w.device)
    bits = ((codes[:, None] >> torch.arange(K_CHUNK, device=w.device)) & 1
            ).to(dt)                                      # (256, 8)
    tbl = torch.zeros((c, 256, n), dtype=dt, device=w.device)
    for i in range(K_CHUNK):
        tbl = tbl + bits[None, :, i, None] * wc[:, None, i, :]
    return tbl


def lut_matmul(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Gather-and-accumulate: (..., C) index bytes x (C, 256, N) table ->
    (..., N) f32 by the ascending-chunk fold (int32 for int16 tables).
    The plain version of the CUDA gather kernel. The row numbers into the
    flattened (C*256, N) table are formed once for every chunk. An f32
    table is gathered and summed by one ``embedding_bag``: each row's C row
    numbers are a bag, summed in index order from zero on the CPU and on
    CUDA alike, which is the ascending-chunk fold bit for bit without the
    (C, R, N) gather in memory (a table holds no -0.0, so the first add is
    exact). An int16 table needs an int32 sum, which ``embedding_bag`` does
    not give: the rows of as many chunks as ``_GATHER_BYTES`` holds are
    gathered at once, widened and added in ascending order."""
    c, _, n = table.shape
    if idx.shape[-1] != c:
        raise ValueError(f"index bytes {tuple(idx.shape)} do not match "
                         f"table {tuple(table.shape)}")
    lead = idx.shape[:-1]
    flat = table.reshape(c * 256, n)
    off = constant(("lut_chunk_rows", c), idx.device, lambda d: torch.arange(
        0, c * 256, 256, dtype=torch.int64, device=d))
    rows = idx + off                                   # uint8 -> int64
    if table.is_floating_point():
        y = torch.nn.functional.embedding_bag(rows.reshape(-1, c), flat,
                                              mode="sum")
        return y.reshape(*lead, n).to(torch.float32)
    rows = torch.movedim(rows, -1, 0).reshape(c, -1)
    r = rows.shape[1]
    per = max(1, min(c, _GATHER_BYTES // max(1, r * n * table.element_size())))
    y = None
    for c0 in range(0, c, per):
        block = flat.index_select(0, rows[c0:c0 + per].reshape(-1))
        for part in block.view(min(per, c - c0), r, n).unbind(0):
            # int16 rows promote to the int32 sum; the sum is a fresh
            # tensor (a copy), so the chunks add into it in place
            y = part.to(torch.int32) if y is None else y.add_(part)
    return y.reshape(*lead, n).to(torch.float32)


# rows of several chunks gathered by one index_select, at most this many
# bytes
_GATHER_BYTES = 64 << 20


def sparse_budget(c: int, occupancy: float) -> int:
    """Static per-row gather budget of the zero-chunk-skipping route, from
    the calibrated CHUNK occupancy (the fraction of nonzero index bytes,
    ``infer.backends.chunk_occupancy``): ``occupancy * c`` expected nonzero
    chunks a row, plus one of slack, within [1, c]. Rows past the budget
    send the call to the dense gather (``lut_matmul_sparse``)."""
    if not 0.0 <= occupancy <= 1.0:
        raise ValueError(f"occupancy must be in [0, 1], got {occupancy!r}")
    return min(c, max(1, math.ceil(occupancy * c) + 1))


def lut_matmul_sparse(idx: torch.Tensor, table: torch.Tensor, *,
                      max_chunks: int) -> torch.Tensor:
    """Zero-chunk-skipping gather: ``lut_matmul`` where each row gathers
    only its first ``max_chunks`` nonzero index bytes, in the reference's
    op order. A cumsum rank of each nonzero byte among its row's nonzeros,
    matched against ``max_chunks`` output slots, compacts the flattened
    (chunk, byte) gather indices to the front in ascending chunk order;
    unmatched slots index 0, ``table[0, 0, :]``, the exact zero the skipped
    bytes would have gathered. The slots fold in ascending order. When any
    row holds more than ``max_chunks`` nonzero bytes the whole call runs
    the dense gather (a host read decides, as the reference's ``lax.cond``
    does on the device): a miscalibrated occupancy costs speed, never
    correctness."""
    c, _, n = table.shape
    if idx.shape[-1] != c:
        raise ValueError(f"index bytes {tuple(idx.shape)} do not match "
                         f"table {tuple(table.shape)}")
    if max_chunks < 1:
        raise ValueError(f"need max_chunks >= 1, got {max_chunks}")
    if max_chunks >= c or not idx.numel():
        return lut_matmul(idx, table)
    nz = idx != 0
    pos = torch.cumsum(nz.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    if int(pos[..., -1].max()) + 1 > max_chunks:
        return lut_matmul(idx, table)
    slots = torch.arange(max_chunks, dtype=torch.int32, device=idx.device)
    match = (pos[..., None, :] == slots[:, None]) & nz[..., None, :]
    val = (torch.arange(c, dtype=torch.int32, device=idx.device) * 256
           + idx.to(torch.int32))
    gidx = torch.where(match, val[..., None, :], 0).sum(-1)   # (..., B)
    flat = table.reshape(c * 256, n)
    acc_dt = torch.float32 if table.is_floating_point() else torch.int32
    y = flat[gidx[..., 0].long()].to(acc_dt)
    for j in range(1, max_chunks):
        y = y + flat[gidx[..., j].long()].to(acc_dt)
    return y.to(torch.float32)


def lut_matmul_planes(planes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The gather route's fold replayed on unpacked planes: (R, M, K)
    {0,1} x (K, N) -> (R, M, N) f32 by the same reduction tree as
    ``build_lut`` + ``lut_matmul`` (an ascending-bit multiply-add fold per
    chunk, then ascending-chunk adds), elementwise only, so it equals the
    gather bit for bit. What the reference backend runs for LUT-planned
    layers. The reference forms all (R, M, C, N) chunk partials at once;
    this loops chunk by chunk, which keeps every element's op order and
    bounds memory (fc2 at batch 8 would otherwise take 3.3 GB)."""
    r, m, k = planes.shape
    n = w.shape[-1]
    c = num_k_chunks(k)
    wf = _pad_k(w.to(torch.float32).T, k).T.reshape(c, K_CHUNK, n)
    pc = _pad_k(planes.to(torch.float32), k).reshape(r, m, c, K_CHUNK)
    y = None
    for cc in range(c):
        part = torch.zeros((r, m, n), dtype=torch.float32,
                           device=planes.device)
        for i in range(K_CHUNK):
            part = part + pc[:, :, cc, i, None] * wf[cc, i]
        y = part if y is None else y + part
    return y


def shift_sum_fold(per_plane: torch.Tensor) -> torch.Tensor:
    """SSSC bit-plane combine in a defined order: (8, ..., N) ->
    (..., N), ``y = y + per[p] * 2^p`` ascending (exact scaling)."""
    y = per_plane[0]
    for p in range(1, 8):
        y = y + per_plane[p] * float(2.0 ** p)
    return y


# ---------------------------------------------------------------------------
# Route choice
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RouteConstants:
    """Cost-model constants, in units of one dot FMA, with the reference's
    keys and defaults, so a plan JSON written by the JAX package loads
    here. ``choose_route`` (the CPU branch's) reads every key but the
    ``pallas_*`` pair; ``choose_cuda_route`` (the card's) reads only that
    pair and ``transpose_cost``."""
    gather_cost: float = 4.0
    transpose_cost: float = 2.5
    unpack_cost: float = 8.0
    int_gather_discount: float = 0.5
    cache_bytes: int = 1 << 21
    cache_penalty: float = 3.0
    compact_cost: float = 40.0
    pallas_gather_cost: float = 2.0
    pallas_dot_cost: float = 1.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RouteConstants":
        known = {f.name for f in dataclasses.fields(cls)}
        bad = set(d) - known
        if bad:
            raise ValueError(f"unknown route-constant keys {sorted(bad)}; "
                             f"expected a subset of {sorted(known)}")
        return cls(**d)


DEFAULT_ROUTE_CONSTANTS = RouteConstants()


def choose_route(*, m: int, k: int, n: int, g: int, t: int,
                 weights_are_int: bool = False,
                 max_table_bytes: int = MAX_TABLE_BYTES,
                 constants: RouteConstants | None = None,
                 occupancy: float | None = None) -> str:
    """"lut", "lut_sparse" or "unpack" for a packed matmul of (t live
    planes, M rows, K inputs, N outputs, G plane groups) on the CPU
    branch: the reference's cost model. The gather's traffic, t*M*C*N
    table elements (int16 tables at ``int_gather_discount``, x
    ``cache_penalty`` past ``cache_bytes``) plus the G*M*K bit transpose,
    against the dot's t*M*K*N FMAs plus its t*M*K unpack writes; a table
    past ``max_table_bytes`` is never built. A calibrated CHUNK
    ``occupancy`` lets the zero-chunk-skipping gather compete: its gathers
    scale with ``sparse_budget(c, occupancy)`` instead of c, plus an
    N-independent compaction term over the t*M*C index bytes times the
    slot count. ``None``, no calibration, never picks the sparse route."""
    cc = DEFAULT_ROUTE_CONSTANTS if constants is None else constants
    c = num_k_chunks(k)
    tbl = table_bytes(k, n, weights_are_int)
    if tbl > max_table_bytes:
        return "unpack"
    gather_scale = cc.gather_cost * (cc.int_gather_discount
                                     if weights_are_int else 1.0)
    cache_penalty = 1.0 if tbl <= cc.cache_bytes else cc.cache_penalty
    lut_cost = (t * m * c * n * gather_scale * cache_penalty
                + g * m * k * cc.transpose_cost)
    unpack_cost = t * m * k * (n + cc.unpack_cost)
    if occupancy is not None:
        budget = sparse_budget(c, occupancy)
        if budget < c:
            sparse_cost = (t * m * budget * n * gather_scale * cache_penalty
                           + g * m * k * cc.transpose_cost
                           + t * m * c * budget * cc.compact_cost)
            if sparse_cost < lut_cost and sparse_cost < unpack_cost:
                return "lut_sparse"
    return "lut" if lut_cost < unpack_cost else "unpack"


def choose_cuda_route(*, m: int, k: int, n: int, g: int, t: int,
                      weights_are_int: bool = False,
                      max_table_bytes: int = MAX_TABLE_BYTES,
                      constants: RouteConstants | None = None,
                      occupancy: float | None = None) -> str:
    """"lut" or "unpack" for the CUDA kernel pair, by the same formula and
    constants as the reference's ``choose_pallas_route``, so the routes
    equal a JAX ``packed_pallas`` plan's. ``occupancy`` is accepted for
    signature parity and ignored: the gather kernel is dense."""
    cc = DEFAULT_ROUTE_CONSTANTS if constants is None else constants
    c = num_k_chunks(k)
    if table_bytes(k, n, weights_are_int) > max_table_bytes:
        return "unpack"
    lut_cost = (t * m * c * n * cc.pallas_gather_cost
                + g * m * k * cc.transpose_cost)
    dot_cost = t * m * k * n * cc.pallas_dot_cost
    return "lut" if lut_cost < dot_cost else "unpack"
