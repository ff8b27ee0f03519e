"""Batched packed-spike entry points — the inference datapath — and the
LM stack's attention (port of the Pallas branch of ``repro.kernels.ops``).

Activations stay packed 8 per uint8 between layers (temporal bits for
WSSL/ZSC/STDP, value bits for SSSC) and only meet the weights inside a
kernel. Every entry point dispatches to the kernel wrappers, which
launch their CUDA kernel for CUDA operands and run their plain version for
CPU ones; ``plain=True`` runs the plain versions on any device (the oracle
route the kernels are held against on the card). ``cpu_branch=True`` runs
the reference's CPU branch instead, in torch on any device: routes resolved
by ``_resolve_route`` (the CPU cost model, the zero-chunk-skipping gather),
the single-dot unpack route, the STDP score LUT. No kernel runs there; it
is what the ``packed`` backend executes on the CPU.
"""
from __future__ import annotations

import contextlib
import math
import types

import torch

from . import _build
from . import lut_matmul as lut
from . import ref
from .flash_attention import (flash_attention as _flash,
                              flash_attention_f32, flash_attention_plain,
                              flash_attention_tc)
from .lut_matmul import choose_cuda_route, choose_route
from .fused import tflif_lut_matmul, tflif_lut_plain
from .spike_matmul import (MAX_S8_K, kmajor_weights, lut_gather_matmul,
                           lut_gather_packed, lut_gather_packed_plain,
                           shift_sum_matmul, spike_matmul_grouped,
                           spike_matmul_grouped_s8)
from .stdp_attention import (stdp_attention, stdp_attention_packed as
                             _stdp_packed, stdp_attention_packed_plain)
from .tflif import tflif_fused, tflif_plain
from ..core.lif import TAU, V_TH
from ..core.spike import num_plane_groups, unpack_timesteps
from ..device import constant

# kernel name -> wrapper; each wrapper counts its launches in ``.launches``
KERNELS = {"tflif": tflif_fused, "lut_gather": lut_gather_matmul,
           "unpack_dot": spike_matmul_grouped,
           "unpack_dot_s8": spike_matmul_grouped_s8, "stdp": stdp_attention,
           "stdp_packed": _stdp_packed, "fused_lif_lut": tflif_lut_matmul,
           "shift_sum": shift_sum_matmul,
           "flash_attention_tc": flash_attention_tc,
           "flash_attention_f32": flash_attention_f32}

_WRAPPERS = types.SimpleNamespace(
    tflif=tflif_fused, lut=lut_gather_packed, unpack=spike_matmul_grouped,
    unpack_s8=spike_matmul_grouped_s8, stdp_packed=_stdp_packed,
    fused=tflif_lut_matmul, shift_sum=shift_sum_matmul, flash=_flash)
_PLAIN = types.SimpleNamespace(
    tflif=tflif_plain, lut=lut_gather_packed_plain,
    unpack=lambda x, w, t, w_bf16x3=None: ref.spike_matmul_ref(x, w, t=t),
    unpack_s8=lambda x, wk, t: ref.spike_matmul_ref(x, wk.T, t=t),
    stdp_packed=stdp_attention_packed_plain, fused=tflif_lut_plain,
    shift_sum=lambda x, w: ref.spike_matmul_ref(x, w, mode="shift_sum"),
    flash=flash_attention_plain)


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Zero every kernel's launches, and the f32 unpack dot's count of
    weight splits built per call."""
    for fn in KERNELS.values():
        fn.launches = 0
    spike_matmul_grouped.split_builds = 0


@contextlib.contextmanager
def recording_launches():
    """Yields ``{kernel name: launches}``, filled when the block ends with
    the launches this thread made inside it (a graph capture's count, safe
    from other serving threads' launches)."""
    names = {fn: name for name, fn in KERNELS.items()}
    counts: dict = {}
    with _build.recording_launches() as by_wrapper:
        yield counts
    counts.update({names[fn]: n for fn, n in by_wrapper.items()})


def _have_table(table) -> bool:
    """A real (C, 256, N) table, as opposed to None or a planner flag."""
    return isinstance(table, torch.Tensor) and table.dim() == 3


def _resolve_route_cuda(route, table, *, m, k, n, g, t, weights_are_int,
                        constants=None) -> str:
    """"lut" (the gather kernel over a prebuilt table) or "unpack" (the
    grouped unpack dot kernel), under the contract of the reference's
    ``_resolve_route_pallas``: None takes "lut" iff a table is given,
    "auto" consults ``choose_cuda_route``, and a pinned "lut_sparse" runs
    the dense gather (bitwise identical; there is no skipping kernel)."""
    if route is None:
        return "lut" if _have_table(table) else "unpack"
    if route == "auto":
        return choose_cuda_route(m=m, k=k, n=n, g=g, t=t,
                                 weights_are_int=weights_are_int,
                                 constants=constants)
    if route not in ("lut", "lut_sparse", "unpack"):
        raise ValueError(f"unknown packed-matmul route {route!r}")
    return "lut" if route == "lut_sparse" else route


def _resolve_route(route, table, *, m, k, n, g, t, weights_are_int,
                   constants=None, occupancy=None) -> str:
    """Route resolution of the CPU branch (the reference's, for its
    ``pallas=False`` ops): None takes "lut" iff a table is given, upgraded
    to "lut_sparse" by a calibrated ``occupancy``, else "unpack"; "auto"
    consults ``choose_route`` with ``occupancy``; "lut", "lut_sparse" and
    "unpack" force, the sparse route only with an occupancy to size its
    static gather budget from."""
    if route is None:
        if not _have_table(table):
            return "unpack"
        return "lut_sparse" if occupancy is not None else "lut"
    if route == "auto":
        return choose_route(m=m, k=k, n=n, g=g, t=t,
                            weights_are_int=weights_are_int,
                            constants=constants, occupancy=occupancy)
    if route not in ("lut", "lut_sparse", "unpack"):
        raise ValueError(f"unknown packed-matmul route {route!r}")
    if route == "lut_sparse" and occupancy is None:
        raise ValueError("route='lut_sparse' requires a calibrated "
                         "occupancy (the static gather budget comes from "
                         "it); measure with infer.backends.chunk_occupancy")
    return route


def _cpu_gather(idx, table, resolved, occupancy):
    """The CPU branch's gather over index bytes: dense, or skipping zero
    chunks within the budget the occupancy gives."""
    if resolved == "lut_sparse":
        budget = lut.sparse_budget(table.shape[0], occupancy)
        return lut.lut_matmul_sparse(idx, table, max_chunks=budget)
    return lut.lut_matmul(idx, table)


def spike_matmul(x_packed, w, *, mode: str = "per_plane",
                 plain: bool = False):
    """The 2-D unified-PE dot: (M, K) uint8, bit p of a byte = plane p,
    x (K, N) weights of any dtype (f32 in the dot). ``mode="per_plane"``
    -> (8, M, N) f32, one dot per plane; ``mode="shift_sum"`` -> (M, N)
    f32, the byte read as a value (SSSC)."""
    if mode not in ("per_plane", "shift_sum"):
        raise ValueError(f"unknown spike_matmul mode {mode!r}")
    impl = _PLAIN if plain else _WRAPPERS
    x2, wf = x_packed.contiguous(), w.to(torch.float32).contiguous()
    if mode == "shift_sum":
        return impl.shift_sum(x2, wf)
    return impl.unpack(x2[None], wf, t=8)       # G=1: all 8 planes


def spike_linear(x_packed, w, bias=None, *, t: int, route=None, table=None,
                 w_kmajor=None, w_bf16x3=None, route_constants=None,
                 occupancy=None, plain: bool = False,
                 cpu_branch: bool = False):
    """Packed WSSL: (G, ..., K) uint8 temporal plane groups x (K, N) ->
    (t, ..., N) f32 per-timestep accumulators (+ ``bias``).

    "lut" gathers from ``table`` (``lut.build_lut(w)``, cached by the route
    planner) by the bit-transposed index bytes, which the gather kernel
    forms from the packed spikes itself; "unpack" runs the grouped
    dot, which expands the bits on chip: on the int8 tensor cores for int8
    ``w`` (over ``w_kmajor``, the (N, K) copy the planner caches; built
    here when absent; at K >= ``MAX_S8_K``, where int8 sums may leave the
    exact range, in f32 as the reference computes them), on the bf16
    tensor cores for f32 ``w`` (over ``w_bf16x3``, its three-term bf16
    split, which the planner caches; built per call when absent). Both
    routes are
    bit-exact for integer weights; for f32 weights "lut" replays the
    defined fold exactly and "unpack" is held to a tolerance.

    ``cpu_branch=True`` resolves ``route`` by ``_resolve_route`` instead
    (``occupancy``, a calibrated chunk occupancy, sizes "lut_sparse"'s
    budget) and runs the reference's CPU ops: the gather folds, dense or
    skipping zero chunks, on the bit-transposed index bytes, or one f32
    dot over all t unpacked planes.
    """
    g = x_packed.shape[0]
    if g != num_plane_groups(t):
        raise ValueError(f"{g} plane groups cannot hold t={t} timesteps")
    lead, k = x_packed.shape[1:-1], x_packed.shape[-1]
    m, n = math.prod(lead), w.shape[-1]
    if cpu_branch:
        resolved = _resolve_route(route, table, m=m, k=k, n=n, g=g, t=t,
                                  weights_are_int=lut.is_int_kernel(w),
                                  constants=route_constants,
                                  occupancy=occupancy)
        if resolved == "unpack":
            per = ref.spike_matmul_ref(x_packed.reshape(g, m, k), w, t=t)
        else:
            tbl = table if _have_table(table) else lut.build_lut(w)
            per = _cpu_gather(lut.plane_indices(x_packed)[:t], tbl,
                              resolved, occupancy)
        if bias is not None:
            per = per + bias.to(per.dtype)
        return per.reshape(t, *lead, n)
    impl = _PLAIN if plain else _WRAPPERS
    resolved = _resolve_route_cuda(route, table, m=m, k=k, n=n, g=g, t=t,
                                   weights_are_int=lut.is_int_kernel(w),
                                   constants=route_constants)
    x2 = x_packed.reshape(g, m, k)
    if resolved == "lut":
        tbl = table if _have_table(table) else lut.build_lut(w)
        per = impl.lut(x2.contiguous(), tbl, t=t)              # (t, M, N)
    elif w.dtype == torch.int8 and k < MAX_S8_K:
        wk = kmajor_weights(w) if w_kmajor is None else w_kmajor
        per = impl.unpack_s8(x2.contiguous(), wk, t=t)
    else:
        per = impl.unpack(x2.contiguous(), w.to(torch.float32), t=t,
                          w_bf16x3=w_bf16x3)
    if bias is not None:
        per = per + bias.to(per.dtype)
    return per.reshape(t, *lead, n)


def sssc_linear(x_u8, w, bias=None, *, route=None, table=None,
                route_constants=None, occupancy=None, plain: bool = False,
                cpu_branch: bool = False):
    """Packed SSSC: (..., K) uint8 pixel values x (K, N) -> (..., N) f32,
    ``y = sum_p 2^p (plane_p . W)``.

    "lut" gathers the 8 value planes from ``table`` and combines them in
    the defined ascending order (``lut.shift_sum_fold``), bit-exact for any
    weights. "unpack" runs the shift-sum kernel, one dot over the byte
    values, as the reference's Pallas branch does: exact for integer
    weights, held to a tolerance for f32. ``cpu_branch=True`` runs the
    reference's CPU ops as ``spike_linear`` does (``occupancy`` is the
    chunk occupancy of the transposed value bytes); its "unpack" is one
    dot over the 8 value planes, scaled by 2^p and summed.
    """
    lead, k = x_u8.shape[:-1], x_u8.shape[-1]
    x2 = x_u8.reshape(-1, k)
    m, n = x2.shape[0], w.shape[-1]
    if cpu_branch:
        resolved = _resolve_route(route, table, m=m, k=k, n=n, g=1, t=8,
                                  weights_are_int=lut.is_int_kernel(w),
                                  constants=route_constants,
                                  occupancy=occupancy)
        if resolved == "unpack":
            y = ref.spike_matmul_ref(x2, w, mode="shift_sum")
        else:
            tbl = table if _have_table(table) else lut.build_lut(w)
            y = lut.shift_sum_fold(_cpu_gather(
                lut.plane_indices(x2[None]), tbl, resolved, occupancy))
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y.reshape(*lead, n)
    impl = _PLAIN if plain else _WRAPPERS
    resolved = _resolve_route_cuda(route, table, m=m, k=k, n=n, g=1, t=8,
                                   weights_are_int=lut.is_int_kernel(w),
                                   constants=route_constants)
    if resolved == "lut":
        tbl = table if _have_table(table) else lut.build_lut(w)
        # the 8 value bits of a byte are 8 planes of one group
        y = lut.shift_sum_fold(impl.lut(x2[None].contiguous(), tbl, t=8))
    else:
        y = spike_matmul(x2, w, mode="shift_sum", plain=plain)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.reshape(*lead, n)


def _filled(v, n: int, device) -> torch.Tensor:
    """``v`` as an (n,) f32 vector on ``device``: a Python number becomes a
    constant made there once (no host-to-device copy a call), a tensor is
    broadcast."""
    if isinstance(v, torch.Tensor):
        return torch.broadcast_to(v.to(device, torch.float32), (n,))
    v = float(v)
    return constant(("filled_f32", v, n), device, lambda d: torch.full(
        (n,), v, dtype=torch.float32, device=d))


def _period_vector(v, lead, device) -> torch.Tensor:
    """A bias/threshold broadcast against ``lead`` as the shortest vector
    the TFLIF kernel tiles over the flattened neurons: one value, one per
    trailing channel, or (only for other broadcasts) one per neuron."""
    if not isinstance(v, torch.Tensor):
        return _filled(v, 1, device)
    v = v.to(device, torch.float32)
    if v.numel() == 1:
        return v.reshape(1)
    if v.dim() == 1 and lead and v.shape[0] == lead[-1]:
        return v.contiguous()
    return torch.broadcast_to(v, lead).reshape(-1).contiguous()


def tflif_pack(acc, bias=None, *, t: int | None = None, tau: float = TAU,
               v_th=V_TH, plain: bool = False):
    """Batched TFLIF: (T, ...) f32 accumulators -> (G, ...) uint8 plane
    groups. ``bias`` and ``v_th`` broadcast against ``acc.shape[1:]`` (a
    per-channel ``v_th`` carries the int8 weight-scale fold); ``t`` keeps
    the first t steps. ``acc`` may be expanded over T (stride 0, as SSSC
    conv0's image-constant accumulators are): the kernel reads its one row
    for every step, and no copy is made."""
    if t is not None and t != acc.shape[0]:
        acc = acc[:t]
    t = acc.shape[0]
    lead = tuple(acc.shape[1:])
    x2 = acc.reshape(t, -1).to(torch.float32)     # a view where it can be
    if x2.shape[1] > 1 and x2.stride(1) != 1:
        x2 = x2.contiguous()      # a stride-0 step axis is taken as it is
    b = _period_vector(0.0 if bias is None else bias, lead, acc.device)
    vth = _period_vector(v_th, lead, acc.device)
    packed = (_PLAIN if plain else _WRAPPERS).tflif(x2, b, vth, tau=tau)
    return packed.reshape(packed.shape[0], *lead)


def _channel_vector(v, k: int, device) -> torch.Tensor:
    """A scalar or (K,) producer bias/threshold as a (K,) f32 vector."""
    return _filled(v, k, device).contiguous()


def tflif_lut(acc, bias=None, *, table, v_th=V_TH, t: int | None = None,
              tau: float = TAU, plain: bool = False):
    """Fused LIF -> pack -> byte-LUT matmul over a producer/consumer pair
    (the MLP's fc1 -> fc2 step).

    ``acc``: (T, ..., K) f32 producer accumulators (producer bias not
    added: ``bias``, None, a scalar or (K,), enters the LIF charge as in
    ``tflif_pack``); ``v_th``: scalar or (K,) (the int8 scale fold);
    ``table``: the consumer's real (C, 256, N) table; ``t`` keeps the first
    t steps. Returns ``(spikes, acc2)``: spikes (G, ..., K) uint8, the
    producer's packed output, and acc2 (t, ..., N) f32, the consumer's
    accumulators (consumer bias not added). One launch of the fused kernel;
    bit-exact against the unfused composition, so it never changes logits.
    """
    if not _have_table(table):
        raise ValueError("tflif_lut requires a real (C, 256, N) table — "
                         "the fused step is a gather by definition; build "
                         "one with lut_matmul.build_lut")
    if t is not None and t != acc.shape[0]:
        acc = acc[:t]
    t = acc.shape[0]
    lead, k = acc.shape[1:-1], acc.shape[-1]
    x3 = acc.reshape(t, -1, k).to(torch.float32).contiguous()
    b = _channel_vector(0.0 if bias is None else bias, k, acc.device)
    vth = _channel_vector(v_th, k, acc.device)
    spikes, acc2 = (_PLAIN if plain else _WRAPPERS).fused(
        x3, b, table.contiguous(), vth, tau=tau)
    return (spikes.reshape(spikes.shape[0], *lead, k),
            acc2.reshape(t, *lead, table.shape[-1]))


STDP_LUT_MIN_TOKENS = 128  # below this, score-table builds cannot amortize


def stdp_attention_packed(q_packed, k_packed, v_packed, *, t: int,
                          scale: float, plain: bool = False,
                          route: str | None = None,
                          cpu_branch: bool = False):
    """Packed STDP over (G, ..., N, Dh) uint8 temporal plane groups ->
    (t, ..., N, Dh) f32. Timesteps attend independently; one launch of the
    packed kernel reads the plane bits straight from the bytes (the plain
    version unpacks them and folds the t planes into the batch-heads
    axis).

    ``cpu_branch=True`` runs the reference's CPU branch, where ``route``
    picks: None or "unpack", the plain version; "lut", the score LUT,
    Q K^T by byte gather over per-(t, batch-head) tables built from the
    unpacked K, then the products with V; "auto", "lut" from
    ``STDP_LUT_MIN_TOKENS`` tokens up while the tables stay within
    ``lut.MAX_TABLE_BYTES``. Binary q, k, v keep every sum an exact
    integer, so the routes agree bit for bit."""
    if not cpu_branch:
        return (_PLAIN if plain else _WRAPPERS).stdp_packed(
            q_packed, k_packed, v_packed, t=t, scale=scale)
    g, lead = q_packed.shape[0], q_packed.shape[1:-2]
    n, dh = q_packed.shape[-2:]
    bh = math.prod(lead)
    if route == "auto":
        tables_bytes = t * bh * lut.num_k_chunks(dh) * 256 * n * 4
        route = ("lut" if n >= STDP_LUT_MIN_TOKENS
                 and tables_bytes <= lut.MAX_TABLE_BYTES else "unpack")
    if route in (None, "unpack"):
        return stdp_attention_packed_plain(q_packed, k_packed, v_packed,
                                           t=t, scale=scale)
    if route != "lut":
        raise ValueError(f"unknown packed-stdp route {route!r}")
    idx_q = lut.plane_indices(q_packed.reshape(g, bh * n, dh))[:t].reshape(
        t, bh, n, -1)                                     # (t, BH, N, C)
    k_pl, v_pl = (unpack_timesteps(z.reshape(g, bh, n, dh), t)
                  for z in (k_packed, v_packed))          # (t, BH, N, Dh)
    kt = k_pl.transpose(-1, -2).reshape(t * bh, dh, n)
    tables = torch.stack([lut.build_lut(w) for w in kt]).reshape(
        t, bh, -1, 256, n)                                # (t,BH,C,256,N)
    ti = torch.arange(t, device=idx_q.device)[:, None, None]
    bi = torch.arange(bh, device=idx_q.device)[None, :, None]
    s = tables[ti, bi, 0, idx_q[..., 0].long()]
    for c in range(1, tables.shape[2]):
        s = s + tables[ti, bi, c, idx_q[..., c].long()]   # (t, BH, N, N)
    out = torch.einsum("tbnm,tbmd->tbnd", s, v_pl) * scale
    return out.reshape(t, *lead, n, dh)


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    plain: bool = False):
    """Softmax attention (the LM stack's kernel). q: (B, Hq, Nq, Dh); k, v:
    (B, KV, Nkv, Dh) with Hq a multiple of KV (grouped-query heads read in
    place), or all three (BH, N, Dh); f32 or bf16, any strides with a unit
    last stride; causal over absolute positions (query i at
    ``Nkv - Nq + i``). Returns f32 of q's shape; callers cast to their
    compute dtype.

    The kernel has no backward (nor has the reference's Pallas kernel):
    its output is written through ``ctypes``, where autograd cannot see,
    so a gradient through it would silently be zero. With grad mode on
    and an operand that requires grad, this raises, on the card and on
    the CPU alike; training runs the plain chunked softmax
    (``nn.transformer.lm_loss(..., flash=False)``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: an operand requires grad. "
            "Train with flash=False (the plain chunked softmax), or call it "
            "under torch.no_grad()")
    return (_PLAIN if plain else _WRAPPERS).flash(q, k, v, scale=scale,
                                                  causal=causal)
