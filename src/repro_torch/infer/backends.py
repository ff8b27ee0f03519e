"""Execution backends for the BN-folded Spikformer graph (port of
``repro.infer.backends``).

  FloatBackend  - spikes are {0,1} f32 tensors with a leading T axis; every
                  op runs through ``core.unified`` and ``core.lif.tflif``:
                  the reference the packed route is held to.
  PackedBackend - spikes are packed uint8 plane groups, a leading axis of
                  G = ceil(T/8) bytes per neuron, bit j of group g =
                  timestep 8g+j, dispatched through ``kernels.ops``: the
                  CUDA kernels for tensors on the card, their plain
                  versions on the CPU, or the plain versions everywhere
                  with ``plain=True`` (the reference's Pallas branch);
                  with ``pallas=False``, the reference's CPU branch
                  (``ops``' ``cpu_branch``: the CPU route chooser, the
                  zero-chunk-skipping gather, the STDP score LUT).

A layer carrying a ``scale`` leaf is int8: its scale folds into the LIF
bias and threshold, never the accumulator, in both backends. The packed
backend hands int8 kernels to the matmul as they are (the unpack route
runs them on the int8 tensor cores, over the ``kernel_kmajor`` leaf the
planner caches; the gather route reads only its table), and f32 unpack
layers their ``kernel_bf16x3`` leaf, the weights' three-term bf16 split
the f32 unpack dot reads on the bf16 tensor cores; the float backend
casts them to f32. A layer
carrying a ``lut`` leaf is LUT-planned: the packed backend gathers from the
(C, 256, N) table; the float backend, which the planner hands only a True
flag, replays the same fold on float planes (``lut_matmul_planes``)
instead of its single dot. So both backends of a parity pair, compiled from
one plan, give bit-identical logits on the LUT routes and on every int8
route; only the f32 unpack dot is held to a tolerance.

The occupancy readouts (``spike_occupancy``, ``chunk_occupancy``,
``value_chunk_occupancy``) read sparsity off the packed bytes, and
``OccupancyRecorder`` notes the chunk occupancy of every linear layer's
input in one forward: what ``infer.compile.calibrate_layer_occupancy``
commits to a plan's ``layer_occupancy``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import registry
from ..core import unified
from ..core.lif import V_TH, tflif
from ..core.spike import (bitplanes_u8, packed_occupancy, rate_decode,
                          space_to_depth)
from ..device import constant
from ..kernels import lut_matmul as lut
from ..kernels import ops
from ..kernels.fused import fused_fits

# set bits of every byte value: the popcount rate readout
_POPCOUNT = torch.tensor([bin(b).count("1") for b in range(256)],
                         dtype=torch.int32)


# ---------------------------------------------------------------------------
# Occupancy readouts: sparsity read off the packed bytes, as host floats
# (calibration and telemetry, not step ops)
# ---------------------------------------------------------------------------

def spike_occupancy(x_packed, t: int) -> float:
    """Firing rate of a packed spike tensor: set bits over the ``t`` live
    planes (``core.spike.packed_occupancy``, which the event front end's
    per-window readout shares)."""
    return packed_occupancy(x_packed, t)


def chunk_occupancy(x_packed, t: int) -> float:
    """CHUNK occupancy of a packed spike tensor: the fraction of nonzero
    per-plane chunk-index bytes, what the zero-chunk-skipping gather
    scales with and ``choose_route``/``sparse_budget`` take as
    ``occupancy``. The count is an exact integer, scaled in f32 by the f32
    reciprocal of the byte count: how XLA computes the reference's f32
    mean of 0/1 values (a divide by a constant becomes a multiply), bit
    for bit below 2^24 bytes."""
    idx = lut.plane_indices(torch.as_tensor(x_packed))[:t]
    count = int(torch.count_nonzero(idx))
    return float(np.float32(count) * (np.float32(1) / np.float32(idx.numel())))


def value_chunk_occupancy(x_u8) -> float:
    """Chunk occupancy of uint8 value bytes (the SSSC operand): their 8
    bit planes are the LUT index source directly."""
    return chunk_occupancy(torch.as_tensor(x_u8)[None], 8)


class FloatBackend:
    """Reference backend: float spike trains through ``core.unified``."""

    name = "reference"

    @staticmethod
    def _acc_and_vth(op, x, kernel, bias, scale):
        """Pre-LIF accumulator and threshold of ``op(x, kernel, bias)``;
        int8 layers fold the per-channel scale into the bias and
        threshold, the float emulation of the packed int8 math."""
        if scale is None:
            return op(x, kernel, bias), V_TH
        acc = op(x, kernel.to(torch.float32), None) + (bias / scale)
        return acc, V_TH / scale

    # fold-order emulations of the byte-LUT route, with the signatures of
    # the ``core.unified`` ops they stand in for

    @staticmethod
    def _wssl_emu(spikes, kernel, bias=None):
        t, lead, d = spikes.shape[0], spikes.shape[1:-1], spikes.shape[-1]
        y = lut.lut_matmul_planes(spikes.reshape(t, -1, d), kernel)
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y.reshape(t, *lead, kernel.shape[-1])

    @classmethod
    def _zsc_emu(cls, spikes, kernel, bias=None):
        return cls._wssl_emu(space_to_depth(spikes, 2),
                             kernel.reshape(-1, kernel.shape[-1]), bias)

    @staticmethod
    def _sssc_emu(image_u8, kernel, bias=None):
        x = space_to_depth(image_u8, 2)                 # (B, h, w, 4C) u8
        planes = bitplanes_u8(x).reshape(8, -1, x.shape[-1])
        y = lut.shift_sum_fold(lut.lut_matmul_planes(planes, kernel))
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y.reshape(*x.shape[:-1], kernel.shape[-1])

    # ``occupancy`` (a sparse-routed layer's calibration) is accepted and
    # ignored: skipping zero chunks drops exact-zero entries from the fold,
    # whose emulation is the same ``lut_matmul_planes`` replay

    def sssc_lif(self, images_u8, kernel, bias, *, t: int, scale=None,
                 lut=None, occupancy=None):
        op = unified.sssc if lut is None else self._sssc_emu
        y, vth = self._acc_and_vth(op, images_u8, kernel, bias, scale)
        y = y.unsqueeze(0).expand(t, *y.shape)          # image constant in T
        return tflif(y, v_th=vth)

    def zsc_lif(self, x, kernel, bias, *, t: int, scale=None, lut=None,
                kmajor=None, bf16x3=None, occupancy=None):
        op = unified.zsc if lut is None else self._zsc_emu
        y, vth = self._acc_and_vth(op, x, kernel, bias, scale)
        return tflif(y, v_th=vth)

    def wssl_lif(self, x, kernel, bias, *, t: int, scale=None, lut=None,
                 kmajor=None, bf16x3=None, occupancy=None):
        op = unified.wssl if lut is None else self._wssl_emu
        y, vth = self._acc_and_vth(op, x, kernel, bias, scale)
        return tflif(y, v_th=vth)

    def stdp_lif(self, q, k, v, *, heads: int, scale: float, t: int):
        tt, b, n, d = q.shape
        dh = d // heads

        def to_heads(z):
            return z.reshape(tt, b, n, heads, dh).permute(0, 1, 3, 2, 4)

        att = unified.stdp(to_heads(q), to_heads(k), to_heads(v), scale=scale)
        att = tflif(att)                                # (T, B, H, N, dh)
        return att.permute(0, 1, 3, 2, 4).reshape(tt, b, n, d)

    def residual(self, new, res, mode: str):
        if mode == "iand":
            return (1.0 - new) * res
        return new + res

    def to_tokens(self, x):
        tt, b, h, w, c = x.shape
        return x.reshape(tt, b, h * w, c)

    def rate(self, x, *, t: int):
        return rate_decode(x, axis=0).mean(dim=1)       # (B, D)


class PackedBackend:
    """Packed-spike backend.

    ``pallas`` picks the branch, as the reference's does: True runs every
    op through the kernel wrappers (the CUDA kernels for tensors on the
    card, their plain versions on the CPU), False the reference's CPU
    branch (``ops``' ``cpu_branch``) on whatever device the tensors are
    on. ``plain=True`` runs every kernel's plain version even on the card:
    the oracle the kernel routes are held against. ``fuse_mlp`` runs the
    MLP's fc1 -> LIF -> fc2 step through the fused kernel wherever fc2
    carries a table (``mlp_pair_lif``; never on the CPU branch). ``name``
    is the registered name the instance was made under."""

    def __init__(self, *, plain: bool = False, fuse_mlp: bool = True,
                 pallas: bool = True, name: str = "packed_cuda"):
        self.pallas = bool(pallas)
        self.plain = plain or not self.pallas
        self.fuse_mlp = fuse_mlp
        self.name = name

    def _lif(self, acc, bias, scale):
        """acc (T, ...) -> (G, ...) packed; int8 layers fold their
        per-channel scale into the bias/threshold, in the reference's op
        order (``bias / scale``, ``V_TH / scale`` in f32)."""
        if scale is None:
            return ops.tflif_pack(acc, bias, plain=self.plain)
        return ops.tflif_pack(acc, bias / scale, v_th=V_TH / scale,
                              plain=self.plain)

    # Kernels enter the matmuls as the tree holds them: an int8 kernel is
    # cast to f32 only inside the f32 consumers (the shift-sum dot of
    # conv0's SSSC, the plain versions), never on the gather or s8 routes.
    # ``occupancy`` is a sparse-routed layer's calibration; only the CPU
    # branch reads it (the kernels' gather is dense, and bitwise the same).

    def _linear(self, x, kernel, *, t, lut, kmajor, bf16x3, occupancy):
        return ops.spike_linear(x, kernel, None, t=t, table=lut,
                                w_kmajor=kmajor, w_bf16x3=bf16x3,
                                occupancy=occupancy,
                                plain=self.plain, cpu_branch=not self.pallas)

    def sssc_lif(self, images_u8, kernel, bias, *, t: int, scale=None,
                 lut=None, occupancy=None):
        x = space_to_depth(images_u8, 2)                # (B,H/2,W/2,4C) u8
        acc = ops.sssc_linear(x, kernel, None, table=lut,
                              occupancy=occupancy, plain=self.plain,
                              cpu_branch=not self.pallas)
        acc = acc.unsqueeze(0).expand(t, *acc.shape)    # image constant in T
        return self._lif(acc, bias, scale)              # (G,B,H/2,W/2,F) u8

    def zsc_lif(self, x, kernel, bias, *, t: int, scale=None, lut=None,
                kmajor=None, bf16x3=None, occupancy=None):
        acc = self._linear(space_to_depth(x, 2), kernel, t=t, lut=lut,
                           kmajor=kmajor, bf16x3=bf16x3, occupancy=occupancy)
        return self._lif(acc, bias, scale)

    def wssl_lif(self, x, kernel, bias, *, t: int, scale=None, lut=None,
                 kmajor=None, bf16x3=None, occupancy=None):
        acc = self._linear(x, kernel, t=t, lut=lut, kmajor=kmajor,
                           bf16x3=bf16x3, occupancy=occupancy)
        return self._lif(acc, bias, scale)

    def mlp_pair_lif(self, x, fc1, fc2, *, t: int, occupancy=None):
        """The MLP pair as fc1's matmul, then fc1's LIF, the packing and
        fc2's gather in one fused kernel (``ops.tflif_lut``), then fc2's
        LIF: bit-identical to the two-layer path, without fc1's packed
        spikes making a round trip through device memory. None, which
        tells ``forward_folded`` to run the two layers, on the CPU branch,
        when ``fuse_mlp`` is off, fc2 carries no real table, or the fused
        kernel cannot take the shape (``fused_fits``: more than 64 steps
        or row tiles past the grid); the decision does not depend on the
        device. ``occupancy`` is fc1's input calibration."""
        tbl2 = fc2.get("lut")
        rows = math.prod(x.shape[1:-1])
        if not (self.pallas and self.fuse_mlp and ops._have_table(tbl2)
                and fused_fits(t, rows)):
            return None
        scale1 = fc1.get("scale")
        acc1 = self._linear(x, fc1["kernel"], t=t, lut=fc1.get("lut"),
                            kmajor=fc1.get("kernel_kmajor"),
                            bf16x3=fc1.get("kernel_bf16x3"),
                            occupancy=occupancy)
        # fc1's int8 scale folds into its LIF exactly as in ``_lif``
        b1 = fc1["bias"] if scale1 is None else fc1["bias"] / scale1
        v1 = V_TH if scale1 is None else V_TH / scale1
        _, acc2 = ops.tflif_lut(acc1, b1, table=tbl2, v_th=v1, t=t,
                                plain=self.plain)
        return self._lif(acc2, fc2["bias"], fc2.get("scale"))

    def stdp_lif(self, q, k, v, *, heads: int, scale: float, t: int):
        g, b, n, d = q.shape
        dh = d // heads

        def to_heads(z):
            return z.reshape(g, b, n, heads, dh).permute(0, 1, 3, 2, 4)

        # the CPU branch picks its score route by token count ("auto"):
        # binary q, k, v keep every route's sums exact
        acc = ops.stdp_attention_packed(to_heads(q), to_heads(k), to_heads(v),
                                        t=t, scale=scale, plain=self.plain,
                                        route="auto",
                                        cpu_branch=not self.pallas)
        att = ops.tflif_pack(acc, plain=self.plain)     # (G, B, H, N, dh) u8
        return att.permute(0, 1, 3, 2, 4).reshape(g, b, n, d)

    def residual(self, new, res, mode: str):
        if mode != "iand":
            raise ValueError("packed activations are strictly binary; "
                             f"residual mode {mode!r} is not supported")
        # SEW IAND on packed bytes: (NOT new) AND res; dead bits of res are
        # zero, so the complement's dead bits vanish
        return torch.bitwise_and(torch.bitwise_not(new), res)

    def to_tokens(self, x):
        g, b, h, w, c = x.shape
        return x.reshape(g, b, h * w, c)

    def rate(self, x, *, t: int):
        # popcount readout: exact integer counts, then the reference's
        # divide by t and mean over tokens
        popcount = constant("popcount_i32", x.device, _POPCOUNT.to)
        counts = popcount[x.long()].sum(dim=0)
        return (counts.to(torch.float32) / float(t)).mean(dim=1)


class OccupancyRecorder(PackedBackend):
    """A CPU-branch ``PackedBackend`` that records, in forward-call order,
    the chunk occupancy of every linear layer's packed matmul operand:
    ``infer.compile.calibrate_layer_occupancy`` runs one eager forward
    through it and zips ``trace`` with ``linear_layer_paths``. The layers
    run the dense routes (no occupancy is passed on), so calibration never
    depends on the decisions it informs."""

    def __init__(self):
        super().__init__(pallas=False, name="packed")
        self.trace: list[float] = []

    def sssc_lif(self, images_u8, kernel, bias, *, t: int, scale=None,
                 lut=None, occupancy=None):
        self.trace.append(value_chunk_occupancy(space_to_depth(images_u8, 2)))
        return super().sssc_lif(images_u8, kernel, bias, t=t, scale=scale,
                                lut=lut)

    def zsc_lif(self, x, kernel, bias, *, t: int, scale=None, lut=None,
                kmajor=None, bf16x3=None, occupancy=None):
        self.trace.append(chunk_occupancy(space_to_depth(x, 2), t))
        return super().zsc_lif(x, kernel, bias, t=t, scale=scale, lut=lut)

    def wssl_lif(self, x, kernel, bias, *, t: int, scale=None, lut=None,
                 kmajor=None, bf16x3=None, occupancy=None):
        self.trace.append(chunk_occupancy(x, t))
        return super().wssl_lif(x, kernel, bias, t=t, scale=scale, lut=lut)


def _packed(*, device, pallas=None, fuse_mlp=True, interpret=None):
    """The reference's default backend, resolved by device: on the card
    (``pallas`` None or True) exactly what ``packed_cuda`` runs, the
    kernels; on the CPU, or with ``pallas=False``, the reference's CPU
    branch. ``pallas=True`` on the CPU runs the kernels' plain versions,
    as the reference's interpret mode does. ``interpret`` is taken and
    ignored, as the reference's factory does."""
    if pallas is None:
        pallas = device.type == "cuda"
    return PackedBackend(pallas=pallas, fuse_mlp=fuse_mlp, name="packed")


# "packed" is the reference's default backend (``_packed``). "packed_cuda"
# is the counterpart of the reference's "packed_pallas": the CUDA kernels
# on the card, their plain versions on the CPU. "packed_plain" runs the
# plain versions on any device: the oracle route. "reference" needs only
# the planner's flags, never the tables. Factories take keyword options
# only, so a misspelled ``backend_options`` key raises TypeError.
registry.register_backend("packed", _packed, takes_device=True)
registry.register_backend(
    "packed_cuda", lambda *, fuse_mlp=True: PackedBackend(fuse_mlp=fuse_mlp))
registry.register_backend(
    "packed_plain", lambda *, fuse_mlp=True: PackedBackend(
        plain=True, fuse_mlp=fuse_mlp, name="packed_plain"))
registry.register_backend("reference", FloatBackend, wants_lut_tables=False,
                          aliases=("float",))
