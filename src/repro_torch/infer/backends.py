"""The packed execution backend for the BN-folded Spikformer graph (port
of ``repro.infer.backends.PackedBackend``, Pallas branch).

Spikes are packed uint8 plane groups — a leading axis of G = ceil(T/8)
bytes per neuron, bit j of group g = timestep 8g+j — dispatched through
``kernels.ops``: the CUDA kernels for tensors on the card, their plain
versions on the CPU, or the plain versions everywhere with
``plain=True``. A layer carrying a ``scale`` leaf is int8: its scale folds
into the LIF bias and threshold, never the accumulator. A layer carrying a
``lut`` leaf (the planner's (C, 256, N) table) runs the byte-LUT gather;
others run the grouped unpack dot.
"""
from __future__ import annotations

import torch

from . import registry
from ..core.lif import V_TH
from ..core.spike import space_to_depth
from ..kernels import ops

# set bits of every byte value: the popcount rate readout
_POPCOUNT = torch.tensor([bin(b).count("1") for b in range(256)],
                         dtype=torch.int32)


class PackedBackend:
    """Packed-spike backend. ``plain=True`` runs every kernel's plain
    version even on the card — the oracle the ``packed_cuda`` route is held
    against."""

    wants_lut_tables = True

    def __init__(self, *, plain: bool = False):
        self.plain = plain

    def _lif(self, acc, bias, scale):
        """acc (T, ...) -> (G, ...) packed; int8 layers fold their
        per-channel scale into the bias/threshold, in the reference's op
        order (``bias / scale``, ``V_TH / scale`` in f32)."""
        if scale is None:
            return ops.tflif_pack(acc, bias, plain=self.plain)
        return ops.tflif_pack(acc, bias / scale, v_th=V_TH / scale,
                              plain=self.plain)

    @staticmethod
    def _w(kernel, scale):
        """How a kernel enters the packed matmul: int8 as f32 integers."""
        return kernel if scale is None else kernel.to(torch.float32)

    def sssc_lif(self, images_u8, kernel, bias, *, t: int, scale=None,
                 lut=None):
        x = space_to_depth(images_u8, 2)                # (B,H/2,W/2,4C) u8
        acc = ops.sssc_linear(x, self._w(kernel, scale), None, table=lut,
                              plain=self.plain)
        acc = acc.unsqueeze(0).expand(t, *acc.shape)    # image constant in T
        return self._lif(acc, bias, scale)              # (G,B,H/2,W/2,F) u8

    def zsc_lif(self, x, kernel, bias, *, t: int, scale=None, lut=None):
        acc = ops.spike_linear(space_to_depth(x, 2), self._w(kernel, scale),
                               None, t=t, table=lut, plain=self.plain)
        return self._lif(acc, bias, scale)

    def wssl_lif(self, x, kernel, bias, *, t: int, scale=None, lut=None):
        acc = ops.spike_linear(x, self._w(kernel, scale), None, t=t,
                               table=lut, plain=self.plain)
        return self._lif(acc, bias, scale)

    def mlp_pair_lif(self, x, fc1, fc2, *, t: int):
        """The fused fc1 -> LIF -> fc2 kernel of the reference
        (``kernels/fused.py``) is not ported yet: None tells
        ``forward_folded`` to run the two layers one after the other."""
        return None

    def stdp_lif(self, q, k, v, *, heads: int, scale: float, t: int):
        g, b, n, d = q.shape
        dh = d // heads

        def to_heads(z):
            return z.reshape(g, b, n, heads, dh).permute(0, 1, 3, 2, 4)

        acc = ops.stdp_attention_packed(to_heads(q), to_heads(k), to_heads(v),
                                        t=t, scale=scale, plain=self.plain)
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
        counts = _POPCOUNT.to(x.device)[x.long()].sum(dim=0)
        return (counts.to(torch.float32) / float(t)).mean(dim=1)


# "packed_cuda" is the counterpart of the reference's "packed_pallas": the
# CUDA kernels on the card, their plain versions on the CPU. "packed_plain"
# runs the plain versions on any device: the oracle route.
registry.register_backend("packed_cuda", PackedBackend)
registry.register_backend("packed_plain", lambda: PackedBackend(plain=True))
