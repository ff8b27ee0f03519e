"""int8 weight quantization for the packed datapath (port of
``repro.infer.quant``).

Every BN-folded kernel becomes int8 with a per-output-channel symmetric
scale that is never applied to the accumulators: it folds into the LIF
bias and threshold (``bias/s``, ``v_th/s``), so the packed route runs LIF on
exact integer sums. STDP has no weights and the head stays float.
"""
from __future__ import annotations

import torch

WEIGHT_DTYPES = ("float32", "int8")


def map_folded_layers(folded: dict, fn) -> dict:
    """Apply ``fn(path, layer) -> layer`` to every conv/linear layer dict of
    a folded tree ("scs/conv0", "blocks/b0/ssa/wq", ...), passing every
    other top-level key (head, ...) through."""
    out = dict(folded)
    out["scs"] = {name: fn(f"scs/{name}", layer)
                  for name, layer in folded["scs"].items()}
    out["blocks"] = {
        bname: {grp: {wn: fn(f"blocks/{bname}/{grp}/{wn}", layer)
                      for wn, layer in sub.items()}
                for grp, sub in blk.items()}
        for bname, blk in folded["blocks"].items()}
    return out


def quantize_layer(layer: dict) -> dict:
    """{kernel, bias} -> {kernel: int8, scale: (N,) f32, bias}, symmetric
    over the output-channel (last) axis. ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    w = layer["kernel"].to(torch.float32)
    amax = w.abs().amax(dim=tuple(range(w.dim() - 1)))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"kernel": wq, "scale": scale, "bias": layer["bias"]}


def quantize_folded(folded: dict) -> dict:
    """Quantize every SCS conv and SSA/MLP linear of a folded tree to int8
    (each gains a ``scale`` leaf); the float head passes through."""
    return map_folded_layers(folded, lambda _, layer: quantize_layer(layer))
