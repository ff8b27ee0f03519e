"""Parameter trees and initializers (port of ``repro.nn.module``).

Params are nested dicts of tensors; every layer is an ``init(gen, ...)`` /
``apply(params, x, ...)`` pair, as in the reference. Random numbers come
from ``torch.Generator`` streams: the same seed gives the same tree, but
not the reference's bits (parity tests carry the reference's tree across
with ``repro_torch.weights.lm_from_reference``).
"""
from __future__ import annotations

import math

import torch

Params = dict  # nested dict[str, Params | torch.Tensor]


class KeyStream:
    """Deterministic stream of generators: ``ks = KeyStream(gen); g = ks()``.
    Each child is a fresh generator on ``gen``'s device, seeded from the
    parent, so the tree does not depend on how much each layer draws."""

    def __init__(self, gen: torch.Generator):
        self._gen = gen

    def __call__(self) -> torch.Generator:
        dev = self._gen.device
        seed = int(torch.randint(0, 2 ** 62, (), generator=self._gen,
                                 device=dev))
        return torch.Generator(device=dev).manual_seed(seed)


# f32 bytes a non-f32 leaf is drawn in at a time
SLAB_BYTES = 64 << 20


def _draw(gen, shape) -> torch.Tensor:
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)


def trunc_normal(gen: torch.Generator, shape, std: float = 0.02,
                 dtype=torch.float32) -> torch.Tensor:
    """Normal truncated at +-2 standard deviations, times ``std``, drawn in
    f32 on ``gen``'s device. An f32 leaf is scaled in place (no second
    copy of a large table); any other dtype is drawn in slabs along the
    first axis of at most ``SLAB_BYTES`` of f32, each cast and scaled into
    its rows of the leaf, so a large bf16 leaf (128 experts' (2048, 768)
    kernels: 0.4 GB) never has an f32 copy beside it."""
    if dtype == torch.float32:
        return _draw(gen, shape).mul_(std)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = max(1, SLAB_BYTES // (4 * math.prod(shape[1:])))
    for i in range(0, shape[0], rows):
        part = out[i:i + rows]
        torch.mul(_draw(gen, part.shape).to(dtype), std, out=part)
    return out


def lecun_normal(gen: torch.Generator, shape, fan_in: int | None = None,
                 dtype=torch.float32) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    return trunc_normal(gen, shape, std=1.0 / math.sqrt(max(1, fan_in)),
                        dtype=dtype)


def zeros(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def leaves(params: Params):
    """The tensors of a tree, depth first."""
    if isinstance(params, dict):
        for v in params.values():
            yield from leaves(v)
    else:
        yield params


def param_count(params: Params) -> int:
    return sum(x.numel() for x in leaves(params))


def param_bytes(params: Params) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(params))
