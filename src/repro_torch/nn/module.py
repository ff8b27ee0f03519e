"""Parameter trees, initializers and tree helpers (port of
``repro.nn.module``).

Params are nested dicts of tensors; every layer is an ``init(gen, ...)`` /
``apply(params, x, ...)`` pair, as in the reference. Random numbers come
from ``torch.Generator`` streams: the same seed gives the same tree, but
not the reference's bits (parity tests carry the reference's tree across
with ``repro_torch.weights.lm_from_reference``). Under ``with
torch.device("meta")`` an init draws nothing and gives the tree's shapes
and dtypes only (``launch.steps.abstract_params``).

A leaf's path is its keys joined by ``/`` (``"layers/attn/wq/kernel"``),
and trees are walked in sorted key order, as ``jax.tree_util`` flattens a
dict: the path strings and their order are the reference's, so a
checkpoint's leaves carry the same names in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator

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


def _draw_device(gen) -> torch.device:
    """Where a draw from ``gen`` lands: ``gen``'s device, or the meta
    device inside ``with torch.device("meta")``, where nothing is drawn."""
    if torch.get_default_device().type == "meta":
        return torch.device("meta")
    return gen.device


def _draw(gen, shape) -> torch.Tensor:
    x = torch.empty(shape, dtype=torch.float32, device=_draw_device(gen))
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
    out = torch.empty(shape, dtype=dtype, device=_draw_device(gen))
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


# ---------------------------------------------------------------------------
# tree utilities
# ---------------------------------------------------------------------------


def _key_str(k) -> str:
    return str(k)


def _children(tree):
    """(key, subtree) pairs of a dict (sorted by key, as JAX flattens it)
    or a list or tuple (by index); None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_paths(params: Params) -> Iterator[tuple[str, Any]]:
    """Yield ('a/b/c', leaf) pairs of a nested dict (or list) tree, in the
    reference's order."""
    def walk(tree, prefix):
        kids = _children(tree)
        if kids is None:
            yield "/".join(prefix), tree
            return
        for k, sub in kids:
            yield from walk(sub, prefix + (_key_str(k),))
    yield from walk(params, ())


def map_with_path(fn: Callable[[str, Any], Any], tree: Params) -> Params:
    """A tree of the same layout with ``fn('a/b/c', leaf)`` at each leaf,
    called in the reference's order."""
    def walk(tree, prefix):
        kids = _children(tree)
        if kids is None:
            return fn("/".join(prefix), tree)
        out = {k: walk(sub, prefix + (_key_str(k),)) for k, sub in kids}
        if isinstance(tree, dict):
            return {k: out[k] for k in tree}
        return type(tree)(out[i] for i in range(len(tree)))
    return walk(tree, ())


def copy_tree(dst: Params, src: Params) -> None:
    """Every leaf of ``src`` copied in place into the same leaf of ``dst``
    (a tree of the same paths; a leaf that already is ``dst``'s is left
    as it is)."""
    new = dict(tree_paths(src))
    for p, t in tree_paths(dst):
        if new[p] is not t:
            t.copy_(new[p])


def cast_tree(tree: Params, dtype) -> Params:
    """Floating leaves cast to ``dtype``; the others kept."""
    return map_with_path(
        lambda _, x: x.to(dtype) if x.is_floating_point() else x, tree)


@dataclasses.dataclass(frozen=True)
class DTypes:
    """Mixed-precision policy."""

    param: Any = torch.float32     # storage dtype of weights
    compute: Any = torch.bfloat16  # matmul dtype
    accum: Any = torch.float32     # reductions / softmax / losses
