"""Where the port's entry points run (the card unless the caller asks for
the CPU), and the constants a step keeps on its device."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one, fail and name the CPU
    option."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain versions of the kernels on the "
                           "CPU")
    return device


_CONSTANTS: dict = {}


def constant(key, device, make) -> torch.Tensor:
    """The tensor ``make(device)``, made once per ``key`` and device and
    kept: a step's constants (a threshold, a lookup table) reach the card
    without a host-to-device copy each call, which would also stop a CUDA
    graph capture. It must first be made outside a capture: a tensor made
    while a graph records holds its values only once the graph replays."""
    device = torch.device(device)
    found = _CONSTANTS.get((key, device))
    if found is None:
        if (device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                f"constant {key!r} was first needed inside a CUDA graph "
                "capture; run the step once eagerly before capturing it")
        found = _CONSTANTS[(key, device)] = make(device)
    return found
