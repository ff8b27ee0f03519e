"""Where the port's entry points run: the card unless the caller asks for
the CPU."""
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
