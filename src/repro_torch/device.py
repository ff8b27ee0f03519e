"""Where the port's entry points run (the card unless the caller asks for
the CPU), the constants a step keeps on its device, and the CUDA streams
its serving threads and graph captures borrow."""
from __future__ import annotations

import contextlib
import threading

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
_CONSTANTS_LOCK = threading.RLock()


def constant(key, device, make) -> torch.Tensor:
    """The tensor ``make(device)``, made once per ``key`` and device and
    kept: a step's constants (a threshold, a lookup table) reach the card
    without a host-to-device copy each call, which would also stop a CUDA
    graph capture. It must first be made outside a capture: a tensor made
    while a graph records holds its values only once the graph replays.
    Serving threads share the table, so it is filled under a lock: two
    threads never make one constant twice."""
    device = torch.device(device)
    found = _CONSTANTS.get((key, device))
    if found is None:
        with _CONSTANTS_LOCK:
            found = _CONSTANTS.get((key, device))
            if found is None:
                if (device.type == "cuda"
                        and torch.cuda.is_current_stream_capturing()):
                    raise RuntimeError(
                        f"constant {key!r} was first needed inside a CUDA "
                        "graph capture; run the step once eagerly before "
                        "capturing it")
                found = _CONSTANTS[(key, device)] = make(device)
    return found


_SPARE_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def borrow_stream(device) -> torch.cuda.Stream:
    """A CUDA stream of ``device`` that no other holder has: a released
    one when there is one, else a new one. Streams are reused, not made
    anew for each holder, because cuBLAS keeps a workspace (32 MiB on an
    H100) for every stream it has run on for the life of the process: a
    fleet that swaps plans would otherwise grow by one workspace per
    replica and swap. Exclusive, because a graph captured on a stream
    keeps that stream's workspace: two graphs replaying at once must not
    share one."""
    device = torch.device(device)
    with _STREAMS_LOCK:
        spare = _SPARE_STREAMS.setdefault(device, [])
        return spare.pop() if spare else torch.cuda.Stream(device)


def release_stream(stream: torch.cuda.Stream) -> None:
    """Give a borrowed stream back (its holder will not use it again)."""
    with _STREAMS_LOCK:
        _SPARE_STREAMS.setdefault(stream.device, []).append(stream)


@contextlib.contextmanager
def borrowed_stream(device):
    """Run the block on a borrowed stream of ``device``, released after."""
    stream = borrow_stream(device)
    try:
        with torch.cuda.stream(stream):
            yield stream
    finally:
        release_stream(stream)
