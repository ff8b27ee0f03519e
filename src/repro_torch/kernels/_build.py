"""Build and bind the CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes``. Builds happen at first
use, one ``nvcc`` per source, all started together, into ``build/kernels``
at the repository root (listed in ``.gitignore``). A library's file name
carries a digest of its source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited source or header rebuilds and an unchanged one is
reused.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("tflif", "lut_gather", "unpack_dot", "unpack_dot_s8", "stdp",
           "stdp_packed", "fused_lif_lut", "shift_sum", "flash_attention",
           "flash_attention_tc")
# -Xptxas -v reports registers, shared memory and spills per kernel
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all at once.
    Returns ``{name: {"seconds": s, "log": compiler stderr}}`` for the
    sources it built; raises with the compiler's output if one fails."""
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode:
            failed.append(f"--- {name}.cu ---\n{log}")
        else:
            os.replace(tmp, library_path(name))   # atomic: no half-written .so
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def kernel_function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C launcher ``symbol`` of ``csrc/<name>.cu``, building and
    loading the library on first use. Launchers return a ``cudaError_t``."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def on_cpu(*tensors) -> bool:
    """True when every operand lies on the CPU (the wrapper then runs its
    plain version), False when all lie on one CUDA device (the wrapper
    launches its kernel); raises for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel operands lie on several devices: "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return device.type == "cpu"


def require(tensor, name: str, dtype, ndim: int) -> None:
    """Raise unless ``tensor`` has the dtype, rank and contiguity a
    launcher takes."""
    if tensor.dtype != dtype or tensor.dim() != ndim:
        raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                         f"{tensor.dim()}-d {tensor.dtype}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(tensor) -> int:
    """The current PyTorch stream on ``tensor``'s device, as a launcher
    argument."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream


_COUNT_LOCK = threading.Lock()
_RECORDING = threading.local()


def add_count(wrapper, counter: str) -> None:
    """Add one to ``wrapper.<counter>``, under a lock: serving threads
    launch at once, and ``+=`` on an attribute is not atomic."""
    with _COUNT_LOCK:
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (``add_count``) and to the calling
    thread's open ``recording_launches``, if any."""
    add_count(wrapper, "launches")
    counts = getattr(_RECORDING, "counts", None)
    if counts is not None:
        counts[wrapper] = counts.get(wrapper, 0) + 1


@contextlib.contextmanager
def recording_launches():
    """Yields ``{wrapper: launches}`` of the launches this thread makes
    inside the block, whatever other threads launch meanwhile."""
    counts: dict = {}
    outer = getattr(_RECORDING, "counts", None)
    _RECORDING.counts = counts
    try:
        yield counts
    finally:
        _RECORDING.counts = outer


def check(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err:
        msg = _LIBS[name].error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {err} ({msg})")
