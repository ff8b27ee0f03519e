"""Async, atomic checkpointing (port of ``repro.checkpoint.checkpointer``;
the same on-disk layout, so either package restores the other's files).

    <dir>/step_00000100/
        manifest.json     {step, leaves: {path: {file, shape, dtype, crc32}},
                           extra: {...}}   — written LAST (commit marker)
        <flat-path>.npy   one array per leaf, the full value

  * async — ``save()`` copies every leaf to host memory synchronously and
    writes the files on a background thread; ``wait()`` joins it (and
    raises what the writer raised) before the next save or exit.
  * atomic — files land in ``step_xxx.tmp/``, renamed to ``step_xxx/``
    after the manifest is written; ``latest_step()`` sees only committed
    directories.
  * integrity — crc32 per leaf, verified on restore.
  * GC — keep the newest ``keep`` checkpoints.

A leaf's path is its keys joined by ``/`` (``nn.module.tree_paths``, the
reference's names), its file the path with ``.`` for ``/``. A bf16 leaf is
stored as its uint16 bits with ``"bfloat16"`` in the manifest (the same
bytes, and checksum, as the reference's ``ml_dtypes`` array; numpy has no
bf16 of its own). ``restore`` puts each leaf on the caller's device.

Elastic: leaves are saved UNSHARDED. A ``DTensor`` leaf is gathered to its
full value (``full_tensor``, a collective: every rank of its mesh calls
``save``), and only rank 0 writes; the other ranks' ``wait`` returns once
rank 0 has committed. ``restore(..., shardings=...)`` places each leaf
onto the target mesh: a rank maps each leaf's file, checks it, and
copies only its own shard to its device (``sharding.rules.local_slices``),
one leaf at a time, so no rank holds the whole tree. Nothing in the
layout records the mesh it was saved from.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading
import zlib

import numpy as np
import torch
import torch.distributed as dist

from ..nn.module import map_with_path, tree_paths


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _host(t) -> tuple[np.ndarray, str]:
    """A copy of tensor ``t`` in host memory as numpy, and its dtype's
    name in the manifest."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        arr = t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16)
        return arr, "bfloat16"
    arr = t.to("cpu", copy=True).numpy()
    return arr, str(arr.dtype)


def _crc32(arr: np.ndarray, chunk: int = 1 << 26) -> int:
    """The crc32 of ``arr``'s C-order bytes, read a chunk at a time (a
    mapped file is not loaded whole)."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    crc = 0
    for i in range(0, flat.size, chunk):
        crc = zlib.crc32(flat[i:i + chunk], crc)
    return crc


def _tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


@dataclasses.dataclass
class Checkpointer:
    directory: str
    keep: int = 3

    def __post_init__(self):
        self.dir = pathlib.Path(self.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._shared = False  # a save of DTensors awaits rank 0's commit

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree, *, extra: dict | None = None,
             block: bool = False):
        """Snapshot ``tree`` (a nested dict of tensors) at ``step``. Returns
        once the leaves are in host memory; the files are written on a
        background thread."""
        self.wait()  # one in-flight save at a time
        host = {}
        for p, t in tree_paths(tree):
            if hasattr(t, "full_tensor"):
                self._shared = True
                t = t.full_tensor()
            if _rank() == 0:
                host[p] = _host(t)
        extra = dict(extra or {})
        if _rank() != 0:
            if block:
                self.wait()
            return

        def write():
            try:
                tmp = self.dir / f"step_{step:08d}.tmp"
                final = self.dir / f"step_{step:08d}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                leaves = {}
                for path, (arr, dtype) in host.items():
                    fname = path.replace("/", ".") + ".npy"
                    np.save(tmp / fname, arr)
                    leaves[path] = {
                        "file": fname,
                        "shape": list(arr.shape),
                        "dtype": dtype,
                        "crc32": zlib.crc32(
                            np.ascontiguousarray(arr).tobytes()),
                    }
                manifest = {"step": step, "leaves": leaves, "extra": extra}
                with open(tmp / "manifest.json", "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)          # the commit point
                self._gc()
            except Exception as e:  # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        """Join the write in flight; after a save of DTensors, every rank
        returns once rank 0 has committed it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._shared:
            self._shared = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self._committed())
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- discovery --------------------------------------------------------------
    def _committed(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return out

    def latest_step(self) -> int | None:
        steps = self._committed()
        return max(steps) if steps else None

    # -- restore ------------------------------------------------------------------
    def restore(self, step: int | None = None, *, skeleton=None,
                shardings=None, device="cpu", verify: bool = True):
        """Load checkpoint ``step`` (default the latest) onto ``device``.
        Returns ``(tree, extra)``.

        ``skeleton``: a tree of the target layout (its leaves may be meta
        tensors, as ``launch.steps.abstract_params`` gives); each restored
        leaf must have its leaf's shape. Without one, the flat ``{path:
        tensor}`` dict is returned. ``shardings``: a tree of
        ``sharding.rules.NamedSharding`` congruent with the result; each
        leaf is placed by its sharding as a DTensor on that mesh's
        devices (``device`` is then the mesh's)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        cdir = self.dir / f"step_{step:08d}"
        manifest = json.loads((cdir / "manifest.json").read_text())

        where = None
        if shardings is not None:
            from ..sharding.rules import from_shard, local_slices
            where = dict(tree_paths(shardings))
        flat = {}
        for path, meta in manifest["leaves"].items():
            arr = np.load(cdir / meta["file"], mmap_mode="r")
            if verify and _crc32(arr) != meta["crc32"]:
                raise IOError(f"checksum mismatch for {path} at step {step}")
            if where is None:
                flat[path] = _tensor(np.array(arr), meta["dtype"], device)
            else:
                sh = where[path]
                part = np.array(arr[local_slices(arr.shape, sh)])
                flat[path] = from_shard(_tensor(part, meta["dtype"], "cpu"),
                                        sh, arr.shape)
            del arr
        if skeleton is None and shardings is None:
            return flat, manifest.get("extra", {})

        def leaf(path, want):
            got = flat[path]
            if skeleton is not None and \
                    tuple(got.shape) != tuple(want.shape):
                raise ValueError(f"{path} is {tuple(got.shape)} in the "
                                 f"checkpoint, the skeleton wants "
                                 f"{tuple(want.shape)}")
            return got
        return (map_with_path(leaf, shardings if skeleton is None
                              else skeleton), manifest.get("extra", {}))
