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
bf16 of its own). ``restore`` puts each leaf on the caller's device. The
reference's elastic restore onto a mesh (its ``shardings``) comes with the
port of ``repro.sharding``.
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

from ..nn.module import map_with_path, tree_paths


def _host(t) -> tuple[np.ndarray, str]:
    """A copy of tensor ``t`` in host memory as numpy, and its dtype's
    name in the manifest."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        arr = t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16)
        return arr, "bfloat16"
    arr = t.to("cpu", copy=True).numpy()
    return arr, str(arr.dtype)


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

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree, *, extra: dict | None = None,
             block: bool = False):
        """Snapshot ``tree`` (a nested dict of tensors) at ``step``. Returns
        once the leaves are in host memory; the files are written on a
        background thread."""
        self.wait()  # one in-flight save at a time
        host = {p: _host(t) for p, t in tree_paths(tree)}
        extra = dict(extra or {})

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
        if self._thread is not None:
            self._thread.join()
            self._thread = None
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
                device="cpu", verify: bool = True):
        """Load checkpoint ``step`` (default the latest) onto ``device``.
        Returns ``(tree, extra)``.

        ``skeleton``: a tree of the target layout (its leaves may be meta
        tensors, as ``launch.steps.abstract_params`` gives); each restored
        leaf must have its leaf's shape. Without one, the flat ``{path:
        tensor}`` dict is returned."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        cdir = self.dir / f"step_{step:08d}"
        manifest = json.loads((cdir / "manifest.json").read_text())

        flat = {}
        for path, meta in manifest["leaves"].items():
            arr = np.load(cdir / meta["file"])
            if verify:
                crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                if crc != meta["crc32"]:
                    raise IOError(f"checksum mismatch for {path} at step {step}")
            flat[path] = _tensor(arr, meta["dtype"], device)

        if skeleton is None:
            return flat, manifest.get("extra", {})

        def leaf(path, want):
            got = flat[path]
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(f"{path} is {tuple(got.shape)} in the "
                                 f"checkpoint, the skeleton wants "
                                 f"{tuple(want.shape)}")
            return got
        return map_with_path(leaf, skeleton), manifest.get("extra", {})
