"""Every config's reduced train, prefill and decode steps dry-run on fake
(2, 4) and (4, 4) worlds: a quick look for layouts that the installed
torch's DTensor refuses, at shapes the production grid never reaches
(sequences shorter than a chunk, heads and KV groups that do not divide
the model axis).

    PYTHONPATH=src python3 scripts/dryrun_reduced_sweep.py [--arch ARCH]

The fake mesh is ``cuda``-typed where torch sees a card and ``cpu``-typed
elsewhere (``launch/mesh.py:fake_world``), so run it on the card's host
to see that torch's refusals. Prints the torch version, then one line a
cell: ``[ok]`` or ``[FAIL]`` with the error and the port's innermost
frame, and exits 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import traceback

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

SHAPES = (("train", 32, 8), ("prefill", 32, 8), ("decode", 64, 8))
MESHES = ((2, 4), (4, 4))


def main(argv=None) -> int:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ARCH_IDS, ShapeSpec
    from repro_torch.launch import dryrun

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    args = ap.parse_args(argv)
    print(f"torch {torch.__version__}", flush=True)
    failed = 0
    for arch in [args.arch] if args.arch else ARCH_IDS:
        cfg = get_config(arch).reduced()
        for kind, seq, batch in SHAPES:
            for mesh in MESHES:
                tag = f"{arch} {kind} {mesh}"
                try:
                    dryrun.dry_run(cfg, ShapeSpec(kind, kind, seq, batch),
                                   mesh, ("data", "model"),
                                   **({"microbatch": 4} if kind == "train"
                                      else {}))
                except Exception as e:  # noqa: BLE001  reported per cell
                    failed += 1
                    ours = [f for f in traceback.extract_tb(e.__traceback__)
                            if "repro_torch" in f.filename]
                    where = (f"{ours[-1].filename.split('repro_torch/')[-1]}"
                             f":{ours[-1].lineno}" if ours else "?")
                    msg = " ".join(str(e).split())[:160]
                    print(f"[FAIL] {tag}: {type(e).__name__}: {msg} "
                          f"(at {where})", flush=True)
                else:
                    print(f"[ok] {tag}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
