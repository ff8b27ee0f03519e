"""Single-cell multi-pod dry run on the PyTorch port: trace
qwen3-moe-30b-a3b's train_4k step over the 2x16x16 (512-rank) production
mesh as a fake world of meta tensors on this host (nothing allocated, no
card needed), then print the memory/cost/roofline record with the H100's
constants.

  PYTHONPATH=src python examples/torch_dryrun_demo.py [--arch ...] \\
      [--shape ...] [--single-pod]
"""
import argparse
import json

from repro_torch.launch import dryrun


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--single-pod", action="store_true")
    args = ap.parse_args(argv)
    rec, _ = dryrun.lower_cell(args.arch, args.shape,
                               multi_pod=not args.single_pod)
    print(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
