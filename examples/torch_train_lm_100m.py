"""End to end on the PyTorch/CUDA port: train a ~100M-parameter LM
on synthetic data through the full loop (microbatched train step, data
pipeline, async checkpointing, restart supervisor), on the card unless
``--device cpu`` asks for the CPU.

  PYTHONPATH=src python examples/torch_train_lm_100m.py [--steps 300]
      [--device cpu]

The config is the reference example's: the smollm-360m family scaled to
~100M params (16 layers, d_model 768, GQA 12/4, vocab 32k), registered as
``lm-100m``; optimizer, grad accumulation and checkpointing are what
``repro_torch.launch.train`` runs for any config.
"""
import argparse
import tempfile

from repro_torch.configs.base import ArchConfig, register
from repro_torch.launch import train

CONFIG = register(ArchConfig(
    name="lm-100m", family="dense",
    n_layers=16, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
    vocab=32000, tie_embeddings=True, remat=False,
))


def main(argv=None) -> list:
    """Returns ``train.main``'s metric records."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="lm100m_ck_")
    argv = [
        "--arch", "lm-100m",
        "--steps", str(args.steps),
        "--seq", str(args.seq),
        "--global-batch", str(args.global_batch),
        "--microbatch", str(max(1, args.global_batch // 2)),
        "--lr", "6e-4", "--warmup", "50",
        "--ckpt-dir", ckpt, "--ckpt-every", "100",
        "--log-every", "10",
    ]
    if args.device is not None:
        argv += ["--device", args.device]
    return train.main(argv)


if __name__ == "__main__":
    main()
