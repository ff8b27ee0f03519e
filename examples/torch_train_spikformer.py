"""Train Spikformer V2 (reduced) on the PyTorch/CUDA port by
surrogate-gradient BPTT on synthetic class-conditional images, on the card
unless ``--device cpu`` asks for the CPU. The step is eager autograd
through the float graph (atan surrogate at every LIF, BN on batch
statistics), AdamW, then the EMA'd BN stats written back, as the
reference's example jits it.

  PYTHONPATH=src python examples/torch_train_spikformer.py [--steps 300]
      [--device cpu]
"""
import argparse
import json
import time

import torch

from repro_torch.core.spikformer import (SpikformerConfig, init, loss_fn,
                                         merge_bn_stats, value_and_grad)
from repro_torch.data.pipeline import DataConfig, image_batch
from repro_torch.device import resolve_device
from repro_torch.infer.compile import to_device
from repro_torch.optim import adamw


def batch_on(raw: dict, dev) -> dict:
    return {"image": torch.from_numpy(raw["image"]).to(dev),
            "label": torch.from_numpy(raw["label"]).to(dev)}


def train_step(params, opt, batch, cfg, opt_cfg):
    """One step: ``(params, opt, loss, accuracy, metrics)``."""
    (loss, (acc, stats)), grads = value_and_grad(params, batch, cfg)
    params, opt, metrics = adamw.update(grads, opt, params, opt_cfg)
    return merge_bn_stats(params, stats), opt, loss, acc, metrics


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval-steps", type=int, default=5,
                    help="held-out batches after training")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = SpikformerConfig().scaled(img_size=32, dim=64, depth=2, heads=2,
                                    classes=args.classes)
    dcfg = DataConfig(global_batch=args.batch, image_size=32,
                      n_classes=args.classes, seed=0)
    params = to_device(init(torch.Generator().manual_seed(0), cfg), dev)
    opt_cfg = adamw.OptConfig(peak_lr=args.lr, warmup_steps=20,
                              decay_steps=args.steps, weight_decay=0.01)
    opt = adamw.init(params, opt_cfg)

    t0 = time.time()
    losses = []
    for i in range(args.steps):
        params, opt, loss, acc, _ = train_step(
            params, opt, batch_on(image_batch(dcfg, i), dev), cfg, opt_cfg)
        losses.append(float(loss))
        if i % 20 == 0 or i == args.steps - 1:
            print(json.dumps({"step": i, "loss": round(float(loss), 4),
                              "acc": round(float(acc), 3),
                              "wall_s": round(time.time() - t0, 1)}),
                  flush=True)

    # eval on held-out steps
    correct = total = 0
    with torch.no_grad():
        for i in range(args.steps, args.steps + args.eval_steps):
            _, (acc, _) = loss_fn(params, batch_on(image_batch(dcfg, i), dev),
                                  cfg, train=False)
            correct += float(acc) * args.batch
            total += args.batch
    result = {"eval_acc": round(correct / max(1, total), 3),
              "chance": round(1 / args.classes, 3)}
    print(json.dumps(result))
    return {**result, "losses": losses, "params": params, "cfg": cfg}


if __name__ == "__main__":
    main()
