"""Classify images with the port's packed-bit Spikformer inference engine,
the paper's real-time workload, on the card unless ``--device cpu`` asks
for the CPU: a short surrogate-gradient training run on synthetic
class-conditional images, then BN-folded packed-uint8 inference through
the compile/serve split (``repro_torch.infer.compile`` ->
``MicroBatchEngine``), checking the packed path agrees with the float
reference bit for bit and reporting fps, p95 latency and pad waste.

  PYTHONPATH=src python examples/torch_classify_spikformer.py
      [--train-steps 60] [--device cpu]
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.core.spikformer import (SpikformerConfig, init,
                                         make_train_step)
from repro_torch.data.pipeline import DataConfig, image_batch
from repro_torch.device import resolve_device
from repro_torch.infer import ExecutionPlan, MicroBatchEngine, compile
from repro_torch.infer.engine import to_host
from repro_torch.optim import adamw


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--eval-images", type=int, default=48)
    ap.add_argument("--batch-size", type=int, default=8,
                    help="static inference batch")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = SpikformerConfig().scaled(classes=args.classes)
    dcfg = DataConfig(global_batch=args.batch, image_size=32,
                      n_classes=args.classes, seed=0)
    params = init(torch.Generator().manual_seed(0), cfg)
    opt_cfg = adamw.OptConfig(peak_lr=2e-3, warmup_steps=10,
                              decay_steps=args.train_steps, weight_decay=0.01)
    # the reference jits its step: one CUDA graph on the card
    step = make_train_step(params, adamw.init(params, opt_cfg), cfg, opt_cfg,
                           device=dev)

    losses = []
    for i in range(args.train_steps):
        losses.append(float(step(image_batch(dcfg, i))["loss"]))
        if i % 20 == 0:
            print(json.dumps({"train_step": i, "loss": round(losses[-1], 4)}),
                  flush=True)
    params, _ = step.state()

    # --- packed inference: compile once, serve through the engine ----------
    plan = ExecutionPlan(backend="packed",
                         batch_buckets=(max(1, args.batch_size // 4),
                                        args.batch_size))
    model = compile(params, cfg, plan, device=dev)
    ref = compile(params, cfg, plan, backend="reference", device=dev)
    compile_s = model.warmup()

    images, labels = [], []
    n_batches = -(-args.eval_images // args.batch)
    for i in range(args.train_steps, args.train_steps + n_batches):
        raw = image_batch(dcfg, i)
        images.append(raw["image"])
        labels.append(raw["label"])
    images = np.concatenate(images)[:args.eval_images]
    labels = np.concatenate(labels)[:args.eval_images]

    eng = MicroBatchEngine(model)
    for i in range(0, len(images), 3):     # requests of up to 3 images
        eng.submit(images[i:i + 3])
    done = sorted(eng.run(), key=lambda r: r.rid)
    pred = np.asarray([lab for r in done for lab in r.labels])
    stats = eng.stats()
    exact = bool(np.array_equal(to_host(model.logits(images)),
                                to_host(ref.logits(images))))

    result = {
        "eval_images": len(images),
        "accuracy": round(float((pred == labels).mean()), 3),
        "chance": round(1 / args.classes, 3),
        "compile_s": round(compile_s, 3),
        "fps": stats["fps"],
        "paper_target_fps": stats["paper_fps"],
        "latency_p95_s": stats["latency_p95_s"],
        "pad_waste": stats["pad_waste"],
        "packed_matches_reference_exactly": exact,
    }
    print(json.dumps(result))
    return {**result, "losses": losses, "model": model, "reference": ref}


if __name__ == "__main__":
    main()
