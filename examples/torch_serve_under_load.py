"""Serve a Spikformer under open-loop load on the port (on the card unless
``--device cpu`` asks for the CPU): compile one multi-bucket model, replay
Poisson arrival traces at two rates through
``repro_torch.serve.AsyncServeRuntime``, and report what a closed-loop
drain cannot: goodput (within-SLO images/s), p99 latency, SLO attainment
and admission-control rejections.

  PYTHONPATH=src python examples/torch_serve_under_load.py
      [--rates 40,160] [--duration 2] [--slo-ms 100] [--device cpu]
"""
import argparse
import json

import torch

from repro_torch.core.spikformer import SpikformerConfig, init
from repro_torch.infer import ExecutionPlan, PAPER_FPS, compile
from repro_torch.serve import (AsyncServeRuntime, ServePolicy, image_maker,
                               poisson_trace, run_open_loop)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rates", default="40,160",
                    help="comma-separated offered arrival rates (req/s)")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="seconds of open-loop arrivals per rate")
    ap.add_argument("--slo-ms", type=float, default=100.0)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = SpikformerConfig().scaled()
    params = init(torch.Generator().manual_seed(args.seed), cfg)
    model = compile(params, cfg, ExecutionPlan(batch_buckets=(2, 8)),
                    device=args.device)
    print(json.dumps({"compile_s": round(model.warmup(), 3),
                      "buckets": list(model.buckets),
                      "paper_fps": PAPER_FPS}))

    rows = []
    for rps in (float(r) for r in args.rates.split(",")):
        policy = ServePolicy(max_wait_ms=args.max_wait_ms,
                             slo_ms=args.slo_ms, max_queue_images=256)
        trace = poisson_trace(rps=rps, duration_s=args.duration,
                              seed=args.seed + 1, images_per_request=(1, 3))
        with AsyncServeRuntime(model, policy=policy) as rt:
            metrics = run_open_loop(
                rt, trace,
                image_maker(model.input_shape()[1:], seed=args.seed + 2),
                slo_ms=args.slo_ms)
        row = {
            "offered_rps": rps,
            "goodput_fps": metrics["goodput_fps"],
            "completed_fps": metrics["completed_fps"],
            "latency_p99_s": metrics["latency_p99_s"],
            "slo_attainment": metrics["slo_attainment"],
            "rejected": metrics["requests_rejected"],
            "dropped": metrics["requests_dropped"],
            "sustains_paper_rate":
                bool(metrics["completed_fps"] >= PAPER_FPS),
            "pad_waste": rt.stats()["pad_waste"],
            "requests": len(trace),
        }
        print(json.dumps(row))
        rows.append(row)
    return {"rows": rows, "model": model}


if __name__ == "__main__":
    main()
