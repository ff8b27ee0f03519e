"""LM training entry point (port of ``repro.launch.train``).

Trains the requested arch (optionally ``--reduce``d) on synthetic or
token-file data with the full loop: the microbatched train step
(``launch/steps.py``), async checkpointing, restart supervision, the loss
guard, straggler bookkeeping and a metrics log. It runs on one device,
the card unless ``--device`` names another, with no mesh: sharding over a
mesh comes with the port of ``repro.sharding``. The encoder-decoder and
VLM families are not ported and raise.

Prints one JSON line a logged step (``step``, ``loss``, ``grad_norm``,
``lr``, ``step_s``), ``[restore] step N from DIR`` after a restart, and
``{"result": {"restarts": ..., "completed": ...}}`` last.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 50 --global-batch 8 --seq 2048 --microbatch 4 \\
      --ckpt-dir /tmp/ck --ckpt-every 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduce --device cpu --steps 3 --global-batch 4 --seq 32
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..configs.base import get_config
from ..data.pipeline import DataConfig, DataPipeline
from ..device import resolve_device
from ..nn import transformer as T
from ..optim import adamw
from ..optim.compression import ef_init
from ..runtime.fault_tolerance import (LossGuard, NodeFailure, RestartPolicy,
                                       StragglerDetector, TrainSupervisor)
from . import steps


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true",
                    help="scale the arch down to a CPU-runnable size")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatch", type=int, default=0,
                    help="0 = no accumulation")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default="synthetic_lm")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="start from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="test hook: raise NodeFailure at this step once")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    data: DataPipeline
    step: int


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = cfg.reduced()
    T.require_ported(cfg)
    device = resolve_device(args.device)

    dcfg = DataConfig(seq=args.seq, global_batch=args.global_batch,
                      vocab=cfg.padded_vocab, seed=args.seed,
                      kind=args.data, path=args.data_path)
    ts = steps.TrainSettings(
        microbatch=args.microbatch or args.global_batch,
        compression=args.compression,
        opt=adamw.OptConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                            decay_steps=max(args.steps, 2 * args.warmup)))
    step_fn = steps.make_train_step(cfg, ts)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    guard = LossGuard()
    straggler = StragglerDetector(n_nodes=1)
    metrics_log: list[dict] = []
    injected = {"done": False}

    def make_state(restore):
        if (restore is not None or args.resume) and ckpt is not None:
            # a failure can land while a save is still being written:
            # commit it first, or the restart would not see it
            ckpt.wait()
            if ckpt.latest_step() is not None:
                skel_p = steps.abstract_params(cfg)
                skel_o = steps.abstract_opt_state(cfg, skel_p, ts)
                tree, extra = ckpt.restore(
                    skeleton={"params": skel_p, "opt": skel_o},
                    device=device)
                data = DataPipeline.restore(dcfg, extra["data"],
                                            device=device)
                print(f"[restore] step {extra['step']} from {ckpt.dir}",
                      flush=True)
                return TrainState(tree["params"], tree["opt"], data,
                                  int(extra["step"]))
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = T.init_model(gen, cfg, device=device)
        opt_state = adamw.init(params, steps.opt_config(cfg, ts))
        if ts.compression != "none":
            opt_state["ef"] = ef_init(params)
        return TrainState(params, opt_state, DataPipeline(dcfg, device=device),
                          0)

    def run_segment(state: TrainState):
        params, opt_state, data = state.params, state.opt_state, state.data
        for step in range(state.step, args.steps):
            if step == args.inject_failure_at and not injected["done"]:
                injected["done"] = True
                data.close()
                raise NodeFailure(f"injected at step {step}")
            t0 = time.time()
            batch = next(data)
            params, opt_state, m = step_fn(params, opt_state, batch)
            loss = float(m["loss"])
            dt = time.time() - t0
            straggler.update([dt])
            if not guard.check(loss):
                data.close()
                raise NodeFailure(f"loss diverged: {loss} at step {step}")
            if step % args.log_every == 0 or step == args.steps - 1:
                rec = {"step": step, "loss": round(loss, 4),
                       "grad_norm": round(float(m["grad_norm"]), 4),
                       "lr": float(m["lr"]), "step_s": round(dt, 3)}
                metrics_log.append(rec)
                print(json.dumps(rec), flush=True)
            if ckpt is not None and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          extra={"step": step + 1,
                                 "data": data.state_dict()})
        if ckpt is not None and state.step < args.steps \
                and args.steps % args.ckpt_every == 0:
            ckpt.wait()     # the loop's last save holds this very step
        elif ckpt is not None:
            ckpt.save(args.steps, {"params": params, "opt": opt_state},
                      extra={"step": args.steps, "data": data.state_dict()},
                      block=True)
        data.close()
        return None

    sup = TrainSupervisor(RestartPolicy(backoff_s=0.01), make_state,
                          run_segment)
    result = sup.run()
    print(json.dumps({"result": result}), flush=True)

    if args.metrics_out:
        pathlib.Path(args.metrics_out).write_text(json.dumps(metrics_log))
    return metrics_log


if __name__ == "__main__":
    main()
