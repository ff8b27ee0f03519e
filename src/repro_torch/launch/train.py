"""LM training entry point (port of ``repro.launch.train``).

Trains the requested arch (optionally ``--reduce``d) on synthetic or
token-file data with the full loop: the microbatched train step
(``launch/steps.py``), async checkpointing, restart supervision, the loss
guard, straggler bookkeeping and a metrics log, on the card unless
``--device`` names another.

``--mesh DATA,MODEL`` shards the run as the reference's ``main`` does:
the step is ``steps.jit_train_step`` over ``make_cpu_mesh(DATA, MODEL)``
(a ``DeviceMesh`` over the caller's process group of DATA x MODEL ranks,
or one made from a launcher's environment, ``torchrun``'s ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``), params and moments
are placed by ``rules.param_shardings`` / ``opt_state_shardings`` and a
restart restores through them, each rank reading only its shard of each
leaf. Every rank draws the full initial tree before it keeps its shard:
a sharded init is not ported. Rank 0 prints. On one rank (the default)
the step is ``make_train_step`` on plain tensors: a mesh of one rank
would make every redistribution the identity and compute the same
values, at DTensor's cost of dispatch on every op. The encoder-decoder
and VLM families train on the synthetic stream plus the reference's stub
modality inputs (``augment``): zero frames, zero image embeddings and
M-RoPE positions whose three streams are each row's ``arange``.

Prints one JSON line a logged step (``step``, ``loss``, ``grad_norm``,
``lr``, ``step_s``), ``[restore] step N from DIR`` after a restart, and
``{"result": {"restarts": ..., "completed": ...}}`` last.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 50 --global-batch 8 --seq 2048 --microbatch 4 \\
      --ckpt-dir /tmp/ck --ckpt-every 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduce --device cpu --steps 3 --global-batch 4 --seq 32
  torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch smollm-360m --reduce --device cpu --mesh 2,4 --steps 3 \\
      --global-batch 8 --seq 32 --microbatch 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import time

import torch
import torch.distributed as dist

from ..checkpoint.checkpointer import Checkpointer
from ..configs.base import get_config
from ..data.pipeline import DataConfig, DataPipeline
from ..device import resolve_device
from ..nn import transformer as T
from ..optim import adamw
from ..optim.compression import ef_init
from ..runtime.fault_tolerance import (LossGuard, NodeFailure, RestartPolicy,
                                       StragglerDetector, TrainSupervisor)
from ..sharding import rules
from . import steps
from .mesh import make_cpu_mesh


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
    ap.add_argument("--mesh", default="1,1", metavar="DATA,MODEL",
                    help="shard over a (data, model) mesh of DATA x MODEL "
                         "ranks (default: one rank, unsharded)")
    return ap


def augment(batch: dict, cfg) -> dict:
    """Add the stub modality inputs the synthetic LM stream lacks, as the
    reference's ``augment``: for a VLM, zero image embeddings (B,
    img_tokens, D) in bf16 and the (3, B, S) M-RoPE positions, each
    stream ``arange(S)``; for an encoder-decoder, zero frames (B,
    n_frames, D) in bf16."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.zeros(
            (b, cfg.img_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=dev)
        batch["mrope_positions"] = torch.arange(
            s, dtype=torch.int32, device=dev).expand(3, b, s)
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((b, cfg.n_frames, cfg.d_model),
                                      dtype=torch.bfloat16, device=dev)
    return batch


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    data: DataPipeline
    step: int


def batch_shapes(cfg, global_batch: int, seq: int) -> dict:
    """The train batch's shapes as meta tensors: tokens and labels, plus
    ``augment``'s stub modality inputs."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    shapes = {"tokens": meta((global_batch, seq), torch.int32),
              "labels": meta((global_batch, seq), torch.int32)}
    if cfg.family == "vlm":
        shapes["image_embeds"] = meta(
            (global_batch, cfg.img_tokens, cfg.d_model), torch.bfloat16)
        shapes["mrope_positions"] = meta((3, global_batch, seq), torch.int32)
    if cfg.family == "encdec":
        shapes["frames"] = meta((global_batch, cfg.n_frames, cfg.d_model),
                                torch.bfloat16)
    return shapes


def mesh_shape(text: str) -> tuple[int, int]:
    """``--mesh``'s ``DATA,MODEL`` as two ints."""
    try:
        data, model = (int(v) for v in text.split(","))
    except ValueError:
        raise ValueError(f"--mesh takes DATA,MODEL, got {text!r}") from None
    return data, model


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = cfg.reduced()
    T.require_ported(cfg)
    device = resolve_device(args.device)
    shape = mesh_shape(args.mesh)
    if shape == (1, 1):
        return _main(args, cfg, device, None)
    own_group = not dist.is_initialized()
    if own_group:
        # a launcher's group (torchrun): one rank a process, one card a rank
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        return _main(args, cfg, device, make_cpu_mesh(*shape, device=device))
    finally:
        if own_group:
            dist.destroy_process_group()


def _main(args, cfg, device, mesh):
    """The training loop; ``mesh`` None for one rank, unsharded."""
    lead = mesh is None or dist.get_rank() == 0

    def say(text):
        if lead:
            print(text, flush=True)

    dcfg = DataConfig(seq=args.seq, global_batch=args.global_batch,
                      vocab=cfg.padded_vocab, seed=args.seed,
                      kind=args.data, path=args.data_path)
    ts = steps.TrainSettings(
        microbatch=args.microbatch or args.global_batch,
        compression=args.compression,
        opt=adamw.OptConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                            decay_steps=max(args.steps, 2 * args.warmup)))
    if mesh is None:
        step_fn, in_sh = steps.make_train_step(cfg, ts), None
    else:
        step_fn, _, in_sh = steps.jit_train_step(
            cfg, mesh, ts, batch_shapes(cfg, args.global_batch, args.seq))

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
                    device=device, shardings=None if in_sh is None else
                    {"params": in_sh[0], "opt": in_sh[1]})
                data = DataPipeline.restore(dcfg, extra["data"],
                                            device=device)
                say(f"[restore] step {extra['step']} from {ckpt.dir}")
                return TrainState(tree["params"], tree["opt"], data,
                                  int(extra["step"]))
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = T.init_model(gen, cfg, device=device)
        if in_sh is not None:
            params = rules.place_tree(params, in_sh[0])
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
            batch = augment(next(data), cfg)
            params, opt_state, m = step_fn(params, opt_state, batch)
            m = {k: rules.full_value(v) for k, v in m.items()}
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
                say(json.dumps(rec))
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
    say(json.dumps({"result": result}))

    if args.metrics_out and lead:
        pathlib.Path(args.metrics_out).write_text(json.dumps(metrics_log))
    return metrics_log


if __name__ == "__main__":
    main()
