"""Ranks of ``test_torch_sharded_steps.py``: the port's sharded steps on a
(2, 4) ``("data", "model")`` mesh of 8 CPU ranks over gloo.

    python tests/sharded_steps_worker.py DIR

reads ``DIR/inputs.npz`` (the reference's params and batches, flattened
by path; bf16 leaves as their uint16 bits, listed in ``DIR/inputs.json``),
spawns 8 ranks that rendezvous through a ``FileStore`` in DIR (no port is
chosen), and writes rank 0's results to ``DIR/out.npz`` and
``DIR/out.json``. Imports torch and the port only.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

ARCHS = {"smollm": "smollm-360m", "qwen": "qwen1.5-110b"}
# every other family's reduced config (arch, reduced() overrides)
FAMILIES = {"moe": ("qwen3-moe-30b-a3b", {}),
            "moe_dense_parallel": ("arctic-480b", {}),
            "ssm": ("mamba2-130m", {}), "hybrid": ("hymba-1.5b", {}),
            "encdec": ("whisper-large-v3", {}), "vlm": ("qwen2-vl-7b", {})}
REDUCED = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, vocab=512)
WORLD, MESH, OTHER = 8, (2, 4), (4, 2)


def load(d: pathlib.Path):
    meta = json.loads((d / "inputs.json").read_text())
    arrays = dict(np.load(d / "inputs.npz"))
    out = {}
    for key, arr in arrays.items():
        t = torch.from_numpy(arr.copy())
        if meta["dtypes"].get(key) == "bfloat16":
            t = t.view(torch.bfloat16)
        out[key] = t
    return out


def unflatten(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, t in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return tree


def flat_full(tree, prefix, out, module, rules):
    """Every leaf's full value (a collective on DTensors) into ``out``."""
    for path, t in module.tree_paths(tree):
        out[f"{prefix}/{path}"] = rules.full_value(t).detach().clone()


def numpy_of(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def run(rank: int, d: pathlib.Path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"),
                                                         WORLD),
                            rank=rank, world_size=WORLD)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.nn import module
    from repro_torch.nn import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.optim.compression import compressed_psum_int8
    from repro_torch.sharding import rules, set_mesh

    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    inp = load(d)
    res: dict = {}
    arrays: dict = {}
    ts = steps.TrainSettings(microbatch=4)
    batch = {"tokens": inp["batch/tokens"], "labels": inp["batch/labels"]}
    shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in batch.items()}

    for name, arch in ARCHS.items():
        cfg = get_config(arch).reduced(**REDUCED)
        params = unflatten(inp, f"params_{name}")
        opt = adamw.init(params, steps.opt_config(cfg, ts))
        step, (p_abs, o_abs, _), in_sh = steps.jit_train_step(cfg, mesh, ts,
                                                              shapes)
        p_sh, o_sh, m_sh = step(params, opt, batch)
        # against the port's unsharded step in f32 compute: in bf16 the
        # partial sums of a product split across ranks are rounded to
        # bf16 before they are added, which moves gradients by ~1%
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        p_plain, o_plain, m_plain = steps.make_train_step(f32, ts)(
            params, opt, batch)
        p_f32, o_f32, m_f32 = steps.jit_train_step(f32, mesh, ts, shapes)[0](
            params, opt, batch)
        full32: dict = {}
        flat_full(p_f32, "p", full32, module, rules)
        flat_full(o_f32, "o", full32, module, rules)
        full: dict = {}
        flat_full(p_sh, "p", full, module, rules)
        flat_full(o_sh, "o", full, module, rules)
        # each rank holds its spec's share of every leaf, and no more
        shares = []
        for tree, sh in ((p_sh, in_sh[0]), (o_sh, in_sh[1])):
            where = dict(module.tree_paths(sh))
            for path, t in module.tree_paths(tree):
                spec = where[path].spec
                ways = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                                 for ax in spec if ax is not None
                                 for a in (ax if isinstance(ax, tuple)
                                           else (ax,)))
                local = t.to_local()
                shares.append(local.numel() * local.element_size() * ways
                              == t.numel() * t.element_size())
        ok = torch.tensor([all(shares)], dtype=torch.int32)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        res[f"{name}_local_shares_ok"] = bool(ok.item())
        res[f"{name}_n_leaves"] = len(shares)
        res[f"{name}_metrics"] = {k: float(rules.full_value(v))
                                  for k, v in m_sh.items()}
        res[f"{name}_f32_metrics"] = {k: float(rules.full_value(v))
                                      for k, v in m_f32.items()}
        res[f"{name}_plain_metrics"] = {k: float(v)
                                        for k, v in m_plain.items()}
        plain = {f"p/{p}": t for p, t in module.tree_paths(p_plain)}
        plain.update({f"o/{p}": t for p, t in module.tree_paths(o_plain)})
        res[f"{name}_vs_plain"] = {
            k: float(((full32[k].double() - plain[k].double()).abs()
                      - 1e-5 * plain[k].double().abs()).max())
            for k in plain}
        for k, t in full.items():
            arrays[f"{name}/{k}"] = numpy_of(t)

        if name != "smollm":
            continue
        # the elastic round trip: saved on (2, 4), restored onto (4, 2)
        ck = Checkpointer(str(d / "ckpt"))
        ck.save(1, {"params": p_sh, "opt": o_sh}, block=True)
        other = init_device_mesh("cpu", OTHER,
                                 mesh_dim_names=("data", "model"))
        tree, _ = ck.restore(1, shardings={
            "params": rules.param_shardings(other, p_abs),
            "opt": rules.opt_state_shardings(other, o_abs)})
        got: dict = {}
        flat_full(tree["params"], "p", got, module, rules)
        flat_full(tree["opt"], "o", got, module, rules)
        res["restore_4x2_equal"] = all(
            torch.equal(got[k], full[k]) for k in full)
        res["restore_4x2_sharded"] = any(
            any(pl.is_shard() for pl in t.placements)
            for _, t in module.tree_paths(tree["params"]))

        # decode: one serve step from an empty f32 cache
        b, s = batch["tokens"].shape
        cache = T.init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
        dec = {"tokens": batch["tokens"][:, :1],
               "cache_pos": torch.tensor(0, dtype=torch.int32)}
        dshapes = {"tokens": torch.empty((b, 1), dtype=torch.int32,
                                         device="meta"),
                   "cache_pos": torch.empty((), dtype=torch.int32,
                                            device="meta")}
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        serve, _, s_sh = steps.jit_serve_step(
            f32, mesh, T.init_cache(cfg, b, s, dtype=torch.float32,
                                    device="meta"), dshapes)
        tok, new_cache = serve(params, cache, dec)
        arrays["decode_tokens"] = rules.full_value(tok).numpy()
        res["decode_tok_placements"] = [
            [type(p).__name__, getattr(p, "dim", None)]
            for p in tok.placements]
        res["cache_k_placements"] = [
            [type(p).__name__, getattr(p, "dim", None)]
            for p in new_cache["kv"]["k"].placements]

        # prefill in f32 through the flash wrapper under local_map: each
        # rank's call sees its local heads (4 over the model axis of 4)
        seen = []
        real = ops.flash_attention

        def spy(q, k, v, **kw):
            seen.append((tuple(q.shape), tuple(k.shape)))
            return real(q, k, v, **kw)

        ops.flash_attention = spy
        try:
            pre, _, _ = steps.jit_prefill(f32, mesh, shapes)
            logits, pcache = pre(params, {"tokens": batch["tokens"]})
        finally:
            ops.flash_attention = real
        ref_logits, ref_cache = steps.make_prefill(f32)(
            params, {"tokens": batch["tokens"]})
        res["prefill_flash_calls"] = seen
        res["prefill_max_diff"] = float(
            (rules.full_value(logits) - ref_logits).abs().max())
        # the bf16 cache: each value within one bf16 ulp of its own (2^-7
        # of it) plus the f32 sums' 1e-5 of the leaf's largest value
        res["prefill_cache_within_ulp"] = all(
            bool(((rules.full_value(a).double() - b_.double()).abs()
                  <= b_.double().abs() * 2.0 ** -7
                  + 1e-5 * b_.double().abs().max()).all())
            for (_, a), (_, b_) in zip(module.tree_paths(pcache),
                                       module.tree_paths(ref_cache)))

    res["rows"] = rows_layout(d, mesh, batch, ts)
    res["train_main"] = train_main_runs(d, rank)

    # the other families, port against port in f32 compute, from the
    # port's seeded init and the stub modality inputs
    from repro_torch.launch.train import augment
    fam = {}
    for name, (arch, kw) in FAMILIES.items():
        cfg = dataclasses.replace(get_config(arch).reduced(**kw),
                                  compute_dtype="float32")
        params = T.init_model(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
        fb = augment({k: v % cfg.vocab for k, v in batch.items()}, cfg)
        fshapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                   for k, v in fb.items()}
        opt = adamw.init(params, steps.opt_config(cfg, ts))
        p1, o1, m1 = steps.make_train_step(cfg, ts)(params, opt, fb)
        p2, o2, m2 = steps.jit_train_step(cfg, mesh, ts, fshapes)[0](
            params, opt, fb)
        fam[name] = {"worst": worst_rel({"p": p1, "o": o1},
                                        {"p": p2, "o": o2}, module, rules),
                     "loss": [float(m1["loss"]),
                              float(rules.full_value(m2["loss"]))]}
    res["families"] = fam

    # compressed_psum_int8 over the model axis (4 ranks): model rank r
    # contributes row r of the input
    r = mesh.get_local_rank("model")
    with set_mesh(mesh):
        mean = compressed_psum_int8(inp["psum/x"][r], "model")
    arrays["psum_mean"] = mean.numpy()
    dist.barrier()
    if rank == 0:
        np.savez(d / "out.npz", **arrays)
        (d / "out.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def worst_rel(a_tree, b_tree, module, rules) -> float:
    """max over leaves of |b - a| - 1e-5 |a| (b's DTensors gathered)."""
    worst = 0.0
    for (_, a), (_, b_) in zip(module.tree_paths(a_tree),
                               module.tree_paths(b_tree)):
        a, b_ = a.double(), rules.full_value(b_).double()
        worst = max(worst, float(((b_ - a).abs() - 1e-5 * a.abs()).max()))
    return worst


def rows_layout(d, mesh, batch, ts) -> dict:
    """Six q heads over two KV heads, which the model axis of 4 does not
    divide, in f32 compute from the port's seeded init: the train step
    (the chunked softmax on query rows, the reference's ``seq_tp``)
    against the unsharded step, with every hint that pins a (B, H, S, .)
    tensor's rows over the model axis recorded; the prefill at S = 32
    (flash on each rank's 8 query rows, its keys cut at its last row) and
    at S = 30, which 4 does not divide (flash on the whole sequence),
    against the unsharded prefill, with each rank's flash calls."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.nn import attention, module
    from repro_torch.nn import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules

    cfg = dataclasses.replace(
        get_config("smollm-360m").reduced(n_heads=6, n_kv_heads=2),
        compute_dtype="float32")
    params = T.init_model(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    opt = adamw.init(params, steps.opt_config(cfg, ts))
    shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in batch.items()}
    hints = []
    real_hint = attention.shard_hint

    def hint_spy(x, *dims):
        y = real_hint(x, *dims)
        if dims == ("dp", None, "model", None):
            hints.append(list(y.to_local().shape))
        return y

    attention.shard_hint = hint_spy
    try:
        p2, o2, m2 = steps.jit_train_step(cfg, mesh, ts, shapes)[0](
            params, opt, batch)
    finally:
        attention.shard_hint = real_hint
    p1, o1, m1 = steps.make_train_step(cfg, ts)(params, opt, batch)
    out = {"train_hints": hints,
           "train_worst": worst_rel({"p": p1, "o": o1}, {"p": p2, "o": o2},
                                    module, rules),
           "train_loss": [float(m1["loss"]),
                          float(rules.full_value(m2["loss"]))]}
    real = ops.flash_attention
    for n in (32, 30):
        seen = []

        def spy(q, k, v, **kw):
            seen.append([list(q.shape), list(k.shape)])
            return real(q, k, v, **kw)

        toks = {"tokens": batch["tokens"][:, :n]}
        ops.flash_attention = spy
        try:
            pre = steps.jit_prefill(cfg, mesh, {"tokens": torch.empty(
                (batch["tokens"].shape[0], n), dtype=torch.int32,
                device="meta")})[0]
            logits, _ = pre(params, toks)
        finally:
            ops.flash_attention = real
        want, _ = steps.make_prefill(cfg)(params, toks)
        calls = [None] * dist.get_world_size()
        dist.all_gather_object(calls, [mesh.get_local_rank("model"), seen])
        out[f"prefill_{n}"] = {
            "calls": calls,
            "max_diff": float((rules.full_value(logits) - want).abs().max())}
    return out


def train_main_runs(d, rank: int) -> dict:
    """``train.main`` over the (2, 4) mesh (``--mesh 2,4``): the reduced
    smollm, 3 steps, a checkpoint every 2 steps, uninterrupted and again
    with a failure injected at step 2, which restores step 2 through the
    param and moment shardings; then, on rank 0 alone, unsharded. Each
    run's logged losses and the failed run's restore lines."""
    import contextlib
    import io
    from repro_torch.launch import train

    common = ["--arch", "smollm-360m", "--reduce", "--device", "cpu",
              "--steps", "3", "--global-batch", "8", "--seq", "32",
              "--microbatch", "4", "--log-every", "1", "--ckpt-every", "2"]
    out = {}
    for name, extra in (("sharded", ["--mesh", "2,4"]),
                        ("sharded_failed", ["--mesh", "2,4",
                                            "--inject-failure-at", "2"]),
                        ("unsharded", [])):
        if not extra and rank != 0:
            continue
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            log = train.main(common + extra + [
                "--ckpt-dir", str(d / f"train_{name}")])
        lines = text.getvalue().splitlines()
        out[name] = {"losses": [r["loss"] for r in log],
                     "restores": [x for x in lines
                                  if x.startswith("[restore]")],
                     "result": json.loads(lines[-1])["result"]
                     if lines else None}
    return out


def main(rank: int, d: str):
    try:
        run(rank, pathlib.Path(d))
    except Exception:
        traceback.print_exc()
        os._exit(1)


if __name__ == "__main__":
    mp.spawn(main, args=(sys.argv[1],), nprocs=WORLD)
