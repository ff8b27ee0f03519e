"""Ranks of ``test_torch_sharded_engine.py``: continuous batching over a
(2, 4) ``("data", "model")`` mesh of 8 CPU ranks over gloo, and rank 0's
recorded op trace of the sharded steps.

    python tests/sharded_engine_worker.py DIR

reads ``DIR/inputs.npz`` (the reference engines' params, flattened by
path, and the requests in ``DIR/inputs.json``), spawns 8 ranks that
rendezvous through a ``FileStore`` in DIR (no port is chosen), and writes
rank 0's results to ``DIR/out.json``:

- ``writes``: for each case (linear, ring that wraps, writes past a linear
  cache's end; one token and several; ``pos`` plain and a DTensor), whether
  ``cache_update`` of the (B, KV, L, Dh) cache placed by
  ``rules.cache_shardings`` equals the plain ``cache_update`` of the full
  tensors, leaf by leaf;
- ``engines``: each config's tokens from the port's unsharded ``Engine``
  and from ``Engine(mesh=...)``, and the local shape of a pool leaf;
- ``traced``: rank 0's collective bytes and counts by kind, and bytes by
  mesh axis, of reduced smollm's ``jit_train_step``, ``jit_prefill`` and
  ``jit_serve_step`` (``hlo_analysis.OpTrace``, kernel 7 recorded by the
  dry run's stand-in), its arguments placed before the trace. DTensor's
  shard-to-shard redistributions run as all-to-alls, as on the card
  (``mesh.all_to_all_as_on_the_card``; gloo has the op, DTensor's CPU
  branch gathers instead), and ``prefill_all_to_all_equal`` says whether
  the prefill's output so equals that of DTensor's own CPU branch.

Imports torch and the port only.
"""
from __future__ import annotations

import json
import os
import pathlib
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

WORLD, MESH = 8, (2, 4)
# (B, KV, L, Dh) of the write cases; L splits 4 ways over the model axis
B, KV, L, DH = 4, 2, 16, 8


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


def write_cases(mesh) -> dict:
    """Each sharded per-row (or aligned) write against the plain one."""
    from repro_torch.nn import attention as attn
    from repro_torch.sharding import rules, set_mesh
    from torch.distributed.tensor import DTensor

    rng = np.random.default_rng(11)
    cases = {
        "linear_one": (False, 1, [3, 15, 0, 8]),
        "linear_many": (False, 3, [2, 9, 12, 0]),
        "past_end_one": (False, 1, [L, 5, L + 3, 15]),
        "past_end_many": (False, 4, [14, 13, 2, 15]),
        "ring_one": (True, 1, [17, 3, 31, 48]),
        "ring_many": (True, 5, [14, 30, 1, 40]),
        "aligned": (False, 3, 6),
        "ring_aligned": (True, 5, 14),
    }
    out = {}
    for name, (ring, s_new, pos) in cases.items():
        for as_dtensor in ((False, True) if not isinstance(pos, int)
                           else (False,)):
            base = {
                "k": torch.from_numpy(rng.standard_normal(
                    (B, KV, L, DH)).astype(np.float32)),
                "v": torch.from_numpy(rng.standard_normal(
                    (B, KV, L, DH)).astype(np.float32)),
                "positions": torch.from_numpy(rng.integers(
                    -1, 40, (B, L)).astype(np.int32))}
            k_new = torch.from_numpy(rng.standard_normal(
                (B, KV, s_new, DH)).astype(np.float32))
            v_new = torch.from_numpy(rng.standard_normal(
                (B, KV, s_new, DH)).astype(np.float32))
            p = pos if isinstance(pos, int) else torch.tensor(pos)
            want = attn.cache_update({k: t.clone() for k, t in base.items()},
                                     k_new, v_new, p, ring=ring)
            sh = rules.cache_shardings(mesh, {"kv": base})["kv"]
            placed = rules.place_tree(base, sh)
            with set_mesh(mesh):
                pp = p
                if as_dtensor:
                    pp = rules.place(p, rules.batch_shardings(
                        mesh, {"p": p})["p"])
                got = attn.cache_update(placed, k_new, v_new, pp, ring=ring)
            tag = name + ("_dtensor_pos" if as_dtensor else "")
            out[tag] = {
                "equal": all(torch.equal(rules.full_value(got[k]), want[k])
                             for k in want),
                "sharded": all(isinstance(got[k], DTensor) for k in want)
                and any(pl.is_shard(2) for pl in got["k"].placements)}
    return out


def engines(inp, requests, mesh) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine, Request, cache_leaves
    from repro_torch.weights import lm_from_reference

    out = {}
    for name, spec in requests.items():
        cfg = get_config(spec["arch"]).reduced(**spec["reduced"])
        tree = unflatten({k: v.numpy() for k, v in inp.items()},
                         f"params_{name}")
        params = lm_from_reference(tree, cfg, device="cpu")
        res = {}
        for label, m in (("unsharded", None), ("sharded", mesh)):
            eng = Engine(cfg, slots=spec["slots"],
                         cache_len=spec["cache_len"], params=params,
                         compute_dtype=torch.float32,
                         cache_dtype=torch.float32, device="cpu", mesh=m)
            for i, (prompt, n) in enumerate(zip(spec["prompts"],
                                                spec["max_new"])):
                eng.submit(Request(rid=i, prompt=prompt, max_new=n))
            done = sorted(eng.run(), key=lambda r: r.rid)
            res[label] = [r.out for r in done]
            if m is not None:
                leaf = next(t for n_, t in cache_leaves(eng.pool)
                            if n_ == "k")
                res["pool_k_local_shape"] = list(leaf.to_local().shape)
                res["pool_k_shape"] = list(leaf.shape)
        out[name] = res
    return out


def traced(mesh, rank: int) -> dict:
    """Rank 0's collectives in reduced smollm's three sharded steps (B 8,
    S 32, microbatches of 4), arguments placed before each trace."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec, input_specs
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.hlo_analysis import OpTrace, analyze
    from repro_torch.launch.mesh import all_to_all_as_on_the_card
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import tree_paths
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules

    cfg = get_config("smollm-360m").reduced()
    axes = {mesh.get_group(i).group_name: n
            for i, n in enumerate(mesh.mesh_dim_names)}
    params = T.init_model(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    gen = torch.Generator().manual_seed(1)
    out = {}
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec(kind, kind, 32, 8)
        spec = input_specs(cfg, shape)
        batch = {k: torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                  dtype=v.dtype)
                 for k, v in spec["batch"].items() if k != "cache_pos"}
        if kind == "train":
            ts = dryrun._train_settings(cfg, 4)
            step, _, sh = steps.jit_train_step(cfg, mesh, ts, spec["batch"])
            opt = adamw.init(params, steps.opt_config(cfg, ts))
            args = (rules.place_tree(params, sh[0]),
                    rules.place_tree(opt, sh[1]),
                    rules.place_tree(batch, sh[2]))
        elif kind == "prefill":
            step, _, sh = steps.jit_prefill(cfg, mesh, spec["batch"])
            args = (rules.place_tree(params, sh[0]),
                    rules.place_tree(batch, sh[1]))
        else:
            step, _, sh = steps.jit_serve_step(cfg, mesh, spec["cache"],
                                               spec["batch"])
            cache = T.init_cache(cfg, 8, 32, device="cpu")
            args = (rules.place_tree(params, sh[0]),
                    rules.place_tree(cache, sh[1]),
                    {"tokens": rules.place(batch["tokens"],
                                           sh[2]["tokens"]),
                     "cache_pos": 31})
        trace = OpTrace()
        with dryrun.kernels_stood_in(trace, compute=True), \
                all_to_all_as_on_the_card(), trace:
            got = step(*args)
        if kind == "prefill":
            want = step(*args)
            out["prefill_all_to_all_equal"] = all(
                torch.equal(rules.full_value(a), rules.full_value(b))
                for (_, a), (_, b) in zip(
                    tree_paths(got), tree_paths(want)))
        cost = analyze(trace, axes)
        out[kind] = {"bytes": cost.coll_bytes, "counts": cost.coll_counts,
                     "axis_bytes": cost.coll_axis_bytes,
                     "flops": cost.flops}
    return out


def run(rank: int, d: pathlib.Path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"),
                                                         WORLD),
                            rank=rank, world_size=WORLD)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    meta = json.loads((d / "inputs.json").read_text())
    inp = {k: torch.from_numpy(v.copy())
           for k, v in np.load(d / "inputs.npz").items()}
    res = {"writes": write_cases(mesh),
           "engines": engines(inp, meta["requests"], mesh),
           "traced": traced(mesh, rank)}
    dist.barrier()
    if rank == 0:
        (d / "out.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def main(rank: int, d: str):
    try:
        run(rank, pathlib.Path(d))
    except Exception:
        traceback.print_exc()
        os._exit(1)


if __name__ == "__main__":
    mp.spawn(main, args=(sys.argv[1],), nprocs=WORLD)
