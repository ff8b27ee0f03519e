"""The port's dry run: ``launch/hlo_analysis.py``'s op-trace cost model,
``launch/mesh.py``'s fake worlds and ``launch/dryrun.py``.

- The reference's three ``analyze`` calibrations (``tests/
  test_integration.py``): a 7-trip loop, a 3-in-5 nested loop, and an
  all-reduce's 2x payload, here on a fake world of 4 ranks. Product FLOPs
  equal the reference ``analyze`` of the same function exactly (its
  elementwise ops aside: XLA's loop counters add a few).
- Reduced smollm's train, prefill and decode steps dry-run on a fake
  (1, 1) world: FLOPs, bytes and the op stream equal those of the same
  steps run for real on the CPU (a one-rank gloo mesh), kernel 7 counted
  by the same stand-in.
- On a fake (2, 4) world: argument bytes equal the rank's local shard
  bytes by ``rules``; a train step traced over two of its four
  microbatches costs what the whole trace costs; the real 8-rank gloo
  comparison of collectives is in ``test_torch_sharded_engine.py``.
- The CLI on production cells: ``[ok]`` for mamba2's long_500k, ``[skip]``
  for smollm's; the fake world's group is torn down after each cell.
"""
import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.launch import hlo_analysis as jhlo
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec, input_specs
from repro_torch.launch import dryrun, hlo_analysis, steps
from repro_torch.launch.hlo_analysis import OpTrace, analyze
from repro_torch.launch.mesh import fake_world, make_cpu_mesh
from repro_torch.nn import module
from repro_torch.nn import transformer as T
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from torch_threads import one_thread  # noqa: F401  (autouse)

KINDS = ["train", "prefill", "decode"]


def _products(trace) -> float:
    return analyze([op for op in trace.ops
                    if op.name in hlo_analysis._PRODUCTS]).flops


def _ref_products(text: str, monkeypatch) -> float:
    """The reference analyzer's FLOPs of ``dot`` and ``convolution`` only:
    its elementwise set emptied for the call."""
    monkeypatch.setattr(jhlo, "_ARITH_OPS", set())
    return jhlo.analyze(text).flops


def test_loop_flops_equal_the_reference(monkeypatch):
    M = K = N = 128
    trips = 7

    def f(w, x):
        def body(c, _):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, None, length=trips)
        return y

    text = jax.jit(f).lower(jax.ShapeDtypeStruct((K, N), jnp.float32),
                            jax.ShapeDtypeStruct((M, K), jnp.float32)
                            ).compile().as_text()
    with OpTrace() as tr:
        w = torch.empty((K, N), device="meta")
        c = torch.empty((M, K), device="meta")
        for _ in range(trips):
            c = torch.tanh(c @ w)
    cost = analyze(tr)
    assert _products(tr) == trips * 2 * M * K * N
    assert _products(tr) == _ref_products(text, monkeypatch)
    assert cost.flops == trips * (2 * M * K * N + M * N)


def test_nested_loop_flops_equal_the_reference(monkeypatch):
    def f(x):
        def outer(c, _):
            def inner(c2, _):
                return c2 @ c2, None
            y, _ = jax.lax.scan(inner, c, None, length=3)
            return y, None
        z, _ = jax.lax.scan(outer, x, None, length=5)
        return z

    text = jax.jit(f).lower(jax.ShapeDtypeStruct((64, 64), jnp.float32)
                            ).compile().as_text()
    with OpTrace() as tr:
        c = torch.empty((64, 64), device="meta")
        for _ in range(5):
            for _ in range(3):
                c = c @ c
    assert _products(tr) == 15 * 2 * 64 ** 3
    assert _products(tr) == _ref_products(text, monkeypatch)


def test_all_reduce_counts_twice_its_payload_on_a_fake_world():
    """An all-reduce of n f32 over 4 fake ranks: 2 x 4n bytes (the
    reference accepts 0 on its one device: here the group has 4 ranks),
    one count, booked to its mesh axis."""
    import torch.distributed._functional_collectives as funcol
    n = 4096
    with fake_world((4,), ("x",)) as mesh:
        axes = {mesh.get_group(0).group_name: "x"}
        with OpTrace() as tr:
            y = funcol.all_reduce(torch.empty(n, device="meta"), "sum",
                                  (mesh, 0))
            funcol.wait_tensor(y)
    cost = analyze(tr, axes)
    assert cost.coll_bytes["all-reduce"] == 2.0 * 4 * n
    assert cost.coll_counts["all-reduce"] == 1
    assert cost.coll_axis_bytes == {"x": 2.0 * 4 * n}
    assert cost.collective_total == 2.0 * 4 * n
    assert not dist.is_initialized()


def test_trace_keeps_dtensor_propagation_out():
    """DTensor propagates its metadata by running an op once more on
    global shapes, the first time an op schema is seen only: the trace of
    the same sharded product holds the same local ops, cold or warm."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with fake_world((2, 4), ("data", "model")) as mesh:
        x = DTensor.from_local(torch.empty(8, 64, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(64, 8, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        runs = []
        for _ in range(2):
            with OpTrace() as tr:
                (x @ w).redistribute(mesh, [Shard(0), Replicate()])
            runs.append(tr.ops)
    assert runs[0] == runs[1]
    mm = [op for op in runs[0] if op.name == "mm"]
    assert [op.inputs for op in mm] == [(((8, 64), 4), ((64, 8), 4))]


def test_fake_world_counts_an_all_to_all_as_the_card_does():
    """A shard-to-shard redistribution on a fake (2, 4) world of the
    ``cpu`` type is one all-to-all of the shard's bytes, as on the H100's
    NCCL mesh, not gloo's all-gather of the whole dim (4x the bytes, and
    a gathered buffer held); the swap is undone after the world."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor import _collective_utils as cu
    real = cu.shard_dim_alltoall
    with fake_world((2, 4), ("data", "model"), device_type="cpu") as mesh:
        x = DTensor.from_local(torch.empty(8, 64, device="meta"), mesh,
                               [Replicate(), Shard(0)], run_check=False)
        axes = {mesh.get_group(i).group_name: n
                for i, n in enumerate(mesh.mesh_dim_names)}
        with OpTrace() as tr:
            y = x.redistribute(mesh, [Replicate(), Shard(1)])
        assert y.to_local().shape == (32, 16)
    cost = analyze(tr, axes)
    shard = 8 * 64 * 4
    assert cost.coll_bytes["all-to-all"] == shard
    assert cost.coll_counts == {**dict.fromkeys(cost.coll_counts, 0),
                                "all-to-all": 1}
    assert cost.coll_axis_bytes == {"model": shard}
    assert tr.peak_bytes == shard
    assert [op.name for op in tr.ops] == ["shard_dim_alltoall"]
    assert cu.shard_dim_alltoall is real


@pytest.mark.parametrize("hook", range(len(hlo_analysis._BOOKKEEPING)))
def test_trace_refuses_a_torch_without_its_bookkeeping_hooks(hook,
                                                           monkeypatch):
    """Without one of the DTensor internals it keeps out, a trace would
    count DTensor's propagation on global shapes as the rank's ops: it
    raises, and leaves no other hook swapped."""
    import importlib
    name = hlo_analysis._BOOKKEEPING[hook]
    owner = getattr(importlib.import_module(name[0]), name[1])
    monkeypatch.delattr(owner, name[2])
    others = [(getattr(importlib.import_module(m), c), f)
              for i, (m, c, f) in enumerate(hlo_analysis._BOOKKEEPING)
              if i != hook]
    before = [o.__dict__[f] for o, f in others]
    with pytest.raises(RuntimeError, match=name[2]):
        with OpTrace():
            pass
    assert [o.__dict__[f] for o, f in others] == before


def test_trace_follows_live_storage():
    with OpTrace() as tr:
        a = torch.empty((256, 256), device="meta")
        b = a @ a
        del a
        c = b + 1
        del b, c
    assert tr.peak_bytes == 2 * 256 * 256 * 4
    assert tr.live_bytes == 0


def _real_run(cfg, kind: str, shape: ShapeSpec, mesh):
    """``kind``'s sharded step on real CPU tensors over ``mesh``, its
    arguments placed first, under an ``OpTrace`` with the dry run's
    kernel stand-in (computing)."""
    spec = input_specs(cfg, shape)
    gen = torch.Generator().manual_seed(1)
    params = T.init_model(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    batch = {k: torch.randint(0, cfg.vocab, v.shape, generator=gen,
                              dtype=v.dtype)
             for k, v in spec["batch"].items() if k != "cache_pos"}
    if kind == "train":
        ts = dryrun._train_settings(cfg, 2)
        step, _, sh = steps.jit_train_step(cfg, mesh, ts, spec["batch"])
        args = (rules.place_tree(params, sh[0]),
                rules.place_tree(adamw.init(params, steps.opt_config(cfg, ts)),
                                 sh[1]),
                rules.place_tree(batch, sh[2]))
    elif kind == "prefill":
        step, _, sh = steps.jit_prefill(cfg, mesh, spec["batch"])
        args = (rules.place_tree(params, sh[0]),
                rules.place_tree(batch, sh[1]))
    else:
        step, _, sh = steps.jit_serve_step(cfg, mesh, spec["cache"],
                                           spec["batch"])
        args = (rules.place_tree(params, sh[0]),
                rules.place_tree(T.init_cache(cfg, shape.batch, shape.seq,
                                              device="cpu"), sh[1]),
                {"tokens": rules.place(batch["tokens"], sh[2]["tokens"]),
                 "cache_pos": shape.seq - 1})
    trace = OpTrace()
    with dryrun.kernels_stood_in(trace, compute=True), trace:
        step(*args)
    return trace


@pytest.mark.parametrize("kind", KINDS)
def test_one_rank_dry_run_equals_the_real_cpu_run(kind):
    """Reduced smollm, B 4, S 32 (train: microbatches of 2): the fake
    (1, 1) world's trace and a real one-rank gloo run's hold the same ops
    with the same shapes, so the same FLOPs and bytes; kernel 7 is one op
    a layer in the prefill."""
    cfg = get_config("smollm-360m").reduced()
    shape = ShapeSpec(kind, kind, 32, 4)
    rec, fake = dryrun.dry_run(cfg, shape, (1, 1), ("data", "model"),
                               microbatch=2, device_type="cpu")
    assert not dist.is_initialized()
    mesh = make_cpu_mesh(device="cpu")
    try:
        real = _real_run(cfg, kind, shape, mesh)
    finally:
        dist.destroy_process_group()
    assert [(o.name, o.inputs, o.outputs) for o in fake.ops] == \
        [(o.name, o.inputs, o.outputs) for o in real.ops]
    assert rec["cost"]["flops_per_chip"] == analyze(real).flops > 0
    assert rec["cost"]["hbm_bytes_per_chip"] == analyze(real).bytes
    flash = [o for o in fake.ops if o.name == "kernel:flash_attention"]
    assert len(flash) == (cfg.n_layers if kind == "prefill" else 0)


@pytest.mark.parametrize("kind", KINDS)
def test_argument_bytes_are_the_local_shards(kind):
    """On a fake (2, 4) world: params, optimizer state, batch and cache
    bytes of rank 0 equal its shards by ``rules.local_slices``."""
    cfg = get_config("smollm-360m").reduced()
    shape = ShapeSpec(kind, kind, 32, 8)
    rec, _ = dryrun.dry_run(cfg, shape, (2, 4), ("data", "model"),
                            microbatch=4, device_type="cpu")
    spec = input_specs(cfg, shape)
    p_abs = steps.abstract_params(cfg)

    def local(tree, shardings_of):
        with fake_world((2, 4), ("data", "model"), device_type="cpu") as m:
            sh = dict(module.tree_paths(shardings_of(m, tree)))
            return sum(math.prod(s.stop - s.start for s in
                                 rules.local_slices(t.shape, sh[p]))
                       * t.element_size()
                       for p, t in module.tree_paths(tree))

    want = {"params": local(p_abs, rules.param_shardings)}
    batch = {k: v for k, v in spec["batch"].items() if k != "cache_pos"}
    want["batch"] = local(batch, rules.batch_shardings)
    if kind == "train":
        o_abs = steps.abstract_opt_state(cfg, p_abs,
                                         dryrun._train_settings(cfg, 4))
        want["opt_state"] = local(o_abs, rules.opt_state_shardings)
    if kind == "decode":
        want["cache"] = local(spec["cache"], rules.cache_shardings)
    assert rec["memory"]["argument_bytes_by_kind"] == want
    assert rec["memory"]["argument_bytes"] == sum(want.values())
    assert want["params"] * 8 > sum(t.numel() * t.element_size()
                                    for _, t in module.tree_paths(p_abs))


def test_cut_microbatches_cost_the_whole_trace():
    """A train step of 4 microbatches (B 8, microbatches of 2) on a fake
    (2, 4) world, traced over 2 with the other 2 added at the second's
    cost, equals the trace of all 4: FLOPs, bytes, collectives; the peak
    the same but for the one loss the cut holds on to."""
    cfg = get_config("smollm-360m").reduced()
    shape = ShapeSpec("train", "train", 32, 8)
    cut, _ = dryrun.dry_run(cfg, shape, (2, 4), ("data", "model"),
                            microbatch=2)
    whole, _ = dryrun.dry_run(cfg, shape, (2, 4), ("data", "model"),
                              microbatch=2, cut_microbatches=False)
    assert cut["microbatches"] == {"run": 2, "skipped": 2}
    assert whole["microbatches"] is None
    for key in ("cost", "collectives"):
        assert cut[key] == whole[key], key
    assert cut["memory"]["argument_bytes"] == whole["memory"]["argument_bytes"]
    # the cut keeps the last run microbatch's loss (one f32) to hand on
    assert 0 <= cut["memory"]["temp_bytes"] - whole["memory"]["temp_bytes"] \
        <= 4


def test_kernel_stand_in_records_the_bound_formula():
    with OpTrace() as tr, dryrun.kernels_stood_in(tr):
        from repro_torch.kernels import ops
        q = torch.empty((2, 8, 16, 64), dtype=torch.bfloat16, device="meta")
        k = torch.empty((2, 2, 48, 64), dtype=torch.bfloat16, device="meta")
        out = ops.flash_attention(q, k, k, scale=0.125, causal=True)
    assert out.shape == q.shape and out.dtype == torch.float32
    (op,) = [o for o in tr.ops if o.name == "kernel:flash_attention"]
    kept = 16 * 32 + 16 * 17 // 2
    assert op.flops == 4 * 2 * 8 * kept * 64
    assert op.bytes == (q.numel() + 2 * k.numel()) * 2 + q.numel() * 4


def test_axis_links():
    assert dryrun.axis_links((16, 16), ("data", "model")) == {
        "data": dryrun.NET_BW, "model": dryrun.NET_BW}
    assert dryrun.axis_links((2, 4), ("data", "model")) == {
        "data": dryrun.NVLINK_BW, "model": dryrun.NVLINK_BW}
    assert dryrun.axis_links((32, 8), ("data", "model")) == {
        "data": dryrun.NET_BW, "model": dryrun.NVLINK_BW}


def test_cli_ok_and_skip(tmp_path, capsys):
    """mamba2's long_500k on the 16x16 fake world (one decode step of a
    524,288-token state, batch 1) prints ``[ok]`` and writes its record;
    smollm's prints ``[skip]``; no group is left up."""
    dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "smollm-360m", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[ok] mamba2-130m_long_500k_16x16:")
    assert lines[1].startswith("[skip] smollm-360m_long_500k_16x16:")
    rec = json.loads((tmp_path / "mamba2-130m_long_500k_16x16.json"
                      ).read_text())
    assert rec["n_chips"] == 256 and rec["kind"] == "decode"
    assert rec["memory"]["fits_80gb"]
    assert rec["params"]["total"] == get_config("mamba2-130m").n_params()
    assert set(rec) >= {"arch", "shape", "mesh", "lower_s", "compile_s",
                        "memory", "cost", "collectives", "roofline",
                        "params"}
    assert not dist.is_initialized()


def test_each_microbatch_s_loss_runs_on_the_rank_s_rows():
    """On a fake (2, 4) world, reduced smollm's train step (B 8 in
    microbatches of 4): no traced op holds a whole microbatch's scores
    over the whole vocabulary (4 x 32 x 512). Slicing a microbatch out of
    the dp-sharded batch gives every rank all its rows; without laying
    them out over dp again, each rank's loss took the whole microbatch's
    vocab-wide scores (glm4-9b's train_4k on 16x16: 100 GB a rank)."""
    cfg = get_config("smollm-360m").reduced()
    _, trace = dryrun.dry_run(cfg, ShapeSpec("train", "train", 32, 8),
                              (2, 4), ("data", "model"), microbatch=4,
                              device_type="cpu", cut_microbatches=False)
    whole = (4, 32, cfg.padded_vocab)
    assert not [op.name for op in trace.ops
                if any(o[0] == whole for o in op.outputs)]
    assert any(o[0] == (2, 32, cfg.padded_vocab // 4)
               for op in trace.ops for o in op.outputs)


def test_mixed_partials_reduce_one_axis_at_a_time():
    """A loss's (mean over dp, sum over the vocab's shards) partial
    values, placed replicated: one all-reduce on each mesh axis (torch
    2.11 refused to merge the two kinds into one reduction)."""
    from torch.distributed.tensor import DTensor, Partial
    with fake_world((2, 4), ("data", "model"), device_type="cpu") as mesh:
        x = DTensor.from_local(torch.empty((), device="meta"), mesh,
                               [Partial("avg"), Partial("sum")],
                               run_check=False)
        axes = {mesh.get_group(i).group_name: n
                for i, n in enumerate(mesh.mesh_dim_names)}
        with OpTrace() as tr:
            y = rules.place(x, rules.NamedSharding(mesh, rules.P()))
        assert all(not pl.is_partial() for pl in y.placements)
    cost = analyze(tr, axes)
    assert cost.coll_counts["all-reduce"] == 2
    assert set(cost.coll_axis_bytes) == {"data", "model"}
