"""The port's sharded steps across ranks: ``jit_train_step``,
``jit_serve_step`` and ``jit_prefill`` on a (2, 4) ``("data", "model")``
mesh of 8 CPU ranks over gloo, ``compressed_psum_int8`` across 4 ranks and
the elastic restore, against the reference's unsharded steps.

Every other family's reduced train step (MoE, dense-parallel MoE, SSM,
hybrid, encoder-decoder, VLM) is held to the port's unsharded step on the
same mesh, and so is smollm with 6 q heads over 2 KV heads, which the
model axis of 4 does not divide: its attention runs on query rows, in
the train step's chunked softmax and in the prefill's flash calls (each
rank's keys cut at its last row; at a prompt of 30 tokens, which 4 does
not divide either, on the whole sequence). ``launch.train.main`` runs
over the mesh (``--mesh 2,4``), uninterrupted and through a restart that
restores by the param and moment shardings, against its unsharded run.

The ranks run in a subprocess (``tests/sharded_steps_worker.py``) that
rendezvouses through a ``FileStore`` under ``tmp_path``, so xdist workers
never race for a port; the run has its own timeout. The config is
``tests/test_multidevice.py``'s reduced smollm (2 layers, d_model 128, 4
heads over 2, vocab 512; B 8, S 32, microbatch 4), and the same reduction
of qwen1.5-110b (QKV bias, bf16 params and moments). Both start from the
reference's ``init_model`` tree.

Tolerances: the reference's own for its sharded-vs-single check (loss
rtol 2e-4, every param and moment rtol = atol = 3e-3, the configs'
bf16 compute), and 1e-5 (atol = rtol) against the port's unsharded step,
both in f32 compute (the same ops, the sums split across ranks; in bf16
the partial sums of a product split across ranks are rounded to bf16
before they are added, which moves a gradient by ~1%). The prefill's
logits sit within 1e-5 of the unsharded prefill's in f32 compute, its
bf16 cache within one bf16 ulp of each value plus 1e-5 of the leaf's
largest (a small value made by cancellation carries the f32 sums'
error). Decode tokens, restores and the int8
payload's dequantised mean (rtol 1e-6) are exact or nearly.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs.base import get_config as jget_config
from repro.launch import steps as jsteps
from repro.nn import module as jmodule
from repro.nn import transformer as JT
from repro.optim import adamw as jadamw
from repro.optim.compression import compressed_psum_int8 as jpsum
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import steps
from repro_torch.nn import module
from repro_torch.sharding import rules
from torch_threads import one_thread  # noqa: F401  (autouse)

HERE = pathlib.Path(__file__).resolve().parent
ARCHS = {"smollm": "smollm-360m", "qwen": "qwen1.5-110b"}
REDUCED = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, vocab=512)
B, S = 8, 32
TIMEOUT_S = 600


def as_numpy(x):
    """(array, dtype name): bf16 as its uint16 bits."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's side, then the 8-rank run on the same inputs."""
    d = tmp_path_factory.mktemp("sharded")
    key = jax.random.PRNGKey(1)
    batch = {"tokens": jax.random.randint(key, (B, S), 0, 512),
             "labels": jax.random.randint(key, (B, S), 0, 512)}
    arrays, dtypes, ref = {}, {}, {}
    for k, v in batch.items():
        arrays[f"batch/{k}"], dtypes[f"batch/{k}"] = as_numpy(
            v.astype(jnp.int32))
    ts = jsteps.TrainSettings(microbatch=4)
    for name, arch in ARCHS.items():
        cfg = jget_config(arch).reduced(**REDUCED)
        params = JT.init_model(jax.random.PRNGKey(0), cfg)
        for path, leaf in jmodule.tree_paths(params):
            arrays[f"params_{name}/{path}"], dtypes[
                f"params_{name}/{path}"] = as_numpy(leaf)
        opt = jadamw.init(params, jadamw.OptConfig(
            state_dtype=jnp.dtype(cfg.opt_state_dtype)))
        p, o, m = jax.jit(jsteps.make_train_step(cfg, ts))(params, opt,
                                                          batch)
        ref[name] = (p, o, m)
        if name == "smollm":
            cache = JT.init_cache(cfg, B, S, dtype=jnp.float32)
            logits, _, _ = JT.model_apply(
                params, {"tokens": batch["tokens"][:, :1],
                         "cache_pos": jnp.int32(0)}, cfg, mode="decode",
                cache=cache, compute_dtype=jnp.float32)
            ref["tokens"] = np.asarray(jnp.argmax(logits[:, -1], -1))
    x = np.random.default_rng(3).standard_normal((4, 64)).astype(np.float32)
    x[2] *= 40.0                                  # ranks with other scales
    arrays["psum/x"], dtypes["psum/x"] = x, "float32"
    ref["psum"] = np.asarray(jax.vmap(lambda v: jpsum(v, "i"),
                                      axis_name="i")(jnp.asarray(x)))
    np.savez(d / "inputs.npz", **arrays)
    (d / "inputs.json").write_text(json.dumps({"dtypes": dtypes}))
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"),
               OMP_NUM_THREADS="1")
    worker = HERE / "sharded_steps_worker.py"
    out = subprocess.run([sys.executable, str(worker), str(d)],
                         capture_output=True, text=True, timeout=TIMEOUT_S,
                         env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads((d / "out.json").read_text())
    return d, ref, res, dict(np.load(d / "out.npz"))


def _leaf(arrays, key, want):
    got = arrays[key]
    return got.view(jnp.bfloat16) if want.dtype == jnp.bfloat16 else got


@pytest.mark.parametrize("name", list(ARCHS))
def test_sharded_train_step_matches_the_reference(run, name):
    """Within the reference's own tolerances of its unsharded jitted step
    (``tests/test_multidevice.py``), every param and moment."""
    _, ref, res, arrays = run
    p_ref, o_ref, m_ref = ref[name]
    np.testing.assert_allclose(res[f"{name}_metrics"]["loss"],
                               float(m_ref["loss"]), rtol=2e-4)
    n = 0
    for prefix, tree in (("p", p_ref), ("o", o_ref)):
        for path, want in jmodule.tree_paths(tree):
            got = _leaf(arrays, f"{name}/{prefix}/{path}", want)
            np.testing.assert_allclose(np.asarray(got, np.float32),
                                       np.asarray(want, np.float32),
                                       rtol=3e-3, atol=3e-3, err_msg=path)
            n += 1
    assert n == res[f"{name}_n_leaves"]


@pytest.mark.parametrize("name", list(ARCHS))
def test_sharded_train_step_matches_the_unsharded_port(run, name):
    """In f32 compute: every param and moment within 1e-5 + 1e-5 x
    |value|, and the metrics."""
    _, _, res, _ = run
    worst = max(res[f"{name}_vs_plain"].items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-5, worst
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(res[f"{name}_f32_metrics"][k],
                                   res[f"{name}_plain_metrics"][k],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("family", ["moe", "moe_dense_parallel", "ssm",
                                    "hybrid", "encdec", "vlm"])
def test_every_family_s_sharded_train_step_matches_the_unsharded_port(
        run, family):
    """qwen3-moe (MoE routing under ``local_map``), arctic-480b (dense
    parallel), mamba2 (the SSD chunk loop), hymba (the hybrid's hint),
    whisper (the encoder, cross heads) and qwen2-vl (M-RoPE's (3, B, S)
    positions over dp) at ``reduced()``, from the port's seeded init, in
    f32 compute: every param and moment within 1e-5 + 1e-5 x |value| of
    the unsharded step, the loss within 1e-5."""
    _, _, res, _ = run
    got = res["families"][family]
    assert got["worst"] <= 1e-5, got
    np.testing.assert_allclose(got["loss"][1], got["loss"][0], rtol=1e-5)


@pytest.mark.parametrize("name", list(ARCHS))
def test_each_rank_holds_its_share_of_every_leaf(run, name):
    """A rank's local bytes of each param and moment are the leaf's bytes
    over the product of its spec's mesh axes (no rank gathers a leaf)."""
    _, _, res, _ = run
    assert res[f"{name}_local_shares_ok"]
    assert res[f"{name}_n_leaves"] > 0


def test_sharded_decode_tokens_equal_the_reference(run):
    _, ref, res, arrays = run
    np.testing.assert_array_equal(arrays["decode_tokens"], ref["tokens"])
    # tokens over dp; the cache's KV sequence over the model axis
    assert res["decode_tok_placements"] == [["Shard", 0],
                                            ["Replicate", None]]
    assert res["cache_k_placements"] == [["Shard", 1], ["Shard", 3]]


def test_sharded_prefill_runs_flash_on_local_heads(run):
    """One flash call a layer on each rank, on its one local q head (4
    over the model axis of 4) and the one KV head it reads, over its dp
    rows; logits and cache within 1e-5 of the unsharded prefill."""
    _, _, res, _ = run
    calls = res["prefill_flash_calls"]
    assert [tuple(map(tuple, c)) for c in calls] == \
        [((4, 1, S, 32), (4, 1, S, 32))] * REDUCED["n_layers"]
    assert res["prefill_max_diff"] <= 1e-5
    assert res["prefill_cache_within_ulp"]


def test_uneven_heads_train_step_runs_on_query_rows(run):
    """6 q heads over a model axis of 4: every forward pins q and the
    chunked softmax's q chunk and scores to query rows (3 hints a layer,
    2 layers, 2 microbatches), each rank's (2 rows of its dp half, 6
    heads, 8 of 32 positions, 32); params and moments within 1e-5 +
    1e-5 x |value| of the unsharded step."""
    _, _, res, _ = run
    got = res["rows"]
    assert got["train_hints"] == [[2, 6, S // 4, 32]] * (3 * 2 * 2)
    assert got["train_worst"] <= 1e-5, got["train_worst"]
    np.testing.assert_allclose(got["train_loss"][1], got["train_loss"][0],
                               rtol=1e-5)


@pytest.mark.parametrize("n", [32, 30])
def test_uneven_heads_prefill_runs_flash_on_query_rows(run, n):
    """At 32 tokens, model rank r's flash call (one a layer) takes its 8
    query rows and the keys up to its last row, 8 (r + 1) of them; at 30,
    which the model axis does not divide, the whole sequence. The logits
    within 1e-5 of the unsharded prefill."""
    _, _, res, _ = run
    got = res["rows"][f"prefill_{n}"]
    assert len(got["calls"]) == 8
    for r, calls in got["calls"]:
        rows, keys = (n // 4, 8 * (r + 1)) if n % 4 == 0 else (n, n)
        assert calls == [[[B // 2, 6, rows, 32], [B // 2, 2, keys, 32]]] \
            * REDUCED["n_layers"], (r, calls)
    assert got["max_diff"] <= 1e-5


def test_train_main_over_the_mesh(run):
    """``train.main --mesh 2,4``: completes; with a failure injected at
    step 2 it restores step 2's checkpoint through the shardings once and
    logs the uninterrupted run's losses; both within the reference's loss
    rtol 2e-4 of the unsharded run (bf16 compute, the partial sums split
    across ranks)."""
    _, _, res, _ = run
    got = res["train_main"]
    assert got["sharded"]["result"] == {"restarts": 0, "completed": True}
    failed = got["sharded_failed"]
    assert failed["result"] == {"restarts": 1, "completed": True}
    assert len(failed["restores"]) == 1
    assert failed["restores"][0].startswith("[restore] step 2 from ")
    assert failed["losses"] == got["sharded"]["losses"]
    assert len(got["unsharded"]["losses"]) == 3
    np.testing.assert_allclose(got["sharded"]["losses"],
                               got["unsharded"]["losses"], rtol=2e-4)


def test_compressed_psum_int8_matches_the_reference(run):
    _, ref, _, arrays = run
    np.testing.assert_allclose(arrays["psum_mean"], ref["psum"][0],
                               rtol=1e-6)


def test_elastic_restore_across_meshes_and_packages(run):
    """Saved from (2, 4): restored onto (4, 2) by the ranks; here onto
    (1, 1) over a one-rank group, unsharded by the port, and by the
    reference's ``Checkpointer.restore``, bit for bit each time."""
    d, _, res, arrays = run
    assert res["restore_4x2_equal"] and res["restore_4x2_sharded"]
    want = {f"{k[len('smollm/'):]}": v for k, v in arrays.items()
            if k.startswith("smollm/")}
    want = {("params/" + k[2:]) if k.startswith("p/") else ("opt/" + k[2:]):
            v for k, v in want.items()}

    def check(flat, numpy_of):
        assert set(flat) == set(want)
        for path, t in flat.items():
            got = numpy_of(t)
            assert got.dtype == want[path].dtype, path
            np.testing.assert_array_equal(got, want[path], err_msg=path)

    plain, _ = Checkpointer(str(d / "ckpt")).restore(1)
    check(plain, lambda t: t.numpy())
    jtree, _ = JCheckpointer(str(d / "ckpt")).restore(1)
    check(dict(jmodule.tree_paths(jtree)), np.asarray)
    cfg = get_config("smollm-360m").reduced(**REDUCED)
    p_abs = steps.abstract_params(cfg)
    o_abs = steps.abstract_opt_state(cfg, p_abs, steps.TrainSettings())
    assert not dist.is_initialized()
    try:
        mesh = port_mesh.make_cpu_mesh(device="cpu")
        tree, _ = Checkpointer(str(d / "ckpt")).restore(1, shardings={
            "params": rules.param_shardings(mesh, p_abs),
            "opt": rules.opt_state_shardings(mesh, o_abs)})
        flat = dict(module.tree_paths(tree))
        assert all(hasattr(t, "placements") for t in flat.values())
        check(flat, lambda t: t.full_tensor().numpy())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
