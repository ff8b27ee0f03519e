"""Continuous batching over a mesh: per-row writes into a sharded cache
and ``Engine(mesh=...)`` on a (2, 4) ``("data", "model")`` mesh of 8 CPU
ranks over gloo, against the plain writes, the port's unsharded engine and
the reference's engine; and rank 0's collectives in a real 8-rank run of
the sharded steps against the dry run's on a fake (2, 4) world.

The ranks run in a subprocess (``tests/sharded_engine_worker.py``) that
rendezvouses through a ``FileStore`` under ``tmp_path``, so xdist workers
never race for a port. The reference engines run here, with no mesh set
(under the installed JAX its sharded engine raises: one of the seed's
failures).

The engines: reduced smollm (2 layers, linear caches) and reduced hymba
(3 layers, 32-slot rings beside a global layer), f32 compute and cache,
more requests than slots, prompts of different lengths and different
numbers of new tokens, so that slots finish at different steps and new
requests are spliced in mid-run at other positions; hymba's decode runs
past its rings' length. Tokens are held exact; the writes bit for bit.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_config as jget_config
from repro.launch.serve import Engine as JEngine, Request as JRequest
from repro.nn import module as jmodule
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from torch_threads import one_thread  # noqa: F401  (autouse)

HERE = pathlib.Path(__file__).resolve().parent
TIMEOUT_S = 300
REQUESTS = {
    "smollm": {"arch": "smollm-360m", "reduced": {}, "slots": 4,
               "cache_len": 32,
               "lengths": [5, 9, 13, 3, 11, 7],
               "max_new": [6, 4, 8, 5, 7, 6]},
    "hymba": {"arch": "hymba-1.5b", "reduced": {"n_layers": 3}, "slots": 4,
              "cache_len": 64,
              "lengths": [5, 30, 20, 12, 26, 9],
              "max_new": [9, 6, 10, 8, 7, 12]},
}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference engines here, then the 8 ranks on their params."""
    d = tmp_path_factory.mktemp("sharded_engine")
    arrays, requests, want = {}, {}, {}
    rng = np.random.default_rng(7)
    for name, spec in REQUESTS.items():
        jcfg = jget_config(spec["arch"]).reduced(**spec["reduced"])
        prompts = [rng.integers(0, jcfg.vocab, n).tolist()
                   for n in spec["lengths"]]
        je = JEngine(jcfg, slots=spec["slots"], cache_len=spec["cache_len"],
                     seed=0, compute_dtype=jnp.float32,
                     cache_dtype=jnp.float32)
        for i, (p, n) in enumerate(zip(prompts, spec["max_new"])):
            je.submit(JRequest(rid=i, prompt=p, max_new=n))
        want[name] = [r.out for r in sorted(je.run(), key=lambda r: r.rid)]
        for path, leaf in jmodule.tree_paths(je.params):
            arrays[f"params_{name}/{path}"] = np.asarray(leaf)
        requests[name] = dict(spec, prompts=prompts)
    np.savez(d / "inputs.npz", **arrays)
    (d / "inputs.json").write_text(json.dumps({"requests": requests}))
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(HERE / "sharded_engine_worker.py"),
                          str(d)], capture_output=True, text=True,
                         timeout=TIMEOUT_S, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return want, json.loads((d / "out.json").read_text())


@pytest.mark.parametrize("case", [
    "linear_one", "linear_one_dtensor_pos", "linear_many",
    "linear_many_dtensor_pos", "past_end_one", "past_end_one_dtensor_pos",
    "past_end_many", "past_end_many_dtensor_pos", "ring_one",
    "ring_one_dtensor_pos", "ring_many", "ring_many_dtensor_pos", "aligned",
    "ring_aligned"])
def test_sharded_write_equals_the_plain_write(run, case):
    """``cache_update`` of a cache sequence-sharded over the model axis and
    batch-sharded over dp, with a (B,) ``pos`` (a plain tensor or a
    DTensor over dp) or an int: every leaf equals the plain write's, bit
    for bit; one token a row and several; a linear cache's writes past its
    end dropped; a 16-slot ring wrapped."""
    _, res = run
    got = res["writes"][case]
    assert got["sharded"], got
    assert got["equal"], case


@pytest.mark.parametrize("name", list(REQUESTS))
def test_sharded_engine_tokens_equal_unsharded_and_reference(run, name):
    want, res = run
    got = res["engines"][name]
    assert got["sharded"] == got["unsharded"]
    assert got["sharded"] == want[name]
    assert [len(o) for o in got["sharded"]] == REQUESTS[name]["max_new"]


@pytest.mark.parametrize("name", list(REQUESTS))
def test_sharded_engine_pool_holds_a_shard_a_rank(run, name):
    """The pool's first KV leaf: slots over dp (2), slots of the sequence
    over the model axis (4), on each rank."""
    _, res = run
    got = res["engines"][name]
    full, local = got["pool_k_shape"], got["pool_k_local_shape"]
    slots = REQUESTS[name]["slots"]
    assert full[-4] == slots and local[-4] == slots // 2
    assert local[-2] * 4 == full[-2]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dry_run_collectives_equal_a_real_gloo_run(run, kind):
    """Reduced smollm's step (B 8, S 32, microbatches of 4) dry-run on a
    fake (2, 4) world of CPU meta tensors: rank 0's collective bytes and
    counts by kind, bytes by mesh axis and FLOPs equal those rank 0 moves
    in the real 8-rank gloo run of the same step, its redistributions run
    as all-to-alls as on the card's NCCL mesh."""
    _, res = run
    real = res["traced"][kind]
    cfg = get_config("smollm-360m").reduced()
    rec, _ = dryrun.dry_run(cfg, ShapeSpec(kind, kind, 32, 8), (2, 4),
                            ("data", "model"), microbatch=4,
                            device_type="cpu")
    assert rec["collectives"]["bytes"] == real["bytes"]
    assert rec["collectives"]["counts"] == real["counts"]
    assert rec["collectives"]["bytes_by_axis"] == real["axis_bytes"]
    assert rec["cost"]["flops_per_chip"] == real["flops"]
    assert sum(real["bytes"].values()) > 0


def test_all_to_all_as_on_the_card_gives_dtensor_s_own_result(run):
    """The real 8-rank prefill of reduced smollm, its shard-to-shard
    redistributions run as gloo all-to-alls (as the card's NCCL mesh runs
    them, and as the dry run counts them), equals the same prefill through
    DTensor's CPU branch (an all-gather and a chunk) exactly; and it holds
    at least one all-to-all."""
    _, res = run
    assert res["traced"]["prefill_all_to_all_equal"] is True
    assert res["traced"]["prefill"]["counts"]["all-to-all"] > 0
