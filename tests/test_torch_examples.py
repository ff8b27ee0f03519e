"""The port's examples (``examples/torch_*.py``) and its trace report
(``python -m repro_torch.launch.trace_report``) on the CPU, against the
reference's examples and script.

Each example's ``main`` runs at its smallest arguments with ``--device
cpu``. Where an example trains, the port's run starts from the reference's
seeded ``init`` (patched in through ``repro_torch.weights``), so its losses
can be held to the reference example's own printed losses (rtol 1e-4: the
JSON rounds to 4 decimals) and its deterministic fields (chance, image
counts, ``packed_matches_reference_exactly``) must be equal. The
quickstart's and the serving examples' deterministic fields (shapes,
stream and encoding counts, the trace's length, token counts) are held to
what the reference's functions give on the same inputs. The trace report
prints the reference script's report line for line.
"""
import contextlib
import importlib.util
import io
import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spikformer import SpikformerConfig as JConfig
from repro.core.spikformer import init as jinit
from repro_torch.weights import from_reference

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as the serving tests pin: the suite runs beside
    other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_example(name: str):
    spec = importlib.util.spec_from_file_location(f"_ex_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference(name: str, argv: list) -> list:
    """Run ``examples/<name>.py`` of the reference as ``__main__`` with
    ``argv``; returns its printed JSON lines."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = [str(EXAMPLES / f"{name}.py"), *argv]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = old
    return [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]


def reference_init(mod):
    """Patch the port example's ``init`` to give the reference's seeded
    params for the config it asks for (``jax.random.PRNGKey(0)``, as the
    reference examples draw)."""
    def init(_gen, cfg):
        jcfg = JConfig().scaled(img_size=cfg.img_size, dim=cfg.dim,
                                depth=cfg.depth, heads=cfg.heads,
                                classes=cfg.num_classes)
        return from_reference(jax.tree_util.tree_map(
            np.asarray, jinit(jax.random.PRNGKey(0), jcfg)))
    mod.init = init


# ---------------------------------------------------------------------------
# the quickstart
# ---------------------------------------------------------------------------

def test_quickstart_shapes_equal_the_reference(capsys):
    from repro.core.spike import pack_bits
    from repro.kernels import ops as jops
    got = load_example("torch_quickstart").main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "quickstart OK" and len(lines) == 7
    r = np.random.default_rng(0)
    x = jnp.asarray(r.integers(0, 256, (64, 96), dtype=np.uint8))
    w = jnp.asarray(r.normal(0, 1, (96, 32)).astype(np.float32))
    q = jnp.asarray((r.random((8, 256, 64)) < 0.25).astype(np.float32))
    want = {
        "packed": pack_bits(jnp.zeros((4, 128))).shape,
        "per_plane": jops.spike_matmul(x, w, mode="per_plane",
                                       pallas=False).shape,
        "shift_sum": jops.spike_matmul(x, w, mode="shift_sum",
                                       pallas=False).shape,
        "tflif": jops.tflif_fused(jnp.zeros((12, 2048)), jnp.zeros(2048),
                                  pallas=False).shape,
        "stdp": jops.stdp_attention(q, q, q, scale=0.125,
                                    pallas=False).shape,
        "logits": (2, 10), "logits_t16": (2, 10), "routes": 16}
    assert {k: got[k] for k in want} == {k: tuple(v) if isinstance(
        v, tuple) else v for k, v in want.items()}
    assert got["device"] == "cpu"


# ---------------------------------------------------------------------------
# training, then classification through the packed engine
# ---------------------------------------------------------------------------

def test_train_example_from_the_reference_params():
    """Two steps at batch 2 from the reference's params: each printed loss
    equal to the reference example's, the eval fields alike."""
    argv = ["--steps", "2", "--batch", "2"]
    want = run_reference("train_spikformer", argv)
    mod = load_example("torch_train_spikformer")
    reference_init(mod)
    got = mod.main(argv + ["--device", "cpu"])
    steps = [w for w in want if "step" in w]
    assert [s["step"] for s in steps] == [0, 1]
    np.testing.assert_allclose(got["losses"], [s["loss"] for s in steps],
                               rtol=1e-4, atol=1e-4)
    assert got["chance"] == want[-1]["chance"]
    assert got["eval_acc"] == want[-1]["eval_acc"]


def test_classify_example_from_the_reference_params():
    argv = ["--train-steps", "2", "--batch", "4", "--eval-images", "6",
            "--batch-size", "4"]
    want = run_reference("classify_spikformer", argv)
    mod = load_example("torch_classify_spikformer")
    reference_init(mod)
    got = mod.main(argv + ["--device", "cpu"])
    np.testing.assert_allclose(got["losses"][0], want[0]["loss"], rtol=1e-4,
                               atol=1e-4)
    for key in ("eval_images", "chance", "paper_target_fps",
                "packed_matches_reference_exactly", "accuracy",
                "pad_waste"):
        assert got[key] == want[-1][key], key
    assert got["packed_matches_reference_exactly"] is True


def test_classify_example_defaults_learn():
    """The example at its defaults, as ``chip_smoke.py`` runs it on the
    card: loss falls, accuracy above chance, packed equal to reference bit
    for bit."""
    got = load_example("torch_classify_spikformer").main(["--device", "cpu"])
    assert got["losses"][-1] < got["losses"][0]
    assert got["accuracy"] > got["chance"]
    assert got["packed_matches_reference_exactly"] is True


# ---------------------------------------------------------------------------
# serving examples
# ---------------------------------------------------------------------------

def test_serve_under_load_example():
    from repro.serve import poisson_trace as jtrace
    rows = load_example("torch_serve_under_load").main(
        ["--rates", "40,80", "--duration", "0.5", "--device", "cpu"])["rows"]
    assert [r["offered_rps"] for r in rows] == [40.0, 80.0]
    for r, rps in zip(rows, (40.0, 80.0)):
        assert r["requests"] == len(jtrace(rps=rps, duration_s=0.5, seed=1,
                                           images_per_request=(1, 3)))
        assert r["rejected"] == r["dropped"] == 0
        assert r["sustains_paper_rate"]


def test_serve_events_example():
    from repro.events import (encode_events_to_plane_groups,
                              flicker_burst_events, merge_streams,
                              moving_edge_events, window_occupancy)
    got = load_example("torch_serve_events").main(
        ["--duration-ms", "100", "--device", "cpu"])
    stream = merge_streams(
        moving_edge_events(height=16, width=16, duration_us=100_000,
                           seed=0),
        flicker_burst_events(height=16, width=16, duration_us=100_000,
                             seed=1, bursts=3))
    planes = encode_events_to_plane_groups(stream.slice_time(0, 20_000), t=8,
                                           window_us=2_500)
    assert got["stream"]["events"] == len(stream)
    assert got["encoding"] == {
        "plane_groups": int(planes.shape[0]),
        "encoded_shape": list(planes.shape),
        "chunk_occupancy": round(window_occupancy(planes, t=8), 4)}
    assert got["session"]["events_seen"] == len(stream)
    assert got["session"]["windows_shed"] == 0
    assert got["replay"]["windows"] == got["session"]["windows_labeled"] == 5
    assert got["replay"]["labels_match_live_run"] is True


def test_serve_lm_example():
    """The reference example's arguments (12 requests, 24 new tokens each,
    a 4-slot pool) on the port; its greedy tokens equal the JAX engine's
    (``test_torch_lm.py``)."""
    got = load_example("torch_serve_lm").main(["--device", "cpu"])
    assert got["requests"] == 12
    assert got["new_tokens"] == 12 * 24
    assert all(len(r.out) == 24 for r in got["engine"].done)


# ---------------------------------------------------------------------------
# the trace report
# ---------------------------------------------------------------------------

def test_trace_report_equals_the_reference_script(tmp_path):
    from repro_torch.launch import serve_spikformer as cli
    from repro_torch.launch import trace_report
    path = tmp_path / "serve_trace.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["--reduce", "--device", "cpu", "--smoke", "--requests",
                  "3", "--trace-out", str(path)])
    spec = importlib.util.spec_from_file_location(
        "_ref_trace_report", ROOT / "scripts" / "trace_report.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    outs = []
    for mod in (ref, trace_report):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main([str(path), "--top", "3", "--assert-complete"])
        outs.append((rc, buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[1][0] == 0 and "OK: all 3 admitted requests" in outs[1][1]
