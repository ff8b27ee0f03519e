"""The port's serving driver (``python -m
repro_torch.launch.serve_spikformer``) on the CPU, the registry's mapping
of plans the JAX package wrote, and the rest of the registry.

The driver runs in the four smoke forms of the reference's CLI (the closed
loop, ``--async``, ``--async --replicas 2``, and ``--trace-out``, whose
span file must give every request its lifecycle under both packages'
loaders); ``--events`` and ``--trace`` serve the event workload on the
reference's default ``packed`` plan, and without a card the driver refuses
to run unless ``--device cpu`` asks for the CPU.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.core.spikformer import SpikformerConfig as JConfig
from repro.core.spikformer import init as jinit
from repro.infer import ExecutionPlan as JPlan
from repro.infer import compile as jcompile
from repro.obs import load_spans_jsonl as jload_spans
from repro_torch.core.spikformer import SpikformerConfig, init
from repro_torch.infer import ExecutionPlan, compile, registry
from repro_torch.infer.backends import FloatBackend, PackedBackend
from repro_torch.launch import serve_spikformer as cli
from repro_torch.obs import load_spans_jsonl

CPU = ["--reduce", "--device", "cpu", "--smoke"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these steps are no faster on more (a reduced
    bucket-8 step takes ~24 ms on one thread or eight), and the suite runs
    beside other test processes, where eight threads a process would
    oversubscribe the cores and stretch the serving loops' latencies."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("extra", [[], ["--async"],
                                   ["--async", "--replicas", "2"]],
                         ids=["closed", "async", "fleet"])
def test_cli_smoke_forms(extra, capsys):
    """Each form passes the reference's smoke assertions (inside ``main``)
    and prints its summary and the smoke line."""
    summary = cli.main(CPU + extra)
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[-1]["smoke"] == "ok"
    assert lines[-2]["stats_version" if not extra else "runtime"]
    assert summary["backend"] == "packed"
    assert summary["weight_dtype"] == "float32"
    if extra:
        assert summary["requests_dropped"] == 0
        assert summary["mode"] == ("fleet_open_loop" if "--replicas" in extra
                                   else "async_open_loop")
        if "--replicas" in extra:
            assert [r["failures"] for r in summary["health"]["replicas"]] \
                == [0, 0]
    else:
        assert summary["requests"] == 5 and summary["images"] == 10


@pytest.mark.parametrize("extra", [[], ["--async", "--replicas", "2"]],
                         ids=["closed", "fleet"])
def test_cli_trace_out_gives_every_request_its_lifecycle(tmp_path, extra):
    path = tmp_path / "serve_trace.jsonl"
    summary = cli.main(CPU + extra + ["--trace-out", str(path)])
    client = summary["client"]
    header, spans = load_spans_jsonl(path)
    jheader, jspans = jload_spans(path)
    assert header == jheader and [tuple(s) for s in spans] == \
        [tuple(s) for s in jspans]
    assert header["dropped_spans"] == 0
    assert header["meta"]["mode"] == ("fleet" if extra else "sync")
    chains = {}
    for s in spans:
        if s.category == "request":
            chains.setdefault(s.rid, []).append(s.name)
    assert sorted(chains) == sorted(r.rid for r in client.done)
    assert all(c == ["admit", "queue", "complete"] for c in chains.values())
    steps = [s for s in spans if s.name == "step"]
    assert sum(s.value for s in steps) == sum(len(r.labels)
                                              for r in client.done)
    doc = json.loads((tmp_path / "serve_trace.perfetto.json").read_text())
    assert doc["otherData"]["dropped_spans"] == 0


@pytest.mark.parametrize("flags", [
    ["--events"], ["--trace", "benchmarks/traces/dvs_synth_mini.jsonl"]])
def test_cli_events_raise_until_ported(flags, capsys):
    """Ported: both event forms run (``--trace`` alone selects the event
    workload, as ``--events`` does) and pass the reference's event smoke
    contract inside ``main`` on the ``packed`` backend's CPU branch."""
    summary = cli.main(CPU + flags)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["smoke"] == "ok" and last["slo_attainment"] == 1.0
    assert summary["backend"] == "packed" and summary["mode"] == \
        "event_replay"
    assert len(summary["runs"]) == 2 and summary["windows"] == 18


def test_cli_needs_the_card_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--reduce", "--smoke"])


# ---------------------------------------------------------------------------
# plans the reference wrote, and the rest of the registry
# ---------------------------------------------------------------------------

def reference_plan(**kw):
    """A resolved plan the JAX package's ``compile`` wrote, for the reduced
    config (its weights only shape the routes)."""
    jcfg = JConfig().scaled()
    return jcompile(jinit(jax.random.PRNGKey(0), jcfg), jcfg,
                    JPlan(**kw)).plan


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_reference_interpret_plan_loads_with_no_rewrite(tmp_path, dtype):
    """``compile(...).plan.to_json()`` of a ``packed_pallas`` interpret
    plan compiles here as written (the plain versions, the reference's CPU
    stand-in for its kernels), replays the reference's routes, and serves
    through ``--plan``."""
    jplan = reference_plan(backend="packed_pallas", weight_dtype=dtype,
                           batch_buckets=(2, 8),
                           backend_options={"interpret": True})
    text = jplan.to_json()
    cfg = SpikformerConfig().scaled()
    model = compile(init(torch.Generator().manual_seed(0), cfg), cfg,
                    ExecutionPlan.from_json(text), device="cpu")
    assert model.plan.backend == "packed_plain"
    assert model.plan.backend_options == {}
    assert model.plan.routes == jplan.routes
    assert model.weight_dtype == dtype
    path = tmp_path / "plan.json"
    path.write_text(text)
    summary = cli.main(CPU + ["--plan", str(path)])
    assert summary["backend"] == "packed_plain"
    assert summary["buckets"] == [2, 8]


def test_port_backend_maps_reference_backend_names():
    assert registry.port_backend("packed_pallas", {"interpret": True}) == \
        ("packed_plain", {})
    assert registry.port_backend("packed_pallas", {}) == ("packed_cuda", {})
    assert registry.port_backend("packed_pallas", {"interpret": False}) == \
        ("packed_cuda", {})
    assert registry.port_backend("packed_cuda", {"fuse_mlp": False}) == \
        ("packed_cuda", {"fuse_mlp": False})
    assert registry.port_backend("reference", {}) == ("reference", {})
    # ``packed``, the reference's default, is the port's own name now
    assert registry.port_backend("packed", {"pallas": False}) == \
        ("packed", {"pallas": False})
    plan = ExecutionPlan.from_json(reference_plan(
        backend="packed", batch_buckets=(2,)).to_json())
    cfg = SpikformerConfig().scaled()
    model = compile(init(torch.Generator().manual_seed(0), cfg), cfg, plan,
                    device="cpu")
    assert model.plan == plan and model.backend.name == "packed"
    assert model.backend.pallas is False        # the CPU branch


def test_reference_pallas_plan_runs_packed_cuda():
    """A ``packed_pallas`` plan without interpret mode is the kernels on
    the accelerator: ``packed_cuda`` here (its plain versions on the
    CPU), with the same logits as the plan rewritten by hand."""
    jplan = reference_plan(backend="packed_pallas", weight_dtype="int8",
                           batch_buckets=(2,),
                           backend_options={"interpret": True})
    plan = dataclasses.replace(ExecutionPlan.from_json(jplan.to_json()),
                               backend_options={})
    cfg = SpikformerConfig().scaled()
    params = init(torch.Generator().manual_seed(0), cfg)
    model = compile(params, cfg, plan, device="cpu")
    by_hand = compile(params, cfg, dataclasses.replace(
        plan, backend="packed_cuda"), device="cpu")
    assert model.plan == by_hand.plan
    imgs = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3),
                                             dtype=np.uint8)
    assert torch.equal(model.logits(imgs), by_hand.logits(imgs))


def test_list_unregister_and_wants_lut_tables():
    assert registry.list_backends() == ["packed", "packed_cuda",
                                        "packed_plain", "reference"]
    assert registry.list_backends(weight_dtype="int8",
                                  device_kind="cpu") == \
        registry.list_backends()
    assert registry.list_backends(device_kind="tpu") == []
    assert registry.wants_lut_tables("packed_cuda", None) is True
    assert registry.wants_lut_tables("float", None) is False
    assert registry.wants_lut_tables(PackedBackend(), PackedBackend()) is \
        True
    registry.register_backend("probe", FloatBackend, aliases=("probe2",),
                              weight_dtypes=("int8",),
                              device_kinds=("cpu",), wants_lut_tables=False)
    try:
        assert "probe" in registry.list_backends(device_kind="cpu")
        assert "probe" not in registry.list_backends(weight_dtype="float32")
        assert "probe" not in registry.list_backends(device_kind="cuda")
        assert registry.wants_lut_tables("probe2", None) is False
    finally:
        registry.unregister_backend("probe2")       # via the alias
    assert "probe" not in registry.list_backends()
    with pytest.raises(ValueError, match="unknown inference backend"):
        registry.backend_spec("probe")
    registry.unregister_backend("never-registered")   # a no-op
