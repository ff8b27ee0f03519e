"""The port's ``MicroBatchEngine`` accounting, held to the reference's.

The reference's engine answers ``batches``, ``images_done``,
``padded_rows``, ``total_rows``, ``busy_s``, ``wall_s`` and ``pad_waste``
(``repro.infer.engine.MicroBatchEngine``), and its own test reads them off
the engine (``tests/test_compile.py::test_engine_pad_waste_accounting``).
Here that case runs through both packages: the reduced config, seed 0, 3
one-image requests, buckets (8,) against (2, 8), on the reference's
default ``packed`` backend (its CPU branch) and, in the port, on
``packed_cuda`` too (its kernels' plain versions on the CPU), the port fed
the reference's parameters. Each port engine is built on first use, so a
backend that compiles reaches the accounting properties however another
fares. The registry's ``BackendSpec.make`` is pinned with it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spikformer import SpikformerConfig as JConfig
from repro.core.spikformer import init as jinit
from repro.infer import ExecutionPlan as JPlan
from repro.infer import MicroBatchEngine as JEngine
from repro.infer import compile as jcompile
from repro_torch.core.spikformer import SpikformerConfig
from repro_torch.infer import ExecutionPlan, MicroBatchEngine, compile
from repro_torch.infer import registry
from repro_torch.infer.backends import FloatBackend, PackedBackend
from repro_torch.weights import from_reference
from torch_threads import one_thread  # noqa: F401  (autouse)

PROPS = ("batches", "images_done", "padded_rows", "total_rows", "pad_waste")


@pytest.fixture(scope="module")
def small():
    jcfg = JConfig().scaled()
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    img = np.asarray(jax.random.randint(jax.random.PRNGKey(1),
                                        (5, 32, 32, 3), 0, 256, jnp.uint8))
    params = from_reference(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, SpikformerConfig().scaled(), params, img


BACKENDS = ("packed", "packed_cuda")


def drain(eng, img):
    for i in range(3):                         # one image per request
        eng.submit(img[i:i + 1])
    eng.run()
    return eng


@pytest.fixture(scope="module")
def reference_engines(small):
    """``{buckets: reference engine}``, each drained of the 3 one-image
    requests."""
    jcfg, jparams, _, _, img = small
    return {buckets: drain(JEngine(jcompile(jparams, jcfg, JPlan(
        batch_buckets=buckets))), img) for buckets in ((8,), (2, 8))}


@pytest.fixture(scope="module")
def port_engine(small):
    """``(backend, buckets) -> port engine`` drained of the same requests,
    built on first use."""
    _, _, cfg, params, img = small
    built = {}

    def get(backend, buckets):
        if (backend, buckets) not in built:
            built[backend, buckets] = drain(MicroBatchEngine(compile(
                params, cfg, ExecutionPlan(backend=backend,
                                           batch_buckets=buckets),
                device="cpu")), img)
        return built[backend, buckets]
    return get


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("buckets,total,padded,waste",
                         [((8,), 8, 5, 0.625), ((2, 8), 4, 1, 0.25)],
                         ids=["single", "multi"])
def test_engine_accounting_matches_reference(reference_engines, port_engine,
                                             backend, buckets, total, padded,
                                             waste):
    jeng, eng = reference_engines[buckets], port_engine(backend, buckets)
    assert (eng.total_rows, eng.padded_rows, eng.pad_waste) == (
        total, padded, waste)
    for name in PROPS:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.images_done == 3 and eng.batches == len(eng.model.plan_chunks(
        3))
    # read-only views of the one counter, not copies
    for name, field in (("busy_s", "busy_s"), ("wall_s", "wall_s")):
        assert getattr(eng, name) == getattr(eng.acct, field) > 0
    with pytest.raises(AttributeError):
        eng.total_rows = 0
    s = eng.stats()
    assert s["pad_waste"] == waste and s["padded_rows"] == padded
    assert [lab for r in eng.done for lab in r.labels] == \
        [lab for r in jeng.done for lab in r.labels]


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_pad_waste_falls_with_more_buckets(port_engine, backend):
    """The reference test's ordering, on the port's engines."""
    assert port_engine(backend, (2, 8)).pad_waste < \
        port_engine(backend, (8,)).pad_waste


def test_backend_spec_make_has_the_reference_contract():
    """``make(**options)`` builds an instance; an unknown option raises
    ``TypeError``; a ``takes_device`` factory (``packed``) gets the device
    and resolves its branch by it."""
    cpu = torch.device("cpu")
    spec = registry.backend_spec("packed_cuda")
    be = spec.make(fuse_mlp=False)
    assert isinstance(be, PackedBackend) and not be.fuse_mlp and be.pallas
    with pytest.raises(TypeError):
        spec.make(fuse=False)
    assert isinstance(registry.backend_spec("float").make(), FloatBackend)
    packed = registry.backend_spec("packed")
    assert packed.takes_device and not spec.takes_device
    assert packed.make(device=cpu).pallas is False          # CPU branch
    assert packed.make(device=cpu, pallas=True).pallas is True
    assert packed.make(device="cuda").pallas is True        # the kernels
    assert packed.make(device="cuda", pallas=False).pallas is False
    assert packed.make(device=cpu, interpret=True).name == "packed"
