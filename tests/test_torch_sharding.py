"""The port's sharding layer (``repro_torch.sharding``, ``launch/mesh.py``)
against the reference's, in one process on the CPU.

The rule tables (``spec_for``, ``param_shardings``, ``opt_state_shardings``,
``batch_shardings``, ``cache_shardings``) must give the reference's
PartitionSpecs, equal as tuples, path by path, for every leaf of every
ported config plus qwen1.5-110b and arctic-480b at full size, on the
abstract meshes (4, 2), (1, 1), (16, 16) and (2, 16, 16). The reference's
trees come from ``jax.eval_shape``, the port's from meta tensors
(``steps.abstract_params``), so nothing is allocated at full size.

``shard_hint``'s spec is held to the one the reference's ``shard_hint``
hands ``with_sharding_constraint`` (patched to record it, under a stand-in
mesh: the reference's sharded path raises on this JAX's ``Explicit`` axes,
ROADMAP §3, so only its rule logic is compared). The multi-rank numerics
are in ``test_torch_sharded_steps.py``.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs.base import get_config as jget_config
from repro.launch import steps as jsteps
from repro.nn import module as jmodule
from repro.nn import transformer as JT
from repro.sharding import hints as jhints
from repro.sharding import rules as jrules
from repro_torch.configs import get_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import steps
from repro_torch.nn import module
from repro_torch.nn import transformer as T
from repro_torch.sharding import compat, hints, rules
from torch_threads import one_thread  # noqa: F401  (autouse)

ARCHS = ("smollm-360m", "stablelm-12b", "glm4-9b", "hymba-1.5b",
         "mamba2-130m", "qwen3-moe-30b-a3b", "arctic-480b",
         "whisper-large-v3", "qwen2-vl-7b", "qwen1.5-110b")
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# batch sizes that divide every mesh's dp group, and one that divides none
# past 2 (the replicate fallback)
BATCHES = (32, 6)
SEQ, CACHE_LEN = 256, 512


def meshes(name):
    sizes, names = MESHES[name]
    return jrules.abstract_mesh(sizes, names), compat.abstract_mesh(sizes,
                                                                   names)


def specs(tree, path_fn):
    """{path: spec as a tuple} of a tree of shardings."""
    return {p: tuple(s.spec) for p, s in path_fn(tree)}


def jspecs(tree):
    return specs(tree, jmodule.tree_paths)


def pspecs(tree):
    return specs(tree, module.tree_paths)


@functools.lru_cache(maxsize=None)
def jshapes(arch):
    cfg = jget_config(arch)
    p = jsteps.abstract_params(cfg)
    o = jsteps.abstract_opt_state(cfg, p, jsteps.TrainSettings())
    caches = {b: jax.eval_shape(lambda b=b: JT.init_cache(cfg, b, CACHE_LEN))
              for b in BATCHES}
    return p, o, caches


@functools.lru_cache(maxsize=None)
def pshapes(arch):
    cfg = get_config(arch)
    p = steps.abstract_params(cfg)
    o = steps.abstract_opt_state(cfg, p, steps.TrainSettings())
    caches = {b: T.init_cache(cfg, b, CACHE_LEN, device="meta")
              for b in BATCHES}
    return p, o, caches


def batch_shapes(arch, b):
    """The train batch of an arch (the reference train CLI's shapes), as
    the reference's ShapeDtypeStructs and the port's meta tensors."""
    cfg = get_config(arch)
    shapes = {"tokens": ((b, SEQ), "int32"), "labels": ((b, SEQ), "int32")}
    if cfg.family == "vlm":
        shapes["image_embeds"] = ((b, cfg.img_tokens, cfg.d_model),
                                  "bfloat16")
        shapes["mrope_positions"] = ((3, b, SEQ), "int32")
    if cfg.family == "encdec":
        shapes["frames"] = ((b, cfg.n_frames, cfg.d_model), "bfloat16")
    j = {k: jax.ShapeDtypeStruct(s, jnp.dtype(d)) for k, (s, d) in
         shapes.items()}
    p = {k: torch.empty(s, dtype=getattr(torch, d), device="meta")
         for k, (s, d) in shapes.items()}
    return j, p


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rule_tables_equal_the_reference(arch, mesh):
    """Every leaf's spec, path by path, in all four tables."""
    jm, pm = meshes(mesh)
    jp, jo, jc = jshapes(arch)
    pp, po, pc = pshapes(arch)
    got = pspecs(rules.param_shardings(pm, pp))
    want = jspecs(jrules.param_shardings(jm, jp))
    assert got == want
    assert pspecs(rules.opt_state_shardings(pm, po)) == \
        jspecs(jrules.opt_state_shardings(jm, jo))
    for b in BATCHES:
        jb, pb = batch_shapes(arch, b)
        assert pspecs(rules.batch_shardings(pm, pb)) == \
            jspecs(jrules.batch_shardings(jm, jb)), b
        assert pspecs(rules.cache_shardings(pm, pc[b])) == \
            jspecs(jrules.cache_shardings(jm, jc[b])), b
    # spec_for itself on every param leaf, with the leaf's shape
    for path, leaf in module.tree_paths(pp):
        assert tuple(rules.spec_for(path, tuple(leaf.shape), pm)) == \
            tuple(jrules.spec_for(path, tuple(leaf.shape), jm)), path
    # the large 2-D weights do shard where a mesh has more than one rank
    if mesh != "1x1":
        assert any(any(s) for s in got.values())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_fallbacks_and_dp_group(mesh):
    """The reference's rule-level cases: divisibility fallback, stacked
    leading dims padded, expert parallelism, the dp group; ``dp_axes``."""
    jm, pm = meshes(mesh)
    cases = [("x/wq/kernel", (12, 7)), ("x/wq/kernel", (64, 32)),
             ("layers/attn/wq/kernel", (8, 64, 32)),
             ("layers/moe/w_gate", (2, 32, 16, 32)),
             ("layers/moe/w_down", (2, 32, 32, 16)),
             ("a/mlp/up/kernel", (64, 32)), ("embed/embedding", (512, 64)),
             ("layers/ssm/in_proj", (3, 64, 100)), ("final_norm/scale", (64,)),
             ("layers/moe/router", (4, 64, 8))]
    for path, shape in cases:
        got = rules.spec_for(path, shape, pm)
        assert isinstance(got, tuple)
        assert tuple(got) == tuple(jrules.spec_for(path, shape, jm)), path
    assert rules.dp_axes(pm) == jrules.dp_axes(jm)


def test_placements_of_a_spec():
    """A spec's DTensor placements: each mesh dim shards the tensor dim
    that names it; an axis group shards its dim on each of its mesh dims;
    a mesh dim of size 1 replicates."""
    am = compat.abstract_mesh((4, 2), ("data", "model"))
    assert rules.placements(am, rules.P("data", "model")) == (Shard(0),
                                                              Shard(1))
    assert rules.placements(am, rules.P(None, "model", None)) == \
        (Replicate(), Shard(1))
    assert rules.placements(am, rules.P()) == (Replicate(), Replicate())
    pod = compat.abstract_mesh((2, 4, 2), ("pod", "data", "model"))
    assert rules.placements(pod, rules.P(("pod", "data"), "model")) == \
        (Shard(0), Shard(0), Shard(1))
    one = compat.abstract_mesh((1, 1), ("data", "model"))
    assert rules.placements(one, rules.P("data", "model")) == \
        (Replicate(), Replicate())
    ns = rules.NamedSharding(am, rules.P("model", ("data",)))
    assert ns.placements == (Shard(1), Shard(0))


# ---------------------------------------------------------------------------
# shard_hint
# ---------------------------------------------------------------------------

class _JMesh:
    """The reference's ambient mesh surface, for its hint logic alone."""

    def __init__(self, sizes, names):
        self.empty = False
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


HINT_CASES = [((8, 32, 64), ("dp", "model", None)),
              ((8, 32, 64), ("dp", None, "model")),
              ((6, 32, 64), ("dp", None, "model")),
              ((8, 4, 32, 16), ("dp", "model", None, None)),
              ((8, 3, 32, 16), ("dp", "model", None, None)),
              ((8, 4, 1, 16), ("dp", None, "model", None)),
              ((8, 1, 64), ("dp", "model", None)),
              ((4, 8, 5, 64), (None, "dp", None, "model")),
              ((8, 4, 32, 16), ("dp", None, None, None)),
              ((16, 32), ("nope", "model"))]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_hint_spec_equals_the_reference(mesh, monkeypatch):
    sizes, names = MESHES[mesh]
    seen = []
    monkeypatch.setattr(jhints, "get_abstract_mesh",
                        lambda: _JMesh(sizes, names))
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    am = compat.abstract_mesh(sizes, names)
    for shape, dims in HINT_CASES:
        jhints.shard_hint(jnp.zeros(shape), *dims)
        assert hints.hint_spec(shape, dims, am) == seen[-1], (shape, dims)


def test_shard_hint_returns_its_input_without_a_mesh_or_a_dtensor():
    x = torch.ones(4, 4)
    assert hints.shard_hint(x, "dp", "model") is x
    assert compat.get_abstract_mesh().empty
    with compat.set_mesh(compat.abstract_mesh((4, 2), ("data", "model"))):
        assert not compat.get_abstract_mesh().empty
        assert compat.get_abstract_mesh().shape == {"data": 4, "model": 2}
        assert hints.shard_hint(x, "dp", "model") is x
    assert compat.get_abstract_mesh().empty
    assert compat.get_abstract_mesh().axis_names == ()


# ---------------------------------------------------------------------------
# the public surface, the meshes
# ---------------------------------------------------------------------------

def test_public_import_surface_matches_the_reference():
    import repro.sharding as jsharding
    import repro_torch.sharding as sharding
    assert sharding.__all__ == jsharding.__all__
    for name in sharding.__all__:
        assert getattr(sharding, name) is not None, name
    assert sharding.replica_devices is rules.replica_devices
    assert sharding.spec_for is rules.spec_for
    assert sharding.shard_hint is hints.shard_hint
    assert sharding.set_mesh is compat.set_mesh


def test_production_mesh_is_the_reference_layout():
    for multi in (False, True):
        m = port_mesh.make_production_mesh(multi_pod=multi)
        assert m.device_mesh is None
        want = ({"pod": 2, "data": 16, "model": 16} if multi
                else {"data": 16, "model": 16})
        assert m.shape == want


def test_make_cpu_mesh_on_a_one_rank_group():
    """With no process group, ``make_cpu_mesh`` makes a one-rank group (no
    TCP port); a DTensor placed on the mesh and hinted there keeps its
    value; the group is destroyed afterwards."""
    assert not dist.is_initialized()
    try:
        mesh = port_mesh.make_cpu_mesh(device="cpu")
        assert dist.get_world_size() == 1
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="needs 2 ranks"):
            port_mesh.make_cpu_mesh(2, 1, device="cpu")
        x = torch.arange(24.0).reshape(4, 6)
        d = rules.place(x, rules.NamedSharding(mesh, rules.P("data",
                                                             "model")))
        assert isinstance(d, DTensor)
        assert d.to_local().data_ptr() == x.data_ptr()   # nothing copied
        with compat.set_mesh(mesh):
            assert compat.get_abstract_mesh().device_mesh is mesh
            h = hints.shard_hint(d, "dp", "model")
        assert isinstance(h, DTensor)
        assert tuple(h.placements) == (Replicate(), Replicate())
        assert torch.equal(h.full_tensor(), x)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not dist.is_initialized()
