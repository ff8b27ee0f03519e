"""The dry-run grid of the port's ``configs.base`` against the reference's:
``SHAPES``, ``ARCH_IDS``, ``cell_applicable``, the analytic parameter
counts of all ten configs, and every ``input_specs`` shape and dtype of
the 40 (arch x shape) cells (the decode cache leaf by leaf against the
reference's ``jax.eval_shape`` of ``init_cache``); and
``configs/spikformer_v2.py``'s four configs field by field. All exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import spikformer_v2 as jsv2
from repro.nn import module as jmodule
from repro_torch.configs import base
from repro_torch.configs import spikformer_v2 as sv2
from repro_torch.nn import module
from torch_threads import one_thread  # noqa: F401  (autouse)

CELLS = [(a, s) for a in jbase.ARCH_IDS for s in jbase.SHAPES]


def test_shapes_and_arch_ids_equal_the_reference():
    assert base.ARCH_IDS == jbase.ARCH_IDS
    assert list(base.SHAPES) == list(jbase.SHAPES)
    for name, shape in jbase.SHAPES.items():
        assert dataclasses.asdict(base.SHAPES[name]) == \
            dataclasses.asdict(shape)


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_config_counts_and_flags_equal_the_reference(arch):
    """``n_params``, ``n_active_params``, ``subquadratic`` and every field,
    at full size and at ``reduced()``."""
    for jcfg, cfg in ((jbase.get_config(arch), base.get_config(arch)),
                      (jbase.get_config(arch).reduced(),
                       base.get_config(arch).reduced())):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.n_params() == jcfg.n_params()
        assert cfg.n_active_params() == jcfg.n_active_params()
        assert cfg.subquadratic == jcfg.subquadratic


def test_forty_cells_and_eight_skips():
    """``cell_applicable`` over the grid equals the reference's: long_500k
    runs only for the two subquadratic configs."""
    got = {(a, s): base.cell_applicable(base.get_config(a), base.SHAPES[s])
           for a, s in CELLS}
    want = {(a, s): jbase.cell_applicable(jbase.get_config(a),
                                          jbase.SHAPES[s]) for a, s in CELLS}
    assert got == want and len(got) == 40
    skipped = sorted(a for (a, s), (ok, _) in got.items() if not ok)
    assert len(skipped) == 8 and {s for (_, s), (ok, _) in got.items()
                                  if not ok} == {"long_500k"}


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _leaves(tree, paths):
    return {p: (tuple(x.shape), _dtype(x)) for p, x in paths(tree)}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    """Every batch input's shape and dtype; for decode, every cache leaf
    by path (stacked or per-layer), and ``cache_pos`` a 0-d int32. The
    port's are meta tensors: nothing is allocated."""
    jcfg, cfg = jbase.get_config(arch), base.get_config(arch)
    want = jbase.input_specs(jcfg, jbase.SHAPES[shape])
    got = base.input_specs(cfg, base.SHAPES[shape])
    assert set(got) == set(want)
    assert _leaves(got["batch"], module.tree_paths) == \
        _leaves(want["batch"], jmodule.tree_paths)
    if "cache" in want:
        assert _leaves(got["cache"], module.tree_paths) == \
            _leaves(want["cache"], jmodule.tree_paths)
        assert got["batch"]["cache_pos"].shape == ()
    assert all(t.device.type == "meta"
               for _, t in module.tree_paths(got))


@pytest.mark.parametrize("name", ["CONFIG", "REDUCED", "CONFIG_T16",
                                  "REDUCED_T16"])
def test_spikformer_v2_configs_equal_the_reference(name):
    assert dataclasses.asdict(getattr(sv2, name)) == \
        dataclasses.asdict(getattr(jsv2, name))


def test_spikformer_v2_names_no_arch_config():
    """The module holds the vision configs and registers no ArchConfig,
    in both packages: ``get_config`` raises ``KeyError``."""
    with pytest.raises(KeyError):
        jbase.get_config("spikformer-v2")
    with pytest.raises(KeyError, match="names no ArchConfig"):
        base.get_config("spikformer-v2")
    with pytest.raises(KeyError, match="not ported"):
        base.get_config("no-such-arch-1b")


def test_input_specs_allocate_nothing_at_full_size():
    """The largest decode cache of the grid (qwen1.5-110b at 128 x 32768,
    ~11 TB in bf16) is shapes only."""
    got = base.input_specs(base.get_config("qwen1.5-110b"),
                           base.SHAPES["decode_32k"])
    total = sum(t.numel() * t.element_size()
                for _, t in module.tree_paths(got["cache"]))
    assert total > 1e12
    assert all(t.device == torch.device("meta")
               for _, t in module.tree_paths(got["cache"]))
    assert np.isclose(total, sum(np.prod(x.shape) * x.dtype.itemsize
                                 for _, x in jmodule.tree_paths(
                                     jbase.input_specs(
                                         jbase.get_config("qwen1.5-110b"),
                                         jbase.SHAPES["decode_32k"])["cache"])))
