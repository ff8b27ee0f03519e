"""The PyTorch port's core against the JAX reference: spike packing, BN
folding, ``init`` and the weight bridge, plus the port's import hygiene
and its device default. Inputs come from seeded numpy and go through both
packages."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lif as jlif
from repro.core import spike as jspike
from repro.core.spikformer import SpikformerConfig as JConfig
from repro.core.spikformer import fold_inference_params as jfold
from repro.core.spikformer import init as jinit
from repro.infer.quant import quantize_folded as jquantize
from repro_torch.core import lif, spike
from repro_torch.core.spikformer import (SpikformerConfig,
                                         fold_inference_params, init)
from repro_torch.infer import ExecutionPlan, compile as port_compile
from repro_torch.weights import from_reference
from torch_threads import one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def exact(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 4, 9, 17])
def test_pack_unpack_timesteps_match_reference(t):
    r = np.random.default_rng(t)
    s = (r.random((t, 3, 13)) < 0.3).astype(np.float32)     # K=13: ragged
    want = np.asarray(jspike.pack_timesteps(jnp.asarray(s)))
    got = spike.pack_timesteps(torch.from_numpy(s))
    assert got.dtype == torch.uint8
    exact(got, want)
    exact(spike.unpack_timesteps(got, t),
          jspike.unpack_timesteps(jnp.asarray(want), t))
    exact(spike.unpack_timesteps(got, t, time_axis=2),
          jspike.unpack_timesteps(jnp.asarray(want), t, time_axis=2))
    assert spike.num_plane_groups(t) == jspike.num_plane_groups(t)
    assert spike.packed_occupancy(got, t) == jspike.packed_occupancy(want, t)


def test_pack_along_other_time_axis():
    r = np.random.default_rng(5)
    s = (r.random((2, 9, 5)) < 0.5).astype(np.float32)
    exact(spike.pack_timesteps(torch.from_numpy(s), time_axis=1),
          jspike.pack_timesteps(jnp.asarray(s), time_axis=1))


def test_bitplanes_space_to_depth_rate_decode_match_reference():
    r = np.random.default_rng(1)
    img = r.integers(0, 256, (2, 6, 4, 3), dtype=np.uint8)
    exact(spike.bitplanes_u8(torch.from_numpy(img)),
          jspike.bitplanes_u8(jnp.asarray(img)))
    exact(spike.space_to_depth(torch.from_numpy(img)),
          jspike.space_to_depth(jnp.asarray(img)))
    s = (r.random((4, 3, 7)) < 0.4).astype(np.float32)
    exact(spike.rate_decode(torch.from_numpy(s)),
          jspike.rate_decode(jnp.asarray(s)))
    with pytest.raises(ValueError):
        spike.space_to_depth(torch.zeros(1, 3, 4, 1))
    with pytest.raises(ValueError):
        spike.unpack_timesteps(torch.zeros(2, 3, dtype=torch.uint8), 4)


# ---------------------------------------------------------------------------
# BN fold, init, weight bridge
# ---------------------------------------------------------------------------

def test_fold_bn_matches_reference_within_tolerance():
    """rsqrt may differ by an ulp between XLA and torch: tolerance 1e-6
    relative (a few ulp of f32)."""
    r = np.random.default_rng(2)
    k = r.normal(size=(12, 7)).astype(np.float32)
    b = r.normal(size=(7,)).astype(np.float32)
    bn = {"scale": r.normal(size=7), "bias": r.normal(size=7),
          "mean": r.normal(size=7), "var": r.random(7) + 0.1}
    bn = {n: v.astype(np.float32) for n, v in bn.items()}
    for bias in (None, b):
        jk, jb = jlif.fold_bn(jnp.asarray(k), None if bias is None
                              else jnp.asarray(bias),
                              {n: jnp.asarray(v) for n, v in bn.items()})
        tk, tb = lif.fold_bn(torch.from_numpy(k), None if bias is None
                             else torch.from_numpy(bias), from_reference(bn))
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                                   atol=1e-7)
    assert lif.TAU == jlif.TAU and lif.V_TH == jlif.V_TH


def test_fold_inference_params_matches_reference_within_tolerance():
    jcfg, cfg = JConfig().scaled(depth=1), SpikformerConfig().scaled(depth=1)
    params = jinit(jax.random.PRNGKey(3), jcfg)
    # non-trivial BN statistics so the fold does real arithmetic
    r = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.abs(r.normal(size=x.shape)).astype(
            np.float32) * 0.1, params)
    want = jfold(params, jcfg)
    got = fold_inference_params(from_reference(params), cfg)
    w, g = dict(leaves(want)), dict(leaves(got))
    assert w.keys() == g.keys()
    for path in w:
        np.testing.assert_allclose(g[path].numpy(), np.asarray(w[path]),
                                   rtol=1e-5, atol=1e-6, err_msg=path)


def test_init_has_reference_shapes_and_distributions():
    cfg, jcfg = SpikformerConfig().scaled(), JConfig().scaled()
    got = dict(leaves(init(torch.Generator().manual_seed(0), cfg)))
    want = dict(leaves(jinit(jax.random.PRNGKey(0), jcfg)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert tuple(got[path].shape) == tuple(w.shape), path
        assert got[path].dtype == torch.float32, path
    # LeCun normal truncated at 2 sigma, and the conv 1/sqrt(4 cin) scale
    fc1 = got["/blocks/b0/mlp/fc1/kernel"]
    assert float(fc1.abs().max()) <= 2.0 / np.sqrt(cfg.dim) + 1e-6
    assert abs(float(fc1.std()) * np.sqrt(cfg.dim) - 0.88) < 0.05
    conv1 = got["/scs/conv1/kernel"]
    assert abs(float(conv1.std()) * np.sqrt(4 * 8) - 1.0) < 0.1
    # seeded: the same generator state gives the same tree
    again = dict(leaves(init(torch.Generator().manual_seed(0), cfg)))
    assert all(torch.equal(got[p], again[p]) for p in got)


def test_from_reference_keeps_values_and_dtypes():
    cfg = JConfig().scaled(depth=1)
    folded = jfold(jinit(jax.random.PRNGKey(4), cfg), cfg)
    for tree in (folded, jquantize(folded)):
        want = dict(leaves(tree))
        got = dict(leaves(from_reference(
            jax.tree_util.tree_map(np.asarray, tree))))
        assert got.keys() == want.keys()
        for path, w in want.items():
            w = np.asarray(w)
            assert got[path].numpy().dtype == w.dtype, path
            exact(got[path], w)
    assert from_reference({"lut": True}) == {"lut": True}


# ---------------------------------------------------------------------------
# hygiene and device default
# ---------------------------------------------------------------------------

def _port_modules():
    return sorted("repro_torch." + ".".join(p.relative_to(PORT).with_suffix(
        "").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port in a fresh interpreter: neither ``jax`` nor
    any ``repro`` module may end up in ``sys.modules``."""
    mods = _port_modules()
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro'))\n"
              "print(','.join(bad))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


@pytest.mark.parametrize("path", sorted(map(str, [
    *PORT.rglob("*.py"), *(ROOT / "examples").glob("torch_*.py"),
    ROOT / "chip_smoke.py"])), ids=lambda p: Path(p).name)
def test_port_sources_import_no_jax_or_reference(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [] if node.level else [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                f"{path} imports {name}")


def test_compile_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SpikformerConfig().scaled(depth=1)
    params = init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_compile(params, cfg, ExecutionPlan())
    model = port_compile(params, cfg, ExecutionPlan(batch_buckets=(1,)),
                         device="cpu")
    assert model.device.type == "cpu"
    assert model.logits(np.zeros((1, 32, 32, 3), np.uint8)).shape == (1, 10)


def test_library_path_covers_the_shared_headers(monkeypatch, tmp_path):
    """A kernel library's file name carries a digest of its source, every
    shared ``csrc/*.cuh`` header and the flags: an edited header (which
    nvcc would compile into the library) names a new library, so a stale
    build is never loaded; an unchanged tree keeps its name."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    edited = _build.library_path("k")
    assert edited != first and edited.name.startswith("k-")
    (tmp_path / "g.cuh").write_text("// a second header\n")
    assert _build.library_path("k") not in (first, edited)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, edited)
    # the real tree: every source's name covers tf32x3.cuh
    monkeypatch.undo()
    assert (_build.CSRC / "tf32x3.cuh").exists()
    for name in _build.SOURCES:
        assert _build.library_path(name).parent == _build.BUILD_DIR
