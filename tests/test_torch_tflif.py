"""Kernel 1, TFLIF, against the JAX reference on the CPU: the port's
``ops.tflif_pack`` on accumulators expanded over T (SSSC conv0's stride-0
view, which the kernel now reads in place) against the Pallas
``tflif_fused`` in interpret mode on the materialised input, and the
premise of the kernel's power-of-two tau shortcut, swept in numpy. Inputs
come from seeded numpy; every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tflif import tflif_fused as jtflif
from repro_torch.kernels import ops
from repro_torch.kernels.tflif import tflif_fused
from torch_threads import one_thread  # noqa: F401  (autouse)


def exact(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


@pytest.mark.parametrize("t", [1, 4, 9, 17])
def test_stride0_accumulators_match_pallas(t):
    """conv0's accumulators are one (B, H, W, F) tensor expanded over T;
    ``tflif_pack`` on that view, with a per-channel bias and threshold,
    equals the Pallas kernel on the materialised (T, M) input."""
    r = np.random.default_rng(t)
    b_, h, w, f = 2, 3, 5, 8
    acc0 = (r.normal(size=(b_, h, w, f)) * 3).astype(np.float32)
    bias = (r.normal(size=f) * 0.5).astype(np.float32)
    vth = (0.5 + r.random(f)).astype(np.float32)
    acc = torch.from_numpy(acc0).unsqueeze(0).expand(t, b_, h, w, f)
    got = ops.tflif_pack(acc, torch.from_numpy(bias),
                         v_th=torch.from_numpy(vth))
    m = b_ * h * w * f
    x = np.broadcast_to(acc0.reshape(1, m), (t, m))
    want = np.asarray(jtflif(jnp.asarray(x),
                             jnp.asarray(np.tile(bias, m // f)),
                             v_th=jnp.asarray(np.tile(vth, m // f)),
                             interpret=True))
    assert got.shape == (-(-t // 8), b_, h, w, f)
    exact(got.reshape(-1, m), want)
    exact(got, ops.tflif_pack(acc.contiguous(), torch.from_numpy(bias),
                              v_th=torch.from_numpy(vth), plain=True))


def test_tflif_pack_hands_the_stride0_view_to_the_kernel(monkeypatch):
    """No copy: the wrapper receives x with step stride 0 over the
    accumulator's own storage."""
    acc0 = torch.randn(2, 4, 4, 8)
    acc = acc0.unsqueeze(0).expand(4, *acc0.shape)
    seen = {}

    def record(x, bias, v_th, *, tau):
        seen.update(stride=x.stride(), ptr=x.data_ptr())
        return tflif_fused(x, bias, v_th, tau=tau)

    monkeypatch.setattr(ops._WRAPPERS, "tflif", record)
    ops.tflif_pack(acc, 0.1)
    assert seen == {"stride": (0, 1), "ptr": acc0.data_ptr()}


def test_tflif_wrapper_takes_unit_neuron_strides_only():
    x = torch.zeros((4, 6, 2))[..., 0]              # neuron stride 2
    one = torch.ones(1)
    with pytest.raises(ValueError, match="unit neuron stride"):
        tflif_fused(x, one * 0, one)
    with pytest.raises(ValueError, match="x must be"):
        tflif_fused(torch.zeros((4, 6), dtype=torch.float64), one * 0, one)
    view = torch.zeros((8, 6))[::2]                 # step stride 12
    exact(tflif_fused(view, one * 0, one), tflif_fused(view.contiguous(),
                                                      one * 0, one))


def _f32_sweep() -> np.ndarray:
    """Every positive subnormal, a seeded sample of normals across all
    exponents, the extremes, a sixteenth of them negated (rounding to
    nearest is symmetric in sign), and +-0."""
    r = np.random.default_rng(0)
    sub = np.arange(1, 1 << 23, dtype=np.uint32)
    normal = r.integers(0x00800000, 0x7F800000, 1 << 20, dtype=np.uint32)
    edges = np.array([0x00800000, 0x7F7FFFFF, 0x00FFFFFF, 0x01000000],
                     np.uint32)
    pos = np.concatenate([sub, normal, edges]).view(np.float32)
    return np.concatenate([pos, -pos[::16], np.array([0.0, -0.0],
                                                     np.float32)])


@pytest.mark.parametrize("tau", [2.0, 0.5, 4.0, 2.0 ** -20, 2.0 ** 20])
def test_power_of_two_tau_multiply_equals_divide(tau):
    """The kernel's premise for a power-of-two tau (the main path's tau =
    2): ``d * (1 / tau)`` and ``d / tau`` give the same f32 bits for every
    subnormal, normals of every exponent and +-0, since both are the same
    real number rounded once (no flush to zero)."""
    d = _f32_sweep()
    tau32 = np.float32(tau)
    inv = np.float32(1.0) / tau32
    assert inv * tau32 == 1.0                       # the inverse is exact
    with np.errstate(over="ignore", under="ignore"):
        exact((d * inv).view(np.uint32), (d / tau32).view(np.uint32))
