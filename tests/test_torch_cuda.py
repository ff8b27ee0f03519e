"""The four CUDA kernels against their plain versions on the card, and the
``packed_cuda`` path against the plain route there.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips when no card is present, so the same tests are collected everywhere.
The file imports neither ``jax`` nor ``repro`` (the card's machine has no
JAX); run it there without the JAX suite's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.spike import pack_timesteps
from repro_torch.core.spikformer import (SpikformerConfig,
                                         fold_inference_params, init)
from repro_torch.infer import ExecutionPlan, compile
from repro_torch.infer.quant import map_folded_layers
from repro_torch.kernels import lut_matmul as lut
from repro_torch.kernels import ops, ref
from repro_torch.kernels.spike_matmul import (lut_gather_matmul,
                                              spike_matmul_grouped)
from repro_torch.kernels.stdp_attention import stdp_attention
from repro_torch.kernels.tflif import tflif_fused, tflif_plain

pytestmark = pytest.mark.gpu

# f32 weights through the unpack dot: another summation order than the
# plain version's matmul; |sums| stay below ~40 (ulp ~4e-6)
F32_ATOL, F32_RTOL = 1e-4, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain matmuls in f32
    ops.reset_launch_counts()
    return torch.device("cuda")


def gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def spikes(dev, seed, *shape, rate=0.2):
    return (torch.rand(shape, generator=gen(dev, seed), device=dev)
            < rate).to(torch.uint8)


def packed(dev, seed, t, *shape):
    return pack_timesteps(spikes(dev, seed, t, *shape))


def int_weights(dev, seed, k, n):
    return torch.randint(-127, 128, (k, n), generator=gen(dev, seed),
                         device=dev).to(torch.int8)


@pytest.mark.parametrize("t", [1, 4, 8, 9, 17])
def test_tflif_kernel_matches_plain(cuda, t):
    g = gen(cuda, t)
    for m, period in ((1100, 1100), (96 * 13, 96), (5, 1)):
        x = torch.randn((t, m), generator=g, device=cuda) * 2
        bias = torch.randn(period, generator=g, device=cuda) * 0.2
        vth = 0.5 + torch.rand(period, generator=g, device=cuda)
        got = tflif_fused(x, bias, vth)
        torch.cuda.synchronize()
        assert torch.equal(got, tflif_plain(x, bias, vth)), (m, period)
    assert tflif_fused.launches == 3


@pytest.mark.parametrize("int_w", [True, False], ids=["int16", "f32"])
@pytest.mark.parametrize("p,m,k,n", [(4, 37, 100, 19), (8, 1, 12, 64),
                                     (4, 70, 2400, 130), (1, 300, 8, 1)])
def test_lut_gather_kernel_matches_plain(cuda, int_w, p, m, k, n):
    """Ragged rows and columns, and more chunks than one staging pass of
    index bytes (C = 300 > 128)."""
    if int_w:
        w = int_weights(cuda, k, k, n)
    else:
        w = torch.randn((k, n), generator=gen(cuda, k), device=cuda)
    idx = lut.plane_indices(packed(cuda, m, p, m, k))[:p].contiguous()
    tbl = lut.build_lut(w)
    got = lut_gather_matmul(idx, tbl)
    torch.cuda.synchronize()
    assert torch.equal(got, lut.lut_matmul(idx, tbl))
    assert lut_gather_matmul.launches == 1


@pytest.mark.parametrize("t", [1, 4, 8, 9, 17])
@pytest.mark.parametrize("m,k,n", [(21, 40, 13), (130, 512, 70)])
def test_unpack_dot_kernel_matches_plain(cuda, t, m, k, n):
    x = packed(cuda, t, t, m, k)
    wi = int_weights(cuda, m, k, n).to(torch.float32)
    got = spike_matmul_grouped(x, wi, t=t)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.spike_matmul_ref(x, wi, t=t))
    wf = torch.randn((k, n), generator=gen(cuda, n), device=cuda)
    gotf, wantf = spike_matmul_grouped(x, wf, t=t), ref.spike_matmul_ref(
        x, wf, t=t)
    torch.testing.assert_close(gotf, wantf, atol=F32_ATOL, rtol=F32_RTOL)
    assert spike_matmul_grouped.launches == 2


@pytest.mark.parametrize("bh,n,dh", [(256, 196, 64), (3, 100, 32),
                                     (2, 1, 128), (5, 65, 7)])
def test_stdp_kernel_matches_plain(cuda, bh, n, dh):
    """Exact: spike operands give integer sums, and the scale is a power of
    two. N = 100 is where the reference kernel drops KV rows at bq=128,
    bkv=64; the kernel here walks every KV row."""
    q, k, v = (spikes(cuda, i, bh, n, dh).to(torch.float32)
               for i in range(3))
    got = stdp_attention(q, k, v, scale=0.125)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.stdp_attention_ref(q, k, v, scale=0.125))
    assert stdp_attention.launches == 1


def test_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.zeros((2, 4, 129), device=cuda)
    with pytest.raises(ValueError, match="Dh"):
        stdp_attention(q, q, q, scale=1.0)
    x = torch.zeros((4, 6), device=cuda)
    with pytest.raises(ValueError, match="several devices"):
        tflif_fused(x, torch.zeros(1), torch.ones(1, device=cuda))
    with pytest.raises(ValueError, match="x must be"):
        tflif_fused(x.double(), torch.zeros(1, device=cuda),
                    torch.ones(1, device=cuda))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def firing_model(cfg, device, backend, seed=2):
    folded = fold_inference_params(init(torch.Generator().manual_seed(seed),
                                        cfg), cfg)
    folded = map_folded_layers(folded, lambda p, l: {
        **l, "kernel": l["kernel"] * 4.0 * (
            0.7 if p.endswith(("/wo", "/fc2")) else 1.0)})
    return compile(folded, cfg, ExecutionPlan(
        backend=backend, weight_dtype="int8", batch_buckets=(4,),
        max_table_bytes=1 << 18), folded=True, device=device)


def test_packed_cuda_matches_plain_route_on_the_card(cuda):
    """The reduced config with the paper's int8 route mix: bit-identical
    logits against the plain route on the card, the CPU's labels, and one
    launch per layer and kernel."""
    cfg = SpikformerConfig().scaled()
    model = firing_model(cfg, cuda, "packed_cuda")
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 32, 32, 3), dtype=np.uint8))
    ops.reset_launch_counts()
    logits = model.step(imgs)
    torch.cuda.synchronize()
    n_lut = sum(r == "lut" for r in model.plan.routes.values())
    assert ops.launch_counts() == {
        "tflif": 4 + 7 * cfg.depth, "lut_gather": n_lut,
        "unpack_dot": len(model.plan.routes) - n_lut, "stdp": cfg.depth}
    plain = firing_model(cfg, cuda, "packed_plain").step(imgs)
    assert torch.equal(logits, plain)
    assert bool((logits != 0).any())
    cpu = firing_model(cfg, "cpu", "packed_cuda").step(imgs)
    # the head dot runs on another device: rates are exact, logits agree
    # to a few ulp
    torch.testing.assert_close(logits.cpu(), cpu, atol=1e-5, rtol=1e-5)
    assert torch.equal(logits.argmax(-1).cpu(), cpu.argmax(-1))
