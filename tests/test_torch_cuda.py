"""The CUDA kernels against their plain versions on the card, the
``packed_cuda`` path against the plain route and the reference backend
there, the LM stack's prefill through the flash kernel, the LM engines'
CUDA graphs (dense, hybrid with ring caches, SSM) against their eager
engines, and graphed replicas serving from several threads.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips when no card is present, so the same tests are collected everywhere.
The file imports neither ``jax`` nor ``repro`` (the card's machine has no
JAX); run it there without the JAX suite's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py
"""
import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.spike import pack_timesteps, unpack_timesteps
from repro_torch.core.spikformer import (SpikformerConfig,
                                         fold_inference_params, init)
from repro_torch.infer import ExecutionPlan, compile
from repro_torch.infer.compile import lower, replicate_model
from repro_torch.infer.quant import map_folded_layers
from repro_torch.kernels import lut_matmul as lut
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused import tflif_lut_matmul, tflif_lut_plain
from repro_torch.kernels.spike_matmul import (bf16x3_weights,
                                              kmajor_weights,
                                              lut_gather_matmul,
                                              lut_gather_packed,
                                              lut_gather_packed_plain,
                                              shift_sum_matmul, spike_matmul,
                                              spike_matmul_grouped,
                                              spike_matmul_grouped_s8)
from repro_torch.kernels import _build
from repro_torch.kernels.stdp_attention import (STDP_F32_TOL, stdp_attention,
                                                stdp_attention_packed,
                                                stdp_attention_packed_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_f32,
                                                 flash_attention_plain,
                                                 flash_attention_tc)
from repro_torch.kernels.tflif import tflif_fused, tflif_plain
from repro_torch.launch import autotune_routes as tune
from repro_torch.serve import ServeFleet, ServePolicy

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "scripts"))
import wgmma_accumulation as wgmma  # noqa: E402  (the tensor cores' model)

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
    """Periods of M, one value and one per channel; M = 1101 (no 16-byte
    loads: scalar path) and 1100 (16-byte loads); x expanded over T
    (step stride 0), taken without a copy; inputs and thresholds near the
    subnormal range, where the power-of-two tau shortcut must round as the
    divide does; and a tau that is not a power of two."""
    g = gen(cuda, t)
    calls = 0
    for m, period in ((1100, 1100), (96 * 13, 96), (5, 1), (1101, 367)):
        x = torch.randn((t, m), generator=g, device=cuda) * 2
        bias = torch.randn(period, generator=g, device=cuda) * 0.2
        vth = 0.5 + torch.rand(period, generator=g, device=cuda)
        got = tflif_fused(x, bias, vth)
        torch.cuda.synchronize()
        assert torch.equal(got, tflif_plain(x, bias, vth)), (m, period)
        calls += 1
        row = torch.randn((1, m), generator=g, device=cuda) * 2
        xs = row.expand(t, m)                       # stride 0 over T
        assert t == 1 or xs.stride(0) == 0
        got = tflif_fused(xs, bias, vth)
        torch.cuda.synchronize()
        assert torch.equal(got, tflif_plain(xs.contiguous(), bias, vth)), m
        calls += 1
        tiny = torch.randn((t, m), generator=g, device=cuda) * 1e-38
        for tau in (2.0, 0.5, 3.0):
            got = tflif_fused(tiny, bias * 1e-38, vth * 3e-39, tau=tau)
            torch.cuda.synchronize()
            assert torch.equal(got, tflif_plain(tiny, bias * 1e-38,
                                                vth * 3e-39, tau=tau)), tau
            calls += 1
    assert tflif_fused.launches == calls


LUT_SHAPES = [(4, 37, 100, 19), (8, 1, 12, 64), (4, 70, 2400, 130),
              (1, 300, 8, 1), (17, 50, 100, 9), (9, 600, 1100, 72)]
# the main path's shapes at batch 8: q/k/v, path A's fc1, conv0's value
# planes (C = 2)
LUT_MAIN = [(4, 1568, 512, 512), (4, 1568, 512, 2048), (8, 100352, 12, 64)]


@pytest.mark.parametrize("int_w", [True, False], ids=["int16", "f32"])
@pytest.mark.parametrize("p,m,k,n", LUT_SHAPES + LUT_MAIN)
def test_lut_gather_kernel_matches_plain(cuda, int_w, p, m, k, n):
    """Both entries, index bytes and packed spikes, bit-exact against the
    plain versions: ragged rows and columns (odd N reads the table with
    plain loads), K not a multiple of 8, planes past one block (P = 9, 17),
    a slab ring longer than its stages (C = 300 and 138 > 128), and the
    main path's shapes."""
    if int_w:
        w = int_weights(cuda, k, k, n)
    else:
        w = torch.randn((k, n), generator=gen(cuda, k), device=cuda)
    x = packed(cuda, m, p, m, k)
    idx = lut.plane_indices(x)[:p].contiguous()
    tbl = lut.build_lut(w)
    want = lut.lut_matmul(idx, tbl)
    got = lut_gather_matmul(idx, tbl)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    got = lut_gather_packed(x, tbl, t=p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(lut_gather_packed_plain(x, tbl, t=p), want)
    assert lut_gather_matmul.launches == 2


# the f32 unpack dot's layer shapes in the paper config's default f32 plan
# at bucket 8 (M, K, N): conv3, q/k/v/wo, fc1, fc2
UNPACK_MAIN = [(1568, 1024, 512), (1568, 512, 512), (1568, 512, 2048),
               (1568, 2048, 512)]


@pytest.mark.parametrize("t", [1, 4, 8, 9, 17])
@pytest.mark.parametrize("m,k,n", [(21, 40, 13), (130, 512, 70)]
                         + UNPACK_MAIN)
def test_unpack_dot_kernel_matches_plain(cuda, t, m, k, n):
    """The bf16 tensor-core kernel over the weights' three-term split:
    integer-valued weights bit-exact (hi == w, integer sums below 2^24);
    f32 weights within F32_ATOL + F32_RTOL (another summation order). The
    split built per call (counted) and the prebuilt one give the same
    result."""
    x = packed(cuda, t, t, m, k)
    wi = int_weights(cuda, m, k, n).to(torch.float32)
    got = spike_matmul_grouped(x, wi, t=t)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.spike_matmul_ref(x, wi, t=t))
    assert spike_matmul_grouped.split_builds == 1
    wf = torch.randn((k, n), generator=gen(cuda, n), device=cuda)
    gotf = spike_matmul_grouped(x, wf, t=t, w_bf16x3=bf16x3_weights(wf))
    wantf = ref.spike_matmul_ref(x, wf, t=t)
    torch.testing.assert_close(gotf, wantf, atol=F32_ATOL, rtol=F32_RTOL)
    assert torch.equal(spike_matmul_grouped(x, wf, t=t), gotf)
    assert spike_matmul_grouped.launches == 3
    assert spike_matmul_grouped.split_builds == 2


@pytest.mark.parametrize("t,m,k,n,spread", [
    (1, 40, 16, 96, 40), (4, 21, 61, 13, 20), (9, 30, 200, 129, 20),
    (4, 25, 2048, 512, 0)])
def test_unpack_dot_kernel_is_the_wgmma_model(cuda, t, m, k, n, spread):
    """The kernel equals, bit for bit, the plain model of its arithmetic
    (``scripts/wgmma_accumulation.py``: a ``wgmma`` aligns its 16 products
    and the accumulator to the largest, keeps 26 bits, drops the rest and
    rounds toward zero; each slice's hi sum added to an f32 master sum,
    lo and mid in a second accumulator): normal weights scaled by 2^-0 ..
    2^-spread, and fc2's K at spread 0."""
    x = packed(cuda, t + k, t, m, k)
    g = gen(cuda, n)
    w = torch.randn((k, n), generator=g, device=cuda) * torch.exp2(
        -torch.randint(0, spread + 1, (k, n), generator=g,
                       device=cuda).float())
    got = spike_matmul_grouped(x, w, t=t, w_bf16x3=bf16x3_weights(w))
    planes = unpack_timesteps(x, t).reshape(t * m, k).cpu()
    want = wgmma.kept_scheme(planes, w.cpu(), **wgmma.MODEL)
    assert torch.equal(got.cpu(), want.reshape(t, m, n))


def test_unpack_dot_refuses_a_split_it_cannot_read(cuda):
    """The wrapper raises on a split of the wrong type, shape or layout
    (rows not 16 bytes apart, a K stride other than 1) or device, and
    launches nothing."""
    x = packed(cuda, 0, 4, 21, 61)
    w = torch.randn((61, 13), generator=gen(cuda, 1), device=cuda)
    w3 = bf16x3_weights(w)
    with pytest.raises(ValueError, match="bfloat16"):
        spike_matmul_grouped(x, w, t=4, w_bf16x3=w3.to(torch.float16))
    with pytest.raises(ValueError, match="split of the weights"):
        spike_matmul_grouped(x, w, t=4, w_bf16x3=w3[:, :12])
    with pytest.raises(ValueError, match="16 bytes apart"):
        spike_matmul_grouped(x, w, t=4, w_bf16x3=w3.contiguous())
    with pytest.raises(ValueError, match="16 bytes apart"):
        spike_matmul_grouped(x, w, t=4,
                             w_bf16x3=w3.transpose(1, 2).contiguous()
                             .transpose(1, 2))
    with pytest.raises(ValueError, match="several devices"):
        spike_matmul_grouped(x, w, t=4, w_bf16x3=w3.cpu())
    assert spike_matmul_grouped.launches == 0


@pytest.mark.parametrize("t", [1, 4, 8, 9, 17])
@pytest.mark.parametrize("m,k,n", [(21, 40, 13), (130, 512, 70),
                                   (33, 61, 129), (1568, 2048, 512)])
def test_unpack_dot_s8_kernel_matches_plain(cuda, t, m, k, n):
    """The int8 tensor-core kernel bit-exact against its plain version
    (the f32 matmul of the unpacked planes by the int-valued weights):
    ragged rows and columns, K not a multiple of 16 (K = 61 takes the byte
    loads), the tail group at T > 8, and fc2 of the paper config at batch
    8 (1568 rows, K 2048)."""
    x = packed(cuda, t, t, m, k)
    w = int_weights(cuda, m, k, n)
    got = spike_matmul_grouped_s8(x, kmajor_weights(w), t=t)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.spike_matmul_ref(x, w.to(torch.float32),
                                                 t=t))
    assert spike_matmul_grouped_s8.launches == 1
    assert spike_matmul_grouped.launches == 0


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


@pytest.mark.parametrize("bh,n,dh", [(256, 196, 64), (3, 100, 32),
                                     (2, 1, 128), (5, 65, 7)])
def test_stdp_kernel_on_real_values(cuda, bh, n, dh):
    """Real-valued operands through the split-TF32 products (Dh 32, 64:
    the wgmma design; 7, 128: the mma.sync one): within ``STDP_F32_TOL``
    (2^-20) times (|Q| |K|^T) |V| * scale of the plain version's f32 sums,
    the bound of any f32 order of them (the kernels measured 5e-8 to 1.9e-7
    of it on an H100)."""
    q, k, v = (torch.randn((bh, n, dh), generator=gen(cuda, 10 + i),
                           device=cuda) for i in range(3))
    got = stdp_attention(q, k, v, scale=0.125)
    torch.cuda.synchronize()
    want = ref.stdp_attention_ref(q, k, v, scale=0.125)
    bound = STDP_F32_TOL * ref.stdp_attention_ref(q.abs(), k.abs(), v.abs(),
                                                  scale=0.125)
    assert bool(((got - want).abs() <= bound).all())
    assert stdp_attention.launches == 1


@pytest.mark.parametrize("dh", [32, 64])
def test_stdp_kernel_on_unaligned_operands(cuda, dh):
    """Operands 4 bytes past a 16-byte boundary, which TMA cannot read,
    take the mma.sync design at the head dims the wgmma one serves: spikes
    exact, real values within ``STDP_F32_TOL`` of the error scale."""
    def unaligned(z):
        buf = torch.empty(z.numel() + 1, device=cuda)[1:]
        return buf.view(z.shape).copy_(z)

    for real in (False, True):
        q, k, v = (unaligned(torch.randn((3, 196, dh), generator=gen(
            cuda, 20 + i), device=cuda) if real else spikes(
                cuda, 20 + i, 3, 196, dh).to(torch.float32))
                   for i in range(3))
        assert q.data_ptr() % 16 == 4
        got = stdp_attention(q, k, v, scale=0.125)
        torch.cuda.synchronize()
        want = ref.stdp_attention_ref(q, k, v, scale=0.125)
        bound = 0.0 if not real else STDP_F32_TOL * ref.stdp_attention_ref(
            q.abs(), k.abs(), v.abs(), scale=0.125)
        assert bool(((got - want).abs() <= bound).all())
    assert stdp_attention.launches == 2


@pytest.mark.parametrize("t", [1, 4, 9, 17])
@pytest.mark.parametrize("n", [1, 65, 196])
@pytest.mark.parametrize("dh", [7, 64, 128])
def test_stdp_packed_kernel_matches_plain(cuda, t, n, dh):
    """Bit-exact against unpacking and ``stdp_attention_ref``: {0,1}
    planes, integer scores and sums. Dh = 7 takes the byte loads, the
    others the 4-byte loads; the permuted (G, B, H, N, dh) view is the
    backend's ``to_heads`` layout, read in place."""
    x = [spikes(cuda, 10 * t + i, t, 2, n, 3 * dh) for i in range(3)]
    q, k, v = (pack_timesteps(z).reshape(-1, 2, n, 3, dh).permute(
        0, 1, 3, 2, 4) for z in x)                      # (G, 2, 3, N, Dh)
    got = stdp_attention_packed(q, k, v, t=t, scale=0.125)
    torch.cuda.synchronize()
    assert got.shape == (t, 2, 3, n, dh)
    assert torch.equal(got, stdp_attention_packed_plain(q, k, v, t=t,
                                                        scale=0.125))
    assert torch.equal(stdp_attention_packed(
        q.contiguous(), k.contiguous(), v.contiguous(), t=t, scale=0.125),
        got)
    assert stdp_attention_packed.launches == 2


@pytest.mark.parametrize("int_w", [True, False], ids=["int16", "f32"])
@pytest.mark.parametrize("t", [1, 4, 8, 9, 17, 33])
@pytest.mark.parametrize("r,k,n", [(37, 61, 19), (5, 2048, 130),
                                   (100, 8, 1)])
def test_fused_lif_lut_kernel_matches_plain(cuda, int_w, t, r, k, n):
    """Both outputs bit-exact, for ragged rows, columns and K (padded
    neurons never fire), every register configuration of T, and a
    membrane that crosses group boundaries."""
    g = gen(cuda, t * k)
    x = torch.randn((t, r, k), generator=g, device=cuda) * 1.5
    bias = torch.randn(k, generator=g, device=cuda) * 0.3
    vth = 0.5 + torch.rand(k, generator=g, device=cuda)
    if int_w:
        w = int_weights(cuda, k, k, n)
    else:
        w = torch.randn((k, n), generator=gen(cuda, n), device=cuda)
    tbl = lut.build_lut(w)
    spk, acc = tflif_lut_matmul(x, bias, tbl, vth)
    torch.cuda.synchronize()
    want_spk, want_acc = tflif_lut_plain(x, bias, tbl, vth)
    assert torch.equal(spk, want_spk)
    assert torch.equal(acc, want_acc)
    assert tflif_lut_matmul.launches == 1


@pytest.mark.parametrize("int_w", [True, False], ids=["int16", "f32"])
@pytest.mark.parametrize("t", [1, 4, 9])
@pytest.mark.parametrize("r,k", [(300, 2048), (37, 61), (600, 100)])
def test_fused_lif_lut_kernel_full_cluster(cuda, int_w, t, r, k):
    """N = 300 takes 10 column tiles of 32: a full cluster of 8 (one chunk
    of each group's LIF a block) and a second cluster whose 6 blocks past N
    run only their LIF share. K = 100 ends in a half chunk, K = 61 in a
    ragged one. Both outputs bit-exact."""
    n = 300
    g = gen(cuda, 7 * t + k)
    x = torch.randn((t, r, k), generator=g, device=cuda) * 1.5
    bias = torch.randn(k, generator=g, device=cuda) * 0.3
    vth = 0.5 + torch.rand(k, generator=g, device=cuda)
    if int_w:
        w = int_weights(cuda, k, k, n)
    else:
        w = torch.randn((k, n), generator=gen(cuda, n), device=cuda)
    tbl = lut.build_lut(w)
    spk, acc = tflif_lut_matmul(x, bias, tbl, vth)
    torch.cuda.synchronize()
    want_spk, want_acc = tflif_lut_plain(x, bias, tbl, vth)
    assert torch.equal(spk, want_spk)
    assert torch.equal(acc, want_acc)


@pytest.mark.parametrize("m,k,n", [(100352, 12, 64), (1000, 61, 70),
                                   (3, 1, 1), (67, 200, 129)])
def test_shift_sum_kernel_matches_plain(cuda, m, k, n):
    """Exact for integer-valued weights; f32 weights within atol 1e-3 +
    rtol 1e-5 (another summation order than the per-plane plain version;
    at K=200 sums of byte values times normal weights reach ~1e4, ulp
    ~1e-3)."""
    x = torch.randint(0, 256, (m, k), generator=gen(cuda, m), device=cuda,
                      dtype=torch.uint8)
    wi = int_weights(cuda, k, k, n).to(torch.float32)
    got = shift_sum_matmul(x, wi)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.spike_matmul_ref(x, wi, mode="shift_sum"))
    wf = torch.randn((k, n), generator=gen(cuda, n), device=cuda)
    gotf = spike_matmul(x, wf, mode="shift_sum")
    wantf = ref.spike_matmul_ref(x, wf, mode="shift_sum")
    torch.testing.assert_close(gotf, wantf, atol=1e-3, rtol=1e-5)
    assert shift_sum_matmul.launches == 2
    per = spike_matmul(x, wi, mode="per_plane")
    assert torch.equal(per, ref.spike_matmul_ref(x, wi, mode="per_plane"))
    assert spike_matmul_grouped.launches == 1


def test_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.zeros((2, 4, 129), device=cuda)
    with pytest.raises(ValueError, match="Dh"):
        stdp_attention(q, q, q, scale=1.0)
    qp = torch.zeros((1, 2, 5, 8), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="several devices"):
        stdp_attention_packed(qp, qp.cpu(), qp, t=4, scale=1.0)
    with pytest.raises(ValueError, match="exact only"):
        stdp_attention_packed(*[torch.zeros((1, 2, 2049), dtype=torch.uint8,
                                            device=cuda)] * 3, t=4, scale=1.0)
    x = torch.zeros((4, 6), device=cuda)
    with pytest.raises(ValueError, match="several devices"):
        tflif_fused(x, torch.zeros(1), torch.ones(1, device=cuda))
    with pytest.raises(ValueError, match="x must be"):
        tflif_fused(x.double(), torch.zeros(1, device=cuda),
                    torch.ones(1, device=cuda))
    x3 = torch.zeros((65, 3, 16), device=cuda)
    k16 = torch.zeros(16, device=cuda)
    tbl = torch.zeros((2, 256, 4), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError, match="T <= 64"):
        tflif_lut_matmul(x3, k16, tbl, k16 + 1)
    with pytest.raises(ValueError, match="several devices"):
        tflif_lut_matmul(x3[:4], k16, tbl.cpu(), k16 + 1)
    with pytest.raises(ValueError, match="table must be"):
        tflif_lut_matmul(x3[:4], k16, tbl.to(torch.int32), k16 + 1)
    xb = torch.zeros((5, 12), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="several devices"):
        shift_sum_matmul(xb, torch.zeros((12, 4)))
    with pytest.raises(ValueError, match="w must be"):
        shift_sum_matmul(xb, torch.zeros((12, 4), dtype=torch.float64,
                                         device=cuda))
    with pytest.raises(ValueError, match="x must be"):
        spike_matmul(xb[None], torch.zeros((12, 4), device=cuda),
                     mode="shift_sum")
    xs = torch.zeros((1, 3, 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="int8"):
        spike_matmul_grouped_s8(xs, torch.zeros((4, 16), device=cuda), t=4)
    with pytest.raises(ValueError, match="rows 16"):
        spike_matmul_grouped_s8(xs[..., :12].contiguous(), torch.zeros(
            (4, 12), dtype=torch.int8, device=cuda), t=4)
    qa = torch.zeros((2, 8, 48), device=cuda)
    with pytest.raises(ValueError, match="Dh in"):
        flash_attention(qa, qa, qa, scale=1.0)
    qb = torch.zeros((2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="several devices"):
        flash_attention(qb, qb.cpu(), qb, scale=1.0)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def firing_model(cfg, device, backend, seed=2, jit=False, buckets=(4,),
                 **plan):
    """The seeded reduced model with gains that keep it firing; eager
    unless ``jit``, so a step's launches tick the counters once."""
    folded = fold_inference_params(init(torch.Generator().manual_seed(seed),
                                        cfg), cfg)
    folded = map_folded_layers(folded, lambda p, l: {
        **l, "kernel": l["kernel"] * 4.0 * (
            0.7 if p.endswith(("/wo", "/fc2")) else 1.0)})
    plan = {"weight_dtype": "int8", "max_table_bytes": 1 << 18, **plan}
    return compile(folded, cfg, ExecutionPlan(
        backend=backend, batch_buckets=buckets, **plan), folded=True,
        device=device, jit=jit)


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
        "tflif": 4 + 7 * cfg.depth, "lut_gather": n_lut, "unpack_dot": 0,
        "unpack_dot_s8": len(model.plan.routes) - n_lut, "stdp": 0,
        "stdp_packed": cfg.depth, "fused_lif_lut": 0, "shift_sum": 0,
        "flash_attention_tc": 0, "flash_attention_f32": 0}
    plain = firing_model(cfg, cuda, "packed_plain").step(imgs)
    assert torch.equal(logits, plain)
    assert bool((logits != 0).any())
    cpu = firing_model(cfg, "cpu", "packed_cuda").step(imgs)
    # the head dot runs on another device: rates are exact, logits agree
    # to a few ulp
    torch.testing.assert_close(logits.cpu(), cpu, atol=1e-5, rtol=1e-5)
    assert torch.equal(logits.argmax(-1).cpu(), cpu.argmax(-1))


def test_route_pinned_plans_match_plain_and_reference_on_the_card(cuda):
    """The two route-pinned plans at the reduced config on the card. f32
    weights with every layer on the gather: one fused launch per block,
    logits bit-identical across ``packed_cuda``, ``packed_cuda`` unfused,
    ``packed_plain`` and the ``reference`` backend. int8 with every table
    stripped: conv0 runs the shift-sum kernel, and logits equal the plain
    route's."""
    cfg = SpikformerConfig().scaled()
    imgs = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (4, 32, 32, 3), dtype=np.uint8))
    lut_plan = {"weight_dtype": "float32", "route": "lut"}
    model = firing_model(cfg, cuda, "packed_cuda", **lut_plan)
    ops.reset_launch_counts()
    logits = model.step(imgs)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        "tflif": 4 + 6 * cfg.depth, "lut_gather": 4 + 5 * cfg.depth,
        "unpack_dot": 0, "unpack_dot_s8": 0, "stdp": 0,
        "stdp_packed": cfg.depth,
        "fused_lif_lut": cfg.depth, "shift_sum": 0, "flash_attention_tc": 0,
        "flash_attention_f32": 0}
    assert bool((logits != 0).any())
    for backend, opts in (("packed_cuda", {"fuse_mlp": False}),
                          ("packed_plain", {}), ("reference", {})):
        other = firing_model(cfg, cuda, backend, backend_options=opts,
                             **lut_plan)
        assert other.plan.routes == model.plan.routes
        assert torch.equal(other.step(imgs), logits), backend

    unpack = firing_model(cfg, cuda, "packed_cuda", route="unpack")
    ops.reset_launch_counts()
    logits = unpack.step(imgs)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        "tflif": 4 + 7 * cfg.depth, "lut_gather": 0, "unpack_dot": 0,
        "unpack_dot_s8": 3 + 6 * cfg.depth, "stdp": 0,
        "stdp_packed": cfg.depth, "fused_lif_lut": 0, "shift_sum": 1,
        "flash_attention_tc": 0, "flash_attention_f32": 0}
    plain = firing_model(cfg, cuda, "packed_plain", route="unpack")
    assert torch.equal(plain.step(imgs), logits)


def test_lut_plan_past_the_fused_kernels_steps_runs_two_layers(cuda):
    """At T = 65 the fused MLP kernel cannot hold every step in registers:
    a ``route="lut"`` step then runs fc1 and fc2 as two layers on the card
    (no fused launch, one more gather a block) and gives the plain route's
    logits bit for bit."""
    cfg = SpikformerConfig().scaled(timesteps=65)
    imgs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (4, 32, 32, 3), dtype=np.uint8))
    lut_plan = {"weight_dtype": "float32", "route": "lut"}
    model = firing_model(cfg, cuda, "packed_cuda", **lut_plan)
    ops.reset_launch_counts()
    logits = model.step(imgs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["fused_lif_lut"] == 0
    assert counts["lut_gather"] == 4 + 6 * cfg.depth
    assert bool((logits != 0).any())
    plain = firing_model(cfg, cuda, "packed_plain", **lut_plan)
    assert torch.equal(plain.step(imgs), logits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bh,nq,nkv,dh,causal", [
    (3, 128, 128, 32, True), (3, 64, 256, 64, True), (3, 1, 512, 32, True),
    (3, 200, 200, 64, True), (3, 100, 333, 128, True), (2, 77, 77, 64, True),
    (2, 100, 333, 64, False), (15, 2048, 2048, 64, True),
    (4, 1000, 1000, 128, False), (3, 100, 333, 160, True),
    (2, 77, 77, 160, True), (3, 1, 512, 160, True),
    (2, 100, 333, 160, False), (4, 1000, 1000, 160, False)])
def test_flash_kernel_matches_plain(cuda, dtype, bh, nq, nkv, dh, causal):
    """Kernel 7 against its plain version (exact softmax in f32 on the same
    values) within atol = rtol = 2e-4, the reference's flash tolerance;
    ragged lengths pad both the query and the key tiles. bf16 runs the
    bf16 tensor-core kernel, f32 the split-TF32 one."""
    g = gen(cuda, nq + nkv + dh)
    q, k, v = (torch.randn((bh, n, dh), generator=g, device=cuda).to(dtype)
               for n in (nq, nkv, nkv))
    got = flash_attention(q, k, v, scale=dh ** -0.5, causal=causal)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, scale=dh ** -0.5, causal=causal)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    bf16 = dtype == torch.bfloat16
    assert flash_attention_tc.launches == int(bf16)
    assert flash_attention_f32.launches == int(not bf16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hq,kvh,nq,nkv,dh,causal", [
    (1, 15, 5, 2048, 2048, 64, True), (1, 25, 5, 2048, 2048, 64, True),
    (2, 6, 2, 200, 200, 64, True),
    (2, 6, 2, 100, 333, 128, False), (3, 3, 1, 77, 300, 32, True),
    (2, 8, 2, 200, 200, 160, True), (2, 8, 2, 100, 333, 160, False),
    (1, 32, 2, 77, 300, 128, True)])
def test_flash_kernel_grouped_heads_and_strided_views(cuda, dtype, b, hq,
                                                      kvh, nq, nkv, dh,
                                                      causal):
    """Grouped-query heads (group Hq / KV: smollm-360m's 3 over 15 heads,
    hymba-1.5b's 5 over 25) and the LM path's layouts, read in place: q
    transposed from (B, S, Hq, Dh) and k, v the first rows of a longer
    (B, KV, L, Dh) cache, against the plain version (KV expanded) within
    2e-4."""
    g = gen(cuda, hq * nkv + dh)
    q = torch.randn((b, nq, hq, dh), generator=g, device=cuda).to(
        dtype).transpose(1, 2)
    cache = [torch.randn((b, kvh, nkv + 50, dh), generator=g,
                         device=cuda).to(dtype) for _ in range(2)]
    k, v = (c[:, :, :nkv] for c in cache)
    got = flash_attention(q, k, v, scale=dh ** -0.5, causal=causal)
    torch.cuda.synchronize()
    want = flash_attention_plain(q.cpu(), k.cpu(), v.cpu(), scale=dh ** -0.5,
                                 causal=causal)
    assert got.shape == (b, hq, nq, dh)
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(
        got, flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             scale=dh ** -0.5, causal=causal),
        atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hq,kvh,dh", [(32, 8, 160), (32, 2, 128),
                                      (32, 4, 128), (64, 8, 128)],
                         ids=["stablelm-12b", "glm4-9b", "qwen3-moe-30b-a3b",
                              "qwen1.5-110b"])
def test_flash_kernel_at_the_dense_prefills(cuda, dtype, hq, kvh, dh):
    """Kernel 7 at the 2048-token prefills of stablelm-12b (32 heads over 8
    KV heads, Dh 160), glm4-9b (32 over 2, Dh 128, group 16),
    qwen3-moe-30b-a3b (32 over 4, Dh 128) and qwen1.5-110b (64 over 8, Dh
    128, the sharded path's), laid out
    as the LM path hands them over (q transposed from (1, S, Hq, Dh), k and
    v the first S rows of a (1, KV, 2S, Dh) cache), causal: within 2e-4 of
    the plain version and of SDPA in f32 on the same values (KV
    expanded), in one launch of the dtype's kernel."""
    s = 2048
    g = gen(cuda, hq * kvh + dh)
    q = torch.randn((1, s, hq, dh), generator=g, device=cuda).to(
        dtype).transpose(1, 2)
    k, v = (torch.randn((1, kvh, 2 * s, dh), generator=g, device=cuda).to(
        dtype)[:, :, :s] for _ in range(2))
    got = flash_attention(q, k, v, scale=dh ** -0.5)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (flash_attention_tc.launches, flash_attention_f32.launches) == (
        int(bf16), int(not bf16))
    assert got.shape == (1, hq, s, dh) and got.dtype == torch.float32
    want = flash_attention_plain(q, k, v, scale=dh ** -0.5)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    ke, ve = (z.float().repeat_interleave(hq // kvh, dim=1) for z in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        q.float(), ke, ve, is_causal=True, scale=dh ** -0.5)
    torch.testing.assert_close(got, sdpa, atol=2e-4, rtol=2e-4)


# (b, hq, kvh, nq, nkv, dh, causal, k/v layout) of each layout: whisper's
# prefill of 4 rows of 440 tokens over 1500 frames, qwen2-vl's 2048 tokens
ENCDEC_VLM_LAYOUTS = {
    "whisper-encoder": (4, 20, 20, 1500, 1500, 64, False, "projection"),
    "whisper-cross": (4, 20, 20, 440, 1500, 64, False, "projection"),
    "whisper-self": (4, 20, 20, 440, 440, 64, True, "cache"),
    "qwen2-vl-7b": (1, 28, 4, 2048, 2048, 128, True, "cache")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", sorted(ENCDEC_VLM_LAYOUTS))
def test_flash_kernel_at_the_encdec_and_vlm_prefills(cuda, dtype, layout):
    """Kernel 7 at whisper-large-v3's three prefill layouts (the encoder's
    non-causal self-attention over 1500 frames, which no tile divides;
    the decoder's 440 queries over the 1500 frames' keys, non-causal;
    its causal self-attention over k, v slices of a cache 32 longer) and
    qwen2-vl-7b's 2048-token prefill (28 heads over 4, group 7, Dh 128),
    read in place as the LM path hands them over (q transposed from (B,
    Nq, Hq, Dh); k, v transposed projections or cache slices): one launch
    of the dtype's kernel, within 2e-4 of the plain version."""
    b, hq, kvh, nq, nkv, dh, causal, kv = ENCDEC_VLM_LAYOUTS[layout]
    g = gen(cuda, nq + nkv + dh)
    q = torch.randn((b, nq, hq, dh), generator=g, device=cuda).to(
        dtype).transpose(1, 2)
    if kv == "cache":
        k, v = (torch.randn((b, kvh, nkv + 32, dh), generator=g,
                            device=cuda).to(dtype)[:, :, :nkv]
                for _ in range(2))
    else:
        k, v = (torch.randn((b, nkv, kvh, dh), generator=g,
                            device=cuda).to(dtype).transpose(1, 2)
                for _ in range(2))
    got = flash_attention(q, k, v, scale=dh ** -0.5, causal=causal)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (flash_attention_tc.launches, flash_attention_f32.launches) == (
        int(bf16), int(not bf16))
    assert got.shape == (b, hq, nq, dh) and got.dtype == torch.float32
    want = flash_attention_plain(q, k, v, scale=dh ** -0.5, causal=causal)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-7b"])
def test_encdec_and_vlm_reduced_prefill_on_the_card_equals_the_cpu(cuda,
                                                                    arch):
    """Reduced whisper (the encoder over 16 frames, cross-attention) and
    reduced qwen2-vl (image embeddings, distinct M-RoPE streams) in f32
    from one seeded CPU tree: a prefill on the card launches the f32 flash
    kernel (whisper: the encoder's layers plus two a decoder layer;
    qwen2-vl: one a layer), and its logits, cache and a decode step after
    it are the CPU's within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.infer.compile import to_device
    from repro_torch.nn import transformer as T

    cfg = get_config(arch).reduced()
    params = T.init_model(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 40), generator=g)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, cfg.n_frames, cfg.d_model),
                                      generator=g).bfloat16()
    else:
        batch["image_embeds"] = torch.randn(
            (2, cfg.img_tokens, cfg.d_model), generator=g).bfloat16()
        batch["mrope_positions"] = torch.randint(0, 80, (3, 2, 40),
                                                 generator=g)
    step = {"tokens": batch["tokens"][:, :1], "cache_pos": 40}
    if cfg.family == "vlm":
        step["mrope_positions"] = torch.full((3, 2, 1), 81)
    out = {}
    for dev in ("cpu", cuda):
        p = to_device(params, dev)
        ops.reset_launch_counts()
        cache = T.init_cache(cfg, 2, 48, dtype=torch.float32, device=dev)
        pre, cache, _ = T.model_apply(
            p, {**to_device(batch, dev), "cache_pos": 0}, cfg,
            mode="prefill", cache=cache, compute_dtype=torch.float32)
        dec, cache, _ = T.model_apply(
            p, to_device(step, dev), cfg, mode="decode", cache=cache,
            compute_dtype=torch.float32)
        torch.cuda.synchronize()
        out[str(dev)] = (pre.cpu(), dec.cpu(), to_device(cache, "cpu"))
    n = cfg.n_layers * (2 if cfg.family == "encdec" else 1) + (
        cfg.encoder_layers if cfg.family == "encdec" else 0)
    assert ops.launch_counts()["flash_attention_f32"] == n
    for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    for name in out["cpu"][2]:
        want = out["cpu"][2][name]
        got = out["cuda"][2][name]
        if isinstance(want, dict):
            for k in want:
                torch.testing.assert_close(got[k], want[k], atol=1e-4,
                                           rtol=1e-4)
        else:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_flash_kernel_takes_every_stated_head_dim(cuda, causal):
    """Every head dim the bf16 kernel states (multiples of 8 up to 192) at
    a ragged (2, 70, 133) shape, grouped 2 over 1: within 2e-4 of the plain
    version."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    assert HEAD_DIMS[torch.bfloat16] == tuple(range(8, 193, 8))
    for dh in HEAD_DIMS[torch.bfloat16]:
        g = gen(cuda, dh)
        q = torch.randn((1, 2, 70, dh), generator=g, device=cuda).to(
            torch.bfloat16)
        k, v = (torch.randn((1, 1, 133, dh), generator=g, device=cuda).to(
            torch.bfloat16) for _ in range(2))
        got = flash_attention(q, k, v, scale=dh ** -0.5, causal=causal)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, scale=dh ** -0.5,
                                     causal=causal)
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4,
                                   msg=lambda m: f"Dh {dh}: {m}")
    assert flash_attention_tc.launches == len(HEAD_DIMS[torch.bfloat16])


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 200),
                                      (torch.bfloat16, 12),
                                      (torch.float32, 96),
                                      (torch.float32, 192)])
def test_flash_refuses_a_head_dim_outside_its_kernel(cuda, dtype, dh):
    """A head dim the dtype's kernel does not take raises on the card,
    launching nothing (no plain or library fallback)."""
    q = torch.zeros((1, 2, 16, dh), dtype=dtype, device=cuda)
    with pytest.raises(ValueError, match="Dh in"):
        flash_attention(q, q, q, scale=0.125)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_flash_f32_kernel_reads_grouped_strided_views_in_place(cuda,
                                                               monkeypatch):
    """The f32 kernel on smollm's prefill layout, (1, 15, 2048, 64) q
    transposed from (1, 2048, 15, 64) over k and v the first 2048 rows of
    a (1, 5, 2098, 64) cache: the plain version's result (KV expanded)
    within 2e-4, in one launch that gets each view's own address (no
    expansion, no copy)."""
    g = gen(cuda, 2048)
    q = torch.randn((1, 2048, 15, 64), generator=g,
                    device=cuda).transpose(1, 2)
    k, v = (torch.randn((1, 5, 2098, 64), generator=g,
                        device=cuda)[:, :, :2048] for _ in range(2))
    seen = []
    real = _build.kernel_function

    def spy(name, symbol, argtypes):
        fn = real(name, symbol, argtypes)

        def launch(*args):
            seen.append(args[:3])
            return fn(*args)
        return launch
    monkeypatch.setattr(_build, "kernel_function", spy)
    got = flash_attention(q, k, v, scale=0.125)
    torch.cuda.synchronize()
    assert seen == [(q.data_ptr(), k.data_ptr(), v.data_ptr())]
    assert flash_attention_f32.launches == 1
    assert flash_attention_tc.launches == 0
    want = flash_attention_plain(q, k, v, scale=0.125)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def test_lm_prefill_runs_the_flash_kernel(cuda):
    """The reduced smollm config in f32 on the card: a prefill into a cache
    launches the flash kernel once a layer, its logits and the decode step
    after it agree with the plain route, and the engine serves on the
    card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine, Request
    from repro_torch.nn import transformer as T

    cfg = get_config("smollm-360m").reduced()
    params = T.init_model(torch.Generator(device=cuda).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 77), generator=gen(cuda, 1),
                         device=cuda)
    out = {}
    for flash in (True, False):
        ops.reset_launch_counts()
        cache = T.init_cache(cfg, 2, 96, dtype=torch.float32)
        pre, cache, _ = T.model_apply(
            params, {"tokens": toks, "cache_pos": 0}, cfg, mode="prefill",
            cache=cache, compute_dtype=torch.float32, flash=flash)
        dec, _, _ = T.model_apply(
            params, {"tokens": toks[:, :1],
                     "cache_pos": torch.tensor([77, 80], device=cuda)},
            cfg, mode="decode", cache=cache, compute_dtype=torch.float32,
            flash=flash)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention_f32"] == (
            cfg.n_layers if flash else 0)
        out[flash] = (pre, dec)
    for got, want in zip(out[True], out[False]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    eng = Engine(cfg, slots=2, cache_len=96)
    for i, n in enumerate((5, 77, 30)):
        eng.submit(Request(rid=i, prompt=list(range(n)), max_new=4))
    assert [len(r.out) for r in eng.run()] == [4, 4, 4]


DENSE = {"stablelm-12b": dict(head_dim=160), "glm4-9b": {}}


@pytest.mark.parametrize("arch", sorted(DENSE))
def test_dense_f32_prefill_runs_the_flash_kernel(cuda, arch):
    """Reduced stablelm-12b at its full width's head dim (160: QK-norm, 40
    rotary columns, layernorm) and reduced glm4-9b (QKV bias) in f32 on
    the card: a prefill launches the f32 flash kernel once a layer, and
    its logits and the decode step after it agree with the plain route
    within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.nn import transformer as T

    cfg = get_config(arch).reduced(**DENSE[arch])
    params = T.init_model(torch.Generator(device=cuda).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 77), generator=gen(cuda, 1),
                         device=cuda)
    out = {}
    for flash in (True, False):
        ops.reset_launch_counts()
        cache = T.init_cache(cfg, 2, 96, dtype=torch.float32)
        pre, cache, _ = T.model_apply(
            params, {"tokens": toks, "cache_pos": 0}, cfg, mode="prefill",
            cache=cache, compute_dtype=torch.float32, flash=flash)
        dec, _, _ = T.model_apply(
            params, {"tokens": toks[:, :1],
                     "cache_pos": torch.tensor([77, 80], device=cuda)},
            cfg, mode="decode", cache=cache, compute_dtype=torch.float32,
            flash=flash)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention_f32"] == (
            cfg.n_layers if flash else 0)
        out[flash] = (pre, dec)
    for got, want in zip(out[True], out[False]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", sorted(DENSE))
def test_dense_graphed_engine_serves_the_eager_tokens(cuda, arch):
    """The two dense configs reduced as above, in bf16, two slots, prompts
    of 5, 77, 5 and 130 tokens: the graphed engine's greedy tokens and
    caches equal the eager engine's bit for bit, and captured launches x
    replays equal the eager counts (one bf16 flash launch a layer and
    prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine

    cfg = get_config(arch).reduced(**DENSE[arch])
    graphed = Engine(cfg, slots=2, cache_len=136, seed=3, device=cuda)
    eager = Engine(cfg, slots=2, cache_len=136, params=graphed.params,
                   device=cuda, jit=False)
    prompts = [lm_prompt(cfg, n, i) for i, n in enumerate((5, 77, 5, 130))]
    ops.reset_launch_counts()
    want = serve_lm(eager, prompts, 10)
    eager_counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert eager_counts == {"flash_attention_tc": 4 * cfg.n_layers}
    assert serve_lm(graphed, prompts, 10) == want          # captures
    graphed.reset_graph_launch_counts()
    ops.reset_launch_counts()
    assert serve_lm(graphed, prompts, 10) == want          # replays only
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert graphed.graph_launch_counts() == eager_counts
    same_caches(graphed, eager, "after serving")


def test_init_model_peak_is_the_params_and_one_layer(cuda):
    """``init_model`` on the card draws each layer into the stacked leaves:
    for smollm-360m at full width (32 layers, 1.26 GB of them) the peak
    allocated memory stays within the parameters' bytes plus 1 GiB (the
    list-and-stack build held every layer twice), and a second build from
    the same seed gives the same bits."""
    from repro_torch.configs import get_config
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import leaves, param_bytes

    cfg = get_config("smollm-360m")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(torch.Generator(device=cuda).manual_seed(0), cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    layers = param_bytes(params["layers"])
    assert layers >= 2 ** 30
    assert peak <= param_bytes(params) + 2 ** 30, (peak, param_bytes(params))
    again = T.init_model(torch.Generator(device=cuda).manual_seed(0), cfg)
    assert all(torch.equal(x, y)
               for x, y in zip(leaves(params), leaves(again)))


def test_bf16_init_model_whose_layer_outweighs_its_head(cuda):
    """qwen3-moe-30b-a3b at full width in bf16 weights, cut to 2 layers:
    a layer (1.25 GB, 1.21 of it three (128, 2048, 768)-sized expert
    leaves) outweighs the head drawn after it (0.62 GB), so the peak is
    the stack, the embedding and one layer's tree. Each bf16 leaf is drawn
    in f32 slabs of ``SLAB_BYTES`` into the leaf: the peak stays within
    the parameters' bytes plus 1 GiB (drawing a whole expert leaf in f32,
    casting, then scaling into a third tensor would add 1.2 GB), the
    router and norms are f32, and the same seed gives the same bits."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import leaves, param_bytes

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), n_layers=2,
                              param_dtype="bfloat16")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(torch.Generator(device=cuda).manual_seed(0), cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    layer = param_bytes(params["layers"]) // cfg.n_layers
    assert layer > param_bytes(params["head"]) + 2 ** 29
    assert peak <= param_bytes(params) + 2 ** 30, (peak, param_bytes(params))
    moe = params["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].dtype == torch.bfloat16
    assert params["layers"]["ln1"]["scale"].dtype == torch.float32
    assert 0 < float(moe["w_down"].float().std()) < 0.05
    again = T.init_model(torch.Generator(device=cuda).manual_seed(0), cfg)
    assert all(torch.equal(x, y)
               for x, y in zip(leaves(params), leaves(again)))


def test_moe_layer_on_the_card_routes_as_the_cpu(cuda):
    """One qwen3-moe layer at full width (128 experts top-8 of moe_d_ff
    768, d_model 2048) in bf16 weights, on bf16 inputs of 2 rows x 256
    tokens (capacity 21 slots an expert, so tokens are dropped): on the
    card and on the port's CPU route, the routing is equal (each token's
    experts, the slot table, the empty slots: the router product runs in
    f32 without TF32 even where the caller allowed TF32) and the gates
    within 1e-6; the output within atol = rtol = 2e-2 (the experts'
    products rounded to bf16 in other orders) and the aux losses within
    1e-4. The CPU's routing is the reference's (``test_torch_moe.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.nn import moe

    cfg = get_config("qwen3-moe-30b-a3b")
    p = moe.moe_init(gen(cuda, 0), cfg, dtype=torch.bfloat16)
    x = torch.randn((2, 256, cfg.d_model), generator=gen(cuda, 1),
                    device=cuda).to(torch.bfloat16)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        r = moe.route(p, x, cfg)
        y, aux = moe.moe_apply(p, x, cfg)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    pc = {k: v.cpu() for k, v in p.items()}
    want = moe.route(pc, x.cpu(), cfg)
    for name in ("idx", "tok", "valid"):
        assert torch.equal(getattr(r, name).cpu(), getattr(want, name)), name
    torch.testing.assert_close(r.gate.cpu(), want.gate, rtol=0, atol=1e-6)
    assert int(want.dropped()) > 0
    y_cpu, aux_cpu = moe.moe_apply(pc, x.cpu(), cfg)
    torch.testing.assert_close(y.cpu().float(), y_cpu.float(), rtol=2e-2,
                               atol=2e-2)
    for k in aux_cpu:
        torch.testing.assert_close(aux[k].cpu(), aux_cpu[k], rtol=1e-4,
                                   atol=1e-4)


def test_moe_graphed_engine_serves_the_eager_tokens(cuda):
    """Reduced qwen3-moe with drops (16 experts top-8, capacity factor 1)
    in bf16, two slots, prompts of 5, 77, 5 and 130 tokens: the graphed
    engine's greedy tokens and caches equal the eager engine's bit for bit
    (each captured decode step replayed against the eager one: routing,
    slot table and the ordered bf16 combine are deterministic on the
    card), and captured launches x replays equal the eager counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine

    cfg = get_config("qwen3-moe-30b-a3b").reduced(
        n_experts=16, top_k=8, moe_capacity_factor=1.0)
    graphed = Engine(cfg, slots=2, cache_len=136, seed=3, device=cuda)
    eager = Engine(cfg, slots=2, cache_len=136, params=graphed.params,
                   device=cuda, jit=False)
    prompts = [lm_prompt(cfg, n, i) for i, n in enumerate((5, 77, 5, 130))]
    ops.reset_launch_counts()
    want = serve_lm(eager, prompts, 10)
    eager_counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert eager_counts == {"flash_attention_tc": 4 * cfg.n_layers}
    assert serve_lm(graphed, prompts, 10) == want          # captures
    graphed.reset_graph_launch_counts()
    ops.reset_launch_counts()
    assert serve_lm(graphed, prompts, 10) == want          # replays only
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert graphed.graph_launch_counts() == eager_counts
    same_caches(graphed, eager, "after serving")


# ---------------------------------------------------------------------------
# jit=True: one CUDA graph per bucket
# ---------------------------------------------------------------------------

GRAPH_PLANS = {"int8": {}, "lut": {"weight_dtype": "float32", "route": "lut"},
               "unpack": {"route": "unpack"}}


@pytest.mark.parametrize("name", sorted(GRAPH_PLANS))
def test_graph_replay_equals_the_eager_step(cuda, name):
    """On the int8 default plan, path A and path B at the reduced config,
    each bucket's replayed graph gives the eager step's logits bit for bit,
    from host images and from images on the card; a capture records one
    step's launches, and replays count them once each."""
    cfg = SpikformerConfig().scaled()
    plan = GRAPH_PLANS[name]
    graphed = firing_model(cfg, cuda, "packed_cuda", jit=True,
                           buckets=(1, 4), **plan)
    eager = firing_model(cfg, cuda, "packed_cuda", buckets=(1, 4), **plan)
    imgs = np.random.default_rng(5).integers(0, 256, (4, 32, 32, 3),
                                             dtype=np.uint8)
    want_one = eager.step(imgs[:1])
    ops.reset_launch_counts()
    want = eager.step(imgs)
    torch.cuda.synchronize()
    per_step = {k: v for k, v in ops.launch_counts().items() if v}
    graphed.warmup()
    assert graphed._fwd.graphs[4].launches == per_step
    graphed.reset_graph_launch_counts()
    ops.reset_launch_counts()
    for images in (imgs, torch.from_numpy(imgs).to(cuda)):
        got = graphed.step(images)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
    assert torch.equal(graphed.step(imgs[:1]), want_one)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert graphed.graph_launch_counts() == {k: 3 * v for k, v in
                                             per_step.items()}
    assert bool((want != 0).any())


def test_graph_replay_order_and_returned_logits(cuda):
    """bucket 8 -> bucket 1 -> an eager step of the same tree -> bucket 8
    give the same logits each time, and two steps return tensors of their
    own: the second replay does not overwrite the first step's logits."""
    cfg = SpikformerConfig().scaled()
    model = firing_model(cfg, cuda, "packed_cuda", jit=True, buckets=(1, 8))
    rng = np.random.default_rng(6)
    a, b = (rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
            for _ in range(2))
    eager = lower(model.folded, cfg, model.backend, jit=False)
    first = model.step(a)
    one = model.step(a[:1])
    again = eager(model.folded, torch.from_numpy(a).to(cuda))
    last = model.step(a)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(last, again)
    assert torch.equal(one, eager(model.folded,
                                  torch.from_numpy(a[:1]).to(cuda)))
    other = model.step(b)
    torch.cuda.synchronize()
    assert other.data_ptr() != last.data_ptr()
    assert torch.equal(last, again)
    assert not torch.equal(other, last)
    assert torch.equal(model.logits(np.concatenate([a, b])),
                       torch.cat([again, other]))


class HostCopy:
    """A backend whose rate readout copies a Python number to the card each
    step: legal eagerly, refused inside a graph capture."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def rate(self, x, *, t):
        one = torch.tensor([1.0], device=x.device)
        return self.inner.rate(x, t=t) * one


def test_capture_that_meets_a_host_copy_raises(cuda):
    """The capture names the op that stopped it and raises; nothing runs
    eagerly in its place, and a second call raises again."""
    cfg = SpikformerConfig().scaled()
    model = firing_model(cfg, cuda, "packed_cuda", buckets=(4,))
    step = lower(model.folded, cfg, HostCopy(model.backend), jit=True)
    imgs = torch.zeros((4, 32, 32, 3), dtype=torch.uint8, device=cuda)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="graph capture") as err:
            step(model.folded, imgs)
        assert "in rate" in str(err.value)
        assert step.graphs == {}
    torch.cuda.synchronize()
    # the card is usable afterwards
    assert bool(torch.isfinite(model.step(imgs)).all())


# ---------------------------------------------------------------------------
# the LM engine under jit: decode as one CUDA graph, prefill one a length
# ---------------------------------------------------------------------------


def lm_engines(dev, cache_len):
    """A graphed and an eager engine on the reduced smollm config in bf16,
    two slots, one seeded set of weights."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine

    cfg = get_config("smollm-360m").reduced()
    graphed = Engine(cfg, slots=2, cache_len=cache_len, seed=3, device=dev)
    eager = Engine(cfg, slots=2, cache_len=cache_len, params=graphed.params,
                   device=dev, jit=False)
    return cfg, graphed, eager


def lm_prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n).tolist()


def serve_lm(eng, prompts, max_new):
    from repro_torch.launch.serve import Request

    eng.done = []
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=max_new))
    return [r.out for r in sorted(eng.run(), key=lambda r: r.rid)]


def same_caches(a, b, what):
    for tree in ("row", "pool"):
        for name, leaf in getattr(a, tree)["kv"].items():
            assert torch.equal(leaf, getattr(b, tree)["kv"][name]), (
                what, tree, name)


def test_lm_graphed_engine_serves_the_eager_tokens(cuda):
    """Prompts of 5, 77, 5 and 130 tokens through two slots: the third
    request waits for a slot and replays the 5-token graph, and the
    130-token one decodes past ``cache_len`` (136). Greedy tokens, row
    cache and slot pool equal the eager engine's bit for bit; one graph a
    prompt length and one for decode."""
    cfg, graphed, eager = lm_engines(cuda, cache_len=136)
    prompts = [lm_prompt(cfg, n, i) for i, n in enumerate((5, 77, 5, 130))]
    want = serve_lm(eager, prompts, 10)
    assert serve_lm(graphed, prompts, 10) == want
    torch.cuda.synchronize()
    same_caches(graphed, eager, "after serving")
    assert sorted(graphed.graphs) == [("decode", 2), ("prefill", 5),
                                      ("prefill", 77), ("prefill", 130)]
    assert graphed.graphs[("prefill", 5)].replays == 2
    assert eager.graphs == {}


def test_lm_graph_replay_order(cuda):
    """Prefill graph A, then B, then the decode graph over both rows, then
    A again: each returns the eager engine's token and leaves its caches
    bit for bit, although the four share one graph pool."""
    cfg, graphed, eager = lm_engines(cuda, cache_len=96)
    a, b = lm_prompt(cfg, 77, 1), lm_prompt(cfg, 30, 2)
    firsts = {}

    def prefill(slot, toks):
        def call(e):
            firsts[e] = e.prefill(toks)
            e._splice(slot)
            return firsts[e]
        return call

    steps = (("A", prefill(0, a)), ("B", prefill(1, b)),
             ("decode", lambda e: e.decode([firsts[e], 7], [77, 30])),
             ("A again", prefill(0, a)))
    for what, call in steps:
        assert call(graphed) == call(eager), what
        torch.cuda.synchronize()
        same_caches(graphed, eager, what)
    assert graphed.graphs[("prefill", 77)].replays == 2


def test_lm_graph_launches_equal_the_eager_counts(cuda):
    """Once every shape is captured, serving the same requests launches
    nothing eagerly, and captured launches times replays equal the eager
    engine's counts: one tensor-core flash launch a layer and prefill, none
    in decode."""
    cfg, graphed, eager = lm_engines(cuda, cache_len=96)
    prompts = [lm_prompt(cfg, n, i) for i, n in enumerate((5, 77, 30))]
    ops.reset_launch_counts()
    want = serve_lm(eager, prompts, 4)
    eager_counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert eager_counts == {"flash_attention_tc": 3 * cfg.n_layers}
    assert serve_lm(graphed, prompts, 4) == want          # captures
    assert graphed.graphs[("prefill", 77)].launches == {
        "flash_attention_tc": cfg.n_layers}
    assert graphed.graphs[("decode", 2)].launches == {}
    graphed.reset_graph_launch_counts()
    ops.reset_launch_counts()
    assert serve_lm(graphed, prompts, 4) == want          # replays only
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert graphed.graph_launch_counts() == eager_counts


def test_lm_capture_that_meets_a_host_read_raises(cuda):
    """A prefill body that reads a value back to the host: its capture
    raises and names the op, no graph is kept, nothing runs eagerly in its
    place, and a second call raises again; the same engine then captures
    its decode step (in a new pool: torch keeps the failed one marked as
    recording) and gives the eager engine's tokens."""
    from repro_torch.launch.serve import Engine

    class HostRead(Engine):
        def _prefill_body(self, tokens):
            out = super()._prefill_body(tokens)
            return out + int(tokens[0, 0])

    cfg, _, eager = lm_engines(cuda, cache_len=96)
    eng = HostRead(cfg, slots=2, cache_len=96, params=eager.params,
                   device=cuda)
    toks = lm_prompt(cfg, 30, 4)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="graph capture") as err:
            eng.prefill(toks)
        assert "in _prefill_body" in str(err.value)
        assert eng.graphs == {}
    torch.cuda.synchronize()
    assert eng.decode([5, 9], [0, 3]) == eager.decode([5, 9], [0, 3])
    assert sorted(eng.graphs) == [("decode", 2)]


# ---------------------------------------------------------------------------
# the SSM and hybrid engines under jit: per-layer ring caches, SSM states
# ---------------------------------------------------------------------------

SSM_ARCHS = {"hymba-1.5b": dict(n_layers=3), "mamba2-130m": {}}
# prompts of 5, 40 (past the reduced window of 32), 5 and 70 tokens; a
# cache of 80, as long as the longest request (a global layer's cache is
# linear and must hold its prompt), whose 32-slot rings decode wraps
SSM_PROMPTS, SSM_CACHE_LEN = (5, 40, 5, 70), 80


def ssm_engines(dev, arch):
    """A graphed and an eager engine on a reduced SSM or hybrid config in
    bf16, two slots, one seeded set of weights."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine

    cfg = get_config(arch).reduced(**SSM_ARCHS[arch])
    graphed = Engine(cfg, slots=2, cache_len=SSM_CACHE_LEN, seed=3,
                     device=dev)
    eager = Engine(cfg, slots=2, cache_len=SSM_CACHE_LEN,
                   params=graphed.params, device=dev, jit=False)
    return cfg, graphed, eager


def same_cache_leaves(a, b, what):
    from repro_torch.launch.serve import cache_leaves
    for tree in ("row", "pool"):
        pairs = zip(cache_leaves(getattr(a, tree)),
                    cache_leaves(getattr(b, tree)))
        for i, ((name, x), (_, y)) in enumerate(pairs):
            assert torch.equal(x, y), (what, tree, i, name)


@pytest.mark.parametrize("arch", sorted(SSM_ARCHS))
def test_ssm_graphed_engine_serves_the_eager_tokens(cuda, arch):
    """Prompts of 5, 40, 5 and 70 tokens through two slots, 10 new tokens
    each: the third request replays the 5-token graph, decode wraps the
    rings. Greedy tokens, row cache and slot pool (KV, ring KV,
    positions, SSM states, conv windows) equal the eager engine's bit for
    bit: the capture's warm-up run leaves no advanced state behind."""
    cfg, graphed, eager = ssm_engines(cuda, arch)
    prompts = [lm_prompt(cfg, n, i) for i, n in enumerate(SSM_PROMPTS)]
    want = serve_lm(eager, prompts, 10)
    assert serve_lm(graphed, prompts, 10) == want
    torch.cuda.synchronize()
    same_cache_leaves(graphed, eager, "after serving")
    assert sorted(graphed.graphs) == [("decode", 2), ("prefill", 5),
                                      ("prefill", 40), ("prefill", 70)]
    assert graphed.graphs[("prefill", 5)].replays == 2


@pytest.mark.parametrize("arch", sorted(SSM_ARCHS))
def test_ssm_graph_launches_equal_the_eager_counts(cuda, arch):
    """Captured launches times replays equal the eager engine's counts:
    kernel 7 once a layer for a prompt within the window, in the global
    layer only past it, never in decode or in an SSM layer."""
    cfg, graphed, eager = ssm_engines(cuda, arch)
    prompts = [lm_prompt(cfg, n, i) for i, n in enumerate(SSM_PROMPTS)]
    ops.reset_launch_counts()
    want = serve_lm(eager, prompts, 4)
    eager_counts = {k: v for k, v in ops.launch_counts().items() if v}
    if cfg.family == "ssm":
        flash = 0
    else:
        flash = sum(cfg.n_layers if n <= cfg.sliding_window
                    else len(cfg.global_layers) for n in SSM_PROMPTS)
    assert eager_counts == ({"flash_attention_tc": flash} if flash else {})
    assert serve_lm(graphed, prompts, 4) == want          # captures
    graphed.reset_graph_launch_counts()
    ops.reset_launch_counts()
    assert serve_lm(graphed, prompts, 4) == want          # replays only
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert graphed.graph_launch_counts() == eager_counts


def test_hybrid_f32_prefill_runs_the_flash_kernel_where_no_window_cuts(
        cuda):
    """Reduced hymba in f32 on the card: a 32-token prefill launches the
    f32 flash kernel in each of the 3 layers, a 40-token one in the
    global layer only; logits and the decode step after agree with the
    plain route within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.nn import transformer as T

    cfg = get_config("hymba-1.5b").reduced(n_layers=3)
    params = T.init_model(torch.Generator(device=cuda).manual_seed(0), cfg)
    for s, launches in ((32, 3), (40, 1)):
        toks = torch.randint(0, cfg.vocab, (2, s), generator=gen(cuda, s),
                             device=cuda)
        out = {}
        for flash in (True, False):
            ops.reset_launch_counts()
            cache = T.init_cache(cfg, 2, 64, dtype=torch.float32)
            pre, cache, _ = T.model_apply(
                params, {"tokens": toks, "cache_pos": 0}, cfg,
                mode="prefill", cache=cache, compute_dtype=torch.float32,
                flash=flash)
            dec, _, _ = T.model_apply(
                params, {"tokens": toks[:, :1],
                         "cache_pos": torch.tensor([s, s + 3], device=cuda)},
                cfg, mode="decode", cache=cache, compute_dtype=torch.float32,
                flash=flash)
            torch.cuda.synchronize()
            assert ops.launch_counts()["flash_attention_f32"] == (
                launches if flash else 0)
            out[flash] = (pre, dec)
        for got, want in zip(out[True], out[False]):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_fit_cuda_constants_on_the_card(cuda):
    """The card fit's samples are device times, positive, and its
    constants finite and positive, in the dot kernel's unit."""
    grid = tune.cuda_grid(SpikformerConfig().scaled(), batch=4)
    for dtype in ("int8", "float32"):
        samples = tune.measure_cuda_grid(grid, weight_dtype=dtype,
                                         repeats=2, inner=3)
        assert all(s["cuda_lut_s"] > 0 and s["cuda_dot_s"] > 0
                   for s in samples)
        fitted = tune.fit_cuda_constants(samples)
        assert fitted.pallas_dot_cost == 1.0
        for key in ("pallas_gather_cost", "transpose_cost"):
            v = getattr(fitted, key)
            assert np.isfinite(v) and v > 0, (dtype, key, v)


# ---------------------------------------------------------------------------
# serving threads: thread-backed replicas, each with graphs of its own
# ---------------------------------------------------------------------------

def test_two_replicas_replay_concurrently_bit_identical(cuda):
    """Two thread-backed replicas of one graphed model replay from two
    threads, each on a stream of its own, 50 steps of mixed buckets; every
    batch's logits equal a serial replay of the same batch on the template
    bit for bit, nothing launches eagerly, and each replica's replays count
    its captured launches once a step."""
    cfg = SpikformerConfig().scaled()
    model = firing_model(cfg, cuda, "packed_cuda", jit=True,
                         buckets=(1, 4, 8))
    reps = [replicate_model(model) for _ in range(2)]
    assert all(r.folded is model.folded for r in reps)
    for m in (model, *reps):
        m.warmup()
    rng = np.random.default_rng(9)
    sizes = [(1, 4, 8)[k % 3] for k in range(50)]
    batches = [[rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
                for b in sizes[i:] + sizes[:i]] for i in range(2)]
    want = [[model.step(x).cpu() for x in bs] for bs in batches]
    ops.reset_launch_counts()
    for r in reps:
        r.reset_graph_launch_counts()
    got, errors = [None, None], []
    barrier = threading.Barrier(2)

    def serve(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                barrier.wait(timeout=30)
                outs = [reps[i].step(x) for x in batches[i]]
                torch.cuda.current_stream().synchronize()
                got[i] = [o.cpu() for o in outs]
        except Exception as e:          # noqa: BLE001  (re-raised below)
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    for i in range(2):
        assert all(torch.equal(a, b) for a, b in zip(got[i], want[i])), i
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    per_bucket = model._fwd.graphs
    for r in reps:
        want_counts = {}
        for b in sizes:
            for k, v in per_bucket[b].launches.items():
                want_counts[k] = want_counts.get(k, 0) + v
        assert r.graph_launch_counts() == want_counts
    assert bool((want[0][2] != 0).any())


def test_fleet_swap_under_load_on_the_card(cuda):
    """A hot swap while requests arrive: zero failures, every accepted
    request resolves, the labels after the swap are the new model's, and
    every replica's graphed step then gives the new model's eager logits
    bit for bit."""
    cfg = SpikformerConfig().scaled()
    old = firing_model(cfg, cuda, "packed_cuda", jit=True, buckets=(1, 8))
    new = firing_model(cfg, cuda, "packed_cuda", seed=5, jit=True,
                       buckets=(1, 8))
    imgs = np.random.default_rng(10).integers(0, 256, (40, 32, 32, 3),
                                              dtype=np.uint8)
    batch = imgs[:8]
    during = []

    def feed(fleet):
        for i in range(20, 30, 2):
            during.append(fleet.submit(imgs[i:i + 2]))
            time.sleep(0.005)

    with ServeFleet(old, replicas=2,
                    policy=ServePolicy(max_wait_ms=2.0)) as fleet:
        before = [fleet.submit(imgs[i:i + 2]) for i in range(0, 20, 2)]
        feeder = threading.Thread(target=feed, args=(fleet,))
        feeder.start()
        fleet.swap(new, timeout=120)
        feeder.join(timeout=60)
        after = [fleet.submit(imgs[i:i + 2]) for i in range(30, 40, 2)]
        for h in before + during + after:
            assert len(h.result(timeout=60)) == 2
        eager = lower(new.folded, cfg, new.backend, jit=False)(
            new.folded, torch.from_numpy(batch).to(cuda))
        for rep in fleet.replicas:
            assert torch.equal(rep.model.step(batch), eager)
        stats, health = fleet.stats(), fleet.health()
    assert stats["requests_failed"] == 0 and stats["requests_rejected"] == 0
    assert stats["requests"] == 20
    assert [r["failures"] for r in health["replicas"]] == [0, 0]
    assert [r["swaps"] for r in health["replicas"]] == [1, 1]
    want = new.classify(imgs).tolist()
    assert [h.result() for h in after] == [want[i:i + 2]
                                           for i in range(30, 40, 2)]


def test_replaced_replicas_give_their_streams_back(cuda):
    """Each graphed replica captures on a borrowed stream that it holds
    alone and gives back when it dies, so a fleet that keeps replacing its
    replicas (a swap a round) reuses the streams and their cuBLAS
    workspaces: device memory after five rounds equals that after one."""
    import gc
    cfg = SpikformerConfig().scaled()
    model = firing_model(cfg, cuda, "packed_cuda", jit=True, buckets=(1, 4))
    model.warmup()
    imgs = np.zeros((4, 32, 32, 3), np.uint8)
    want = model.step(imgs)
    held = []
    for round_ in range(5):
        reps = [replicate_model(model) for _ in range(2)]
        for r in reps:
            r.warmup()
            assert torch.equal(r.step(imgs), want)
        streams = {r._fwd._stream for r in reps} | {model._fwd._stream}
        assert len(streams) == 3            # no two live steps share one
        del reps, r
        gc.collect()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert held[-1] == held[0], held


def test_graphed_default_f32_step_builds_no_split_per_call(cuda):
    """The reference's default plan (``packed``, f32) on the card, at a
    table cap that sends conv3 and every block linear to the f32 unpack
    dot: each such layer carries its ``kernel_bf16x3`` split and no other
    does; the graphed step replays the eager step's logits bit for bit,
    one unpack-dot launch a layer, and no split is built per call; the
    logits stay within atol 1e-3 + rtol 1e-3 of the plain route's (another
    summation order) with equal labels."""
    cfg = SpikformerConfig().scaled()
    graphed = firing_model(cfg, cuda, "packed", jit=True,
                           weight_dtype="float32")
    eager = firing_model(cfg, cuda, "packed", weight_dtype="float32")
    unpack = sorted(p for p, r in graphed.plan.routes.items()
                    if r == "unpack")
    split = []
    map_folded_layers(graphed.folded, lambda p, l: (
        split.append(p) if "kernel_bf16x3" in l else None) or l)
    assert sorted(split) == unpack and len(unpack) == 1 + 6 * cfg.depth
    imgs = np.random.default_rng(4).integers(0, 256, (4, 32, 32, 3),
                                             dtype=np.uint8)
    ops.reset_launch_counts()
    want = eager.step(imgs)
    torch.cuda.synchronize()
    assert ops.launch_counts()["unpack_dot"] == len(unpack)
    graphed.warmup()
    graphed.reset_graph_launch_counts()
    got = graphed.step(imgs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert graphed.graph_launch_counts()["unpack_dot"] == len(unpack)
    assert spike_matmul_grouped.split_builds == 0
    plain = firing_model(cfg, cuda, "packed_plain",
                         weight_dtype="float32").step(imgs)
    assert bool(((got - plain).abs() <= 1e-3 + 1e-3 * plain.abs()).all())
    assert torch.equal(got.argmax(-1), plain.argmax(-1))
    assert bool((got != 0).any())


def test_packed_on_the_card_launches_kernels_never_the_cpu_branch(
        cuda, monkeypatch):
    """``packed``, the reference's default, on the card runs exactly what
    ``packed_cuda`` runs: the same routes, launches and logits, with the
    CPU branch's route resolution and ops patched to raise. With
    ``pallas=False`` asked for, it runs the CPU branch on the card instead:
    no kernel launches, the CPU's labels."""
    def banned(*a, **kw):
        raise AssertionError("packed on the card reached the CPU branch")

    stdp = ops.stdp_attention_packed

    def stdp_on_kernels(*a, **kw):
        if kw.get("cpu_branch"):
            banned()
        return stdp(*a, **kw)

    cfg = SpikformerConfig().scaled()
    imgs = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (4, 32, 32, 3), dtype=np.uint8))
    for dtype in ("int8", "float32"):
        with monkeypatch.context() as mp:
            for name in ("_resolve_route", "_cpu_gather"):
                mp.setattr(ops, name, banned)
            mp.setattr(ops, "stdp_attention_packed", stdp_on_kernels)
            model = firing_model(cfg, cuda, "packed", weight_dtype=dtype)
            assert model.backend.name == "packed" and model.backend.pallas
            ops.reset_launch_counts()
            logits = model.step(imgs)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        ref_model = firing_model(cfg, cuda, "packed_cuda", weight_dtype=dtype)
        assert model.plan.routes == ref_model.plan.routes
        ops.reset_launch_counts()
        assert torch.equal(logits, ref_model.step(imgs))
        torch.cuda.synchronize()
        assert counts == ops.launch_counts() and sum(counts.values())
        plain = firing_model(cfg, cuda, "packed_plain", weight_dtype=dtype)
        assert torch.equal(logits, plain.step(imgs))
    branch = firing_model(cfg, cuda, "packed", weight_dtype="int8",
                          backend_options={"pallas": False})
    assert branch.backend.pallas is False
    ops.reset_launch_counts()
    on_card = branch.step(imgs)
    torch.cuda.synchronize()
    assert not any(ops.launch_counts().values())
    cpu = firing_model(cfg, "cpu", "packed", weight_dtype="int8")
    assert cpu.plan.routes == branch.plan.routes
    # int8 sums are exact on both devices; the head dot's order is not
    want = cpu.step(imgs)
    torch.testing.assert_close(on_card.cpu(), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(on_card.argmax(-1).cpu(), want.argmax(-1))


def test_event_session_labels_on_the_card_equal_packed_plain(cuda):
    """An ``EventStreamSession`` over the graphed ``packed`` model on the
    card (the event config, gained so that count frames fire: x4, x0.7
    more on wo/fc2, and x255 on conv0, whose fold scales 8-bit pixels by
    1/255 where a count frame holds counts): every window's label equals
    ``packed_plain``'s classify of the same count frame, and the labels
    are not all one class."""
    import dataclasses
    from repro_torch.events import (EventStreamSession, events_to_frame,
                                    flicker_burst_events, merge_streams,
                                    moving_edge_events)
    from repro_torch.serve import AsyncServeRuntime

    cfg = dataclasses.replace(SpikformerConfig().scaled(
        img_size=16, dim=32, depth=1), in_channels=2)
    folded = map_folded_layers(fold_inference_params(
        init(torch.Generator().manual_seed(0), cfg), cfg), lambda p, l: {
            **l, "kernel": l["kernel"] * 4.0 * (
                0.7 if p.endswith(("/wo", "/fc2")) else 1.0)
            * (255.0 if p == "scs/conv0" else 1.0)})
    plan = ExecutionPlan(backend="packed", batch_buckets=(1, 8))
    model = compile(folded, cfg, plan, folded=True, device=cuda)
    model.warmup()
    kw = dict(height=16, width=16, duration_us=400_000)
    stream = merge_streams(moving_edge_events(seed=0, **kw),
                           flicker_burst_events(seed=1, bursts=3, **kw))
    with AsyncServeRuntime(model, policy=ServePolicy(
            max_wait_ms=5.0, slo_ms=2_000.0)) as rt:
        session = EventStreamSession(rt, window_us=20_000, height=16,
                                     width=16, capture=True)
        session.feed(stream)
        session.close()
    got = [row["label"] for row in session.windows]
    frames = np.stack([events_to_frame(ev) for _, _, ev in session.captured])
    plain = compile(folded, cfg, dataclasses.replace(
        plan, backend="packed_plain"), folded=True, device=cuda, jit=False)
    assert got == plain.classify(frames).tolist()
    assert len(set(got)) > 1, "every window got one label"


def test_reduced_training_step_on_the_card_equals_the_cpu(cuda):
    """One reduced-config training step (surrogate-gradient BPTT, BN on
    batch statistics, AdamW, the BN stats merged) on the card against the
    same step on the CPU from the same params and batch: loss within rtol
    1e-5, each gradient leaf within 1e-4 of its largest |g|, the updated
    params within 1e-4, and no LIF spike flipped."""
    from repro_torch.core import spikformer as spik
    from repro_torch.core import ssa
    from repro_torch.data.pipeline import DataConfig, image_batch
    from repro_torch.infer.compile import to_device
    from repro_torch.optim import adamw

    cfg = SpikformerConfig().scaled(classes=4)
    raw = image_batch(DataConfig(global_batch=8,
                                 image_size=32, n_classes=4), 0)
    params = init(torch.Generator().manual_seed(0), cfg)
    ocfg = adamw.OptConfig(peak_lr=2e-3, warmup_steps=1, decay_steps=4)
    runs = {}
    for dev in ("cpu", cuda):
        lifs = []
        saved = [(m, m.tflif) for m in (spik, ssa)]
        for m, fn in saved:
            m.tflif = (lambda f: lambda y, **kw: lifs.append(f(y, **kw))
                       or lifs[-1])(fn)
        try:
            p = to_device(params, dev)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
            (loss, (_, stats)), grads = spik.value_and_grad(p, batch, cfg)
        finally:
            for m, fn in saved:
                m.tflif = fn
        new, _, _ = adamw.update(grads, adamw.init(p, ocfg), p, ocfg)
        new = spik.merge_bn_stats(new, stats)
        runs[str(dev)] = (float(loss), grads, new,
                          [s.detach().cpu() for s in lifs])
    (l0, g0, p0, s0), (l1, g1, p1, s1) = runs["cpu"], runs["cuda"]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    assert [int((a != b).sum()) for a, b in zip(s1, s0)] == [0] * len(s0)

    def leaves(t, pre=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, f"{pre}/{k}")
        else:
            yield pre, t

    want_g, want_p = dict(leaves(g0)), dict(leaves(p0))
    for k, g in leaves(g1):
        scale = float(want_g[k].abs().max())
        assert float((g.cpu() - want_g[k]).abs().max()) <= 1e-4 * max(
            scale, 1e-30), k
    for k, v in leaves(p1):
        torch.testing.assert_close(v.cpu(), want_p[k], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# LM training
# ---------------------------------------------------------------------------

LM_TRAIN_FAMILIES = {"smollm-360m": {}, "qwen3-moe-30b-a3b": {},
                     "mamba2-130m": {}, "hymba-1.5b": {"n_layers": 3},
                     "whisper-large-v3": {}, "qwen2-vl-7b": {}}


def _stub_inputs(cfg, b, s):
    """Seeded frames (encdec) or image embeddings and distinct M-RoPE
    streams (vlm), bf16 embeddings, on the CPU."""
    g = torch.Generator().manual_seed(2)
    if cfg.family == "encdec":
        return {"frames": torch.randn((b, cfg.n_frames, cfg.d_model),
                                      generator=g).bfloat16()}
    if cfg.family == "vlm":
        return {"image_embeds": torch.randn((b, cfg.img_tokens, cfg.d_model),
                                            generator=g).bfloat16(),
                "mrope_positions": torch.randint(0, 2 * s, (3, b, s),
                                                 generator=g)}
    return {}


def _lm_grads(params, batch, cfg):
    from repro_torch.nn import module
    from repro_torch.nn import transformer as T
    leaves = {p: t.detach().requires_grad_()
              for p, t in module.tree_paths(params)}
    loss, _ = T.lm_loss(module.map_with_path(lambda p, _: leaves[p], params),
                        batch, cfg, flash=False)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), {p: torch.zeros_like(t) if g is None else g
                           for (p, t), g in zip(leaves.items(), grads)}


@pytest.mark.parametrize("arch", sorted(LM_TRAIN_FAMILIES))
def test_lm_reduced_train_step_on_the_card_equals_the_cpu(cuda, arch):
    """Each ported family's reduced config in f32 compute, one seeded CPU
    tree and one synthetic batch: ``lm_loss`` and every gradient leaf on
    the card against the CPU (loss within rtol 1e-5, each leaf within
    1e-4 of its largest |g|), then one microbatched ``make_train_step``
    (the updated params within 1e-4)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batch
    from repro_torch.infer.compile import to_device
    from repro_torch.launch import steps
    from repro_torch.nn import module
    from repro_torch.nn import transformer as T
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(
        get_config(arch).reduced(**LM_TRAIN_FAMILIES[arch]),
        compute_dtype="float32")
    params = T.init_model(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    raw = synthetic_lm_batch(DataConfig(seq=64, global_batch=4,
                                        vocab=cfg.padded_vocab), 0)
    raw = {k: torch.from_numpy(v) for k, v in raw.items()}
    raw.update(_stub_inputs(cfg, 4, 64))
    ts = steps.TrainSettings(microbatch=2, opt=adamw.OptConfig(
        peak_lr=3e-4, warmup_steps=1, decay_steps=4))
    runs = {}
    for dev in ("cpu", cuda):
        p = to_device(params, dev)
        batch = {k: v.to(dev) for k, v in raw.items()}
        loss, grads = _lm_grads(p, batch, cfg)
        new, _, _ = steps.make_train_step(cfg, ts)(
            p, adamw.init(p, steps.opt_config(cfg, ts)), batch)
        runs[str(dev)] = (float(loss), grads, dict(module.tree_paths(new)))
    (l0, g0, p0), (l1, g1, p1) = runs["cpu"], runs["cuda"]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    for k, g in g1.items():
        scale = float(g0[k].abs().max())
        assert float((g.cpu() - g0[k]).abs().max()) <= 1e-4 * max(
            scale, 1e-30), k
    for k, v in p1.items():
        torch.testing.assert_close(v.cpu(), p0[k], rtol=1e-4, atol=1e-4)
    assert ops.launch_counts()["flash_attention_tc"] == 0
    assert ops.launch_counts()["flash_attention_f32"] == 0


def test_lm_attention_gradients_are_nonzero_on_the_card(cuda):
    """Reduced smollm in bf16 compute on the card: the gradients of
    ``wq``, ``wk`` and ``wv`` are nonzero in the first and the last layer
    (no attention output comes from a kernel autograd cannot see), and
    the flash kernel refuses operands that require grad."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batch
    from repro_torch.nn import transformer as T

    cfg = get_config("smollm-360m").reduced()
    params = T.init_model(torch.Generator(device=cuda).manual_seed(0), cfg,
                          device=cuda)
    raw = synthetic_lm_batch(DataConfig(seq=128, global_batch=2,
                                        vocab=cfg.padded_vocab), 0)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in raw.items()}
    _, grads = _lm_grads(params, batch, cfg)
    for w in ("wq", "wk", "wv"):
        g = grads[f"layers/attn/{w}/kernel"]
        for i in (0, cfg.n_layers - 1):
            assert float(g[i].norm()) > 0, (w, i)
    q = torch.randn(1, 4, 64, 32, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(1, 2, 64, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, k, scale=32 ** -0.5)
    with torch.no_grad():
        ops.flash_attention(q, k, k, scale=32 ** -0.5)
    assert ops.launch_counts()["flash_attention_tc"] == 1


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_ef_compress_on_the_card_is_the_cpu_s_bits(cuda, method):
    from repro_torch.optim.compression import ef_compress, ef_init
    g = torch.Generator().manual_seed(3)
    grads = {"w": torch.randn(512, 960, generator=g),
             "b": torch.randn(960, generator=g).bfloat16()}
    grads["w"][7, :50] = grads["w"][0, 0]          # ties at the threshold
    out = {}
    for dev in ("cpu", cuda):
        gd = {k: v.to(dev) for k, v in grads.items()}
        ef = ef_init(gd)
        for _ in range(2):
            deq, ef = ef_compress(gd, ef, method=method)
        out[str(dev)] = (deq, ef)
    for a, b in zip(out["cpu"], out["cuda"]):
        for k in a:
            assert torch.equal(a[k], b[k].cpu()), k


def test_pipeline_and_checkpoint_on_the_card(cuda, tmp_path):
    """The pipeline's batches reach the card from pinned memory equal to
    the host's; a tree on the card (f32, bf16, int32 leaves) saved and
    restored onto the card is the same bits."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import (DataConfig, DataPipeline,
                                           synthetic_lm_batch)
    cfg = DataConfig(seq=64, global_batch=4, vocab=1000, seed=2)
    pipe = DataPipeline(cfg, device=cuda)
    try:
        for step in range(3):
            got = next(pipe)
            want = synthetic_lm_batch(cfg, step)
            for k, v in want.items():
                assert got[k].device.type == "cuda"
                assert np.array_equal(got[k].cpu().numpy(), v)
    finally:
        pipe.close()
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn(33, 17, generator=g, device=cuda),
            "h": torch.randn(9, generator=g, device=cuda).bfloat16(),
            "step": torch.tensor(5, dtype=torch.int32, device=cuda)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree, block=True)
    got, _ = ck.restore(skeleton=tree, device=cuda)
    for k, v in tree.items():
        assert got[k].device.type == "cuda" and got[k].dtype == v.dtype
        assert torch.equal(got[k], v), k



# ---------------------------------------------------------------------------
# the sharding layer on a one-card mesh
# ---------------------------------------------------------------------------

SHARDED_REDUCED = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                       vocab=512)


@pytest.fixture
def nccl_mesh(cuda):
    """``make_cpu_mesh`` on the card: a one-rank NCCL group (HashStore, no
    port) and its (1, 1) mesh, destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_cpu_mesh
    assert not dist.is_initialized()
    mesh = make_cpu_mesh(device=cuda)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen1.5-110b"])
def test_sharded_train_step_on_one_card_is_the_unsharded_step(
        cuda, nccl_mesh, arch):
    """``jit_train_step`` on the (1, 1) NCCL mesh against
    ``make_train_step`` from the same params (reduced: 2 layers, d_model
    128, 4 heads over 2), two steps of batch 8 x 32 in microbatches of 4:
    metrics and every param and moment bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.nn import module
    from repro_torch.nn import transformer as T
    from repro_torch.optim import adamw
    cfg = get_config(arch).reduced(**SHARDED_REDUCED)
    ts = steps.TrainSettings(microbatch=4)
    params = T.init_model(gen(cuda, 0), cfg, device=cuda)
    opt = adamw.init(params, steps.opt_config(cfg, ts))
    g = gen(cuda, 1)
    batches = [{k: torch.randint(0, cfg.vocab, (8, 32), generator=g,
                                 device=cuda) for k in ("tokens", "labels")}
               for _ in range(2)]
    shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in batches[0].items()}
    step, _, _ = steps.jit_train_step(cfg, nccl_mesh, ts, shapes)
    plain = steps.make_train_step(cfg, ts)
    p1, o1, p2, o2 = params, opt, params, opt
    for b in batches:
        p1, o1, m1 = plain(p1, o1, b)
        p2, o2, m2 = step(p2, o2, b)
        for k in m1:
            assert torch.equal(m1[k], m2[k].full_tensor()), k
    want = dict(module.tree_paths({"p": p1, "o": o1}))
    got = dict(module.tree_paths({"p": p2, "o": o2}))
    assert list(got) == list(want)
    for k, t in want.items():
        assert torch.equal(t, got[k].to_local()), k


def test_sharded_prefill_and_decode_on_one_card_are_the_unsharded_steps(
        cuda, nccl_mesh):
    """Reduced qwen1.5-110b (bf16 params, QKV bias): ``jit_prefill`` of 2
    rows of 64 tokens into a cache of 72, then 8 ``jit_serve_step``s,
    against ``make_prefill`` / ``make_serve_step``: the greedy tokens and
    every cache leaf bit for bit; the sharded prefill launches kernel 7
    once a layer (under ``local_map``), a decode step never."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.nn import module
    from repro_torch.nn import transformer as T
    cfg = get_config("qwen1.5-110b").reduced(**SHARDED_REDUCED)
    params = T.init_model(gen(cuda, 2), cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=gen(cuda, 3),
                         device=cuda)
    meta = {"tokens": torch.empty((2, 64), dtype=torch.int64,
                                  device="meta")}
    prefill, _, _ = steps.jit_prefill(cfg, nccl_mesh, meta, cache_len=72)
    serve, _, _ = steps.jit_serve_step(
        cfg, nccl_mesh, T.init_cache(cfg, 2, 72, device="meta"),
        {"tokens": torch.empty((2, 1), dtype=torch.int64, device="meta"),
         "cache_pos": torch.empty((), dtype=torch.int32, device="meta")})

    def run(pre, step):
        with torch.no_grad():
            ops.reset_launch_counts()
            logits, cache = pre(params, {"tokens": toks})
            launches = [flash_attention_tc.launches]
            tok = torch.argmax(getattr(logits, "full_tensor", lambda: logits)()
                               [:, -1], dim=-1)
            out = [tok]
            for i in range(8):
                ops.reset_launch_counts()
                tok, cache = step(params, cache, {"tokens": out[-1][:, None],
                                                  "cache_pos": 64 + i})
                launches.append(ops.launch_counts()["flash_attention_tc"])
                out.append(getattr(tok, "full_tensor", lambda: tok)().long())
        return torch.stack(out, 1), cache, launches

    want, wc, wl = run(steps.make_prefill(cfg, cache_len=72),
                       steps.make_serve_step(cfg))
    got, gc, gl = run(prefill, serve)
    assert torch.equal(got, want)
    assert wl == gl == [cfg.n_layers] + [0] * 8
    for (p, a), (_, b) in zip(module.tree_paths(gc), module.tree_paths(wc)):
        assert torch.equal(a.to_local(), b), p


def test_compressed_psum_int8_over_nccl(cuda, nccl_mesh):
    """At world size 1 the int8 payload's mean is the reference's formula,
    quantise and then dequantise, bit for bit, over either mesh axis."""
    from repro_torch.optim.compression import compressed_psum_int8
    from repro_torch.sharding import set_mesh
    x = torch.randn((1000,), generator=gen(cuda, 4), device=cuda) * 5
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    want = torch.clamp(torch.round(x / scale), -127, 127) * scale
    with set_mesh(nccl_mesh):
        for axis in ("data", "model"):
            assert torch.equal(compressed_psum_int8(x, axis), want), axis
    assert torch.equal(compressed_psum_int8(x, nccl_mesh["model"]), want)


@pytest.mark.parametrize("case", ["linear", "ring", "past_end", "several"])
def test_sharded_per_row_write_on_one_card_is_the_plain_write(
        cuda, nccl_mesh, case):
    """``cache_update`` of a cache placed by ``cache_shardings`` on the
    (1, 1) NCCL mesh, each row at its own position (a (B,) tensor on the
    card): every leaf equals the plain write's bit for bit; one token a
    row (the decode's form, no host read) in a linear cache, a wrapped
    16-slot ring and past a linear cache's end, and several a row."""
    from repro_torch.nn import attention as attn
    from repro_torch.sharding import rules, set_mesh
    ring = case == "ring"
    s_new = 3 if case == "several" else 1
    pos = {"linear": [3, 15, 0, 8], "ring": [17, 3, 31, 48],
           "past_end": [16, 5, 19, 15], "several": [2, 9, 12, 0]}[case]
    base = {"k": torch.randn((4, 2, 16, 8), generator=gen(cuda, 5),
                             device=cuda),
            "v": torch.randn((4, 2, 16, 8), generator=gen(cuda, 6),
                             device=cuda),
            "positions": torch.randint(-1, 40, (4, 16), generator=gen(cuda, 7),
                                       device=cuda, dtype=torch.int32)}
    k_new, v_new = (torch.randn((4, 2, s_new, 8), generator=gen(cuda, s),
                                device=cuda) for s in (8, 9))
    p = torch.tensor(pos, device=cuda)
    want = attn.cache_update({k: t.clone() for k, t in base.items()},
                             k_new, v_new, p, ring=ring)
    placed = rules.place_tree({k: t.clone() for k, t in base.items()},
                              rules.cache_shardings(nccl_mesh,
                                                    {"kv": base})["kv"])
    with set_mesh(nccl_mesh):
        got = attn.cache_update(placed, k_new, v_new, p, ring=ring)
    for k in want:
        assert torch.equal(got[k].to_local(), want[k]), k


def test_sharded_engine_on_one_card_serves_the_unsharded_tokens(
        cuda, nccl_mesh):
    """Reduced qwen1.5-110b (bf16 params, QKV bias), ``Engine(slots=2)``
    graphed, unsharded and with ``mesh=`` the (1, 1) NCCL mesh on the same
    params (kept, not copied): five prompts of 5-70 tokens over two slots,
    6 new tokens each, so slots are spliced mid-run at other positions:
    the tokens equal, and the sharded engine captured its decode and its
    prefills as graphs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine
    from repro_torch.nn import module
    cfg = get_config("qwen1.5-110b").reduced(**SHARDED_REDUCED)
    plain = Engine(cfg, slots=2, cache_len=80, seed=4, device=cuda)
    sharded = Engine(cfg, slots=2, cache_len=80, params=plain.params,
                     device=cuda, mesh=nccl_mesh)
    assert all(a.to_local().data_ptr() == b.data_ptr() for (_, a), (_, b) in
               zip(module.tree_paths(sharded.params),
                   module.tree_paths(plain.params)))
    prompts = [lm_prompt(cfg, n, 30 + n) for n in (5, 40, 9, 70, 13)]
    want = serve_lm(plain, prompts, 6)
    got = serve_lm(sharded, prompts, 6)
    assert got == want
    assert sharded.graphed and ("decode", 2) in sharded.graphs
    assert sum(1 for k in sharded.graphs if k[0] == "prefill") == 5
