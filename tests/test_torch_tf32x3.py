"""The split-TF32 ("3xTF32") arithmetic of ``csrc/stdp.cu`` and
``csrc/flash_attention.cu``, emulated in plain torch on the CPU and held to
the reference.

The kernels hold an f32 x as big + small: big = rna(x), x rounded to
nearest with ties away from zero to tf32's 10 mantissa bits, and small =
rna(x - big). A product a b is big_a big_b, summed in one f32 accumulator,
plus big_a small_b + small_a big_b, summed in a second, the two added when
the sums are done (``csrc/tf32x3.cuh``). The emulation below does the same
with f32 matmuls: STDP as S = Q K^T in three products, S split, O = S V in
three products, times the scale; flash attention as the kernel's KV tiles
(64 keys, or 32 from Dh 129 to 256) with the reference's online softmax, s from
the split ``q * scale``
and k, P V from the split p and v, the two P V sums rescaled apart. Inputs
come from seeded numpy.

Tolerances:
- STDP, real values: ``|got - want| <= STDP_F32_TOL * (|Q| |K|^T) |V| *
  scale`` elementwise (``stdp_attention.STDP_F32_TOL`` = 2^-20). The
  product of absolute values bounds the error of the sums in any f32
  order, each rounding being relative to the terms it adds; the split
  keeps each product within ~2^-21 of the f32 one. The card's kernel
  measured 1.3e-7 to 1.9e-7 of the bound on an H100; one unsplit TF32
  product a step (2^-12 a factor) misses it.
- STDP, spikes: bit for bit. small is 0, every score and sum an integer
  below 2^24 and the scale a power of two.
- Flash attention: atol = rtol = 2e-4, the reference's own flash tests'
  and the kernel's gate on the card. One unsplit TF32 product a step
  misses it.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.stdp_attention import STDP_F32_TOL
from torch_threads import one_thread  # noqa: F401  (autouse)

FLASH_TOL = 2e-4
NEG_INF = -1e30


def rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 as the kernels' operands are: half a tf32 ulp
    added to the bits, the 13 low bits cleared."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = rna(x)
    return big, rna(x - big)


def dot3(a, b):
    """a @ b as the kernels take it: big big in one f32 sum, big small +
    small big in a second, added last."""
    ab, asm = split(a)
    bb, bsm = split(b)
    return ab @ bb + (ab @ bsm + asm @ bb)


def dot1(a, b):
    """One unsplit TF32 product a step: what the split is there for."""
    return rna(a) @ rna(b)


def stdp_emulated(q, k, v, *, scale, dot=dot3):
    return dot(dot(q, k.mT), v) * scale


def flash_emulated(q, k, v, *, scale, causal, split_p=True, bkv=64):
    """The f32 flash kernel's arithmetic on (BH, Nq, Dh) over (BH, Nkv,
    Dh): ascending tiles of ``bkv`` keys, the reference's online-softmax
    update (NEG_INF = -1e30, exp, max(l, 1e-30)); ``split_p=False`` takes
    one unsplit TF32 product a step in both dots."""
    dot = dot3 if split_p else dot1
    qs = q * scale
    bh, nq, dh = q.shape
    nkv = k.shape[1]
    qpos = (nkv - nq) + torch.arange(nq)[:, None]
    m = torch.full((bh, nq, 1), NEG_INF)
    l = torch.zeros((bh, nq, 1))
    acc_hi = torch.zeros((bh, nq, dh))
    acc_lo = torch.zeros((bh, nq, dh))
    for k0 in range(0, nkv, bkv):
        kt, vt = k[:, k0:k0 + bkv], v[:, k0:k0 + bkv]
        s = dot(qs, kt.mT)
        if causal:
            kpos = k0 + torch.arange(kt.shape[1])[None, :]
            s = torch.where(qpos >= kpos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if split_p:
            pb, ps = split(p)
            vb, vs = split(vt)
            acc_hi = acc_hi * alpha + pb @ vb
            acc_lo = acc_lo * alpha + (pb @ vs + ps @ vb)
        else:
            acc_hi = acc_hi * alpha + dot1(p, vt)
        m = m_new
    return (acc_hi + acc_lo) / torch.clamp(l, min=1e-30)


def normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t_(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def stdp_bound(q, k, v, scale):
    return STDP_F32_TOL * ref.stdp_attention_ref(q.abs(), k.abs(), v.abs(),
                                                 scale=scale)


def test_rna_rounds_to_nearest_ties_away():
    """rna against rounding to 11 significant bits in f64, ties away from
    zero, over seeded values from 2^-100 to 2^100 of both signs and the
    exact ties; big + small is within 2^-22 |x| of x, and both have at most
    11 significant bits."""
    r = np.random.default_rng(0)
    x = (r.uniform(1, 2, 20000) * 2.0 ** r.integers(-100, 100, 20000)
         * r.choice([-1, 1], 20000)).astype(np.float32)
    ties = ((np.arange(1, 2001, dtype=np.float32) * 2 + 1) * 2.0 ** -13
            ).astype(np.float32) * r.choice([-1, 1], 2000).astype(np.float32)
    x = np.concatenate([x, ties, np.float32([0.0, -0.0, 1.0, 2048.0])])
    mant, exp = np.frexp(x.astype(np.float64))
    scaled = np.abs(mant) * 2.0 ** 11
    want = np.sign(mant) * np.floor(scaled + 0.5) * 2.0 ** (exp - 11)
    big, small = split(torch.from_numpy(x))
    np.testing.assert_array_equal(big.numpy().astype(np.float64), want)
    for z in (big, small):
        m11 = np.frexp(z.numpy().astype(np.float64))[0] * 2.0 ** 11
        np.testing.assert_array_equal(m11, np.round(m11))
    err = np.abs((big.double() + small.double()).numpy() - x)
    assert (err <= 2.0 ** -22 * np.abs(x)).all()


def test_spikes_split_to_themselves():
    """{0,1} and every integer up to 2048 is its own big; small is 0."""
    x = torch.arange(0, 2049, dtype=torch.float32)
    big, small = split(x)
    assert torch.equal(big, x) and torch.equal(small, torch.zeros_like(x))


@pytest.mark.parametrize("n", [1, 65, 100, 196])
@pytest.mark.parametrize("dh", [7, 32, 64, 128])
def test_stdp_scheme_on_real_values(n, dh):
    """Within ``STDP_F32_TOL`` of the reference's ``stdp_attention_ref``
    (f32 on XLA's CPU) and the port's, scaled by (|Q| |K|^T) |V| * scale;
    one unsplit TF32 product a step misses it."""
    q, k, v = (normal(10 * n + dh + i, 2, n, dh) for i in range(3))
    tq, tk, tv = t_(q, k, v)
    got = stdp_emulated(tq, tk, tv, scale=0.125)
    bound = stdp_bound(tq, tk, tv, 0.125)
    for want in (torch.from_numpy(np.array(jref.stdp_attention_ref(
            q, k, v, scale=0.125))),
                 ref.stdp_attention_ref(tq, tk, tv, scale=0.125)):
        assert bool(((got - want).abs() <= bound).all())
    rough = stdp_emulated(tq, tk, tv, scale=0.125, dot=dot1)
    assert not bool(((rough - want).abs() <= bound).all())


@pytest.mark.parametrize("n", [1, 65, 100, 196])
@pytest.mark.parametrize("dh", [7, 32, 64, 128])
def test_stdp_scheme_on_spikes_is_exact(n, dh):
    r = np.random.default_rng(n * dh)
    q, k, v = ((r.random((3, n, dh)) < 0.3).astype(np.float32)
               for _ in range(3))
    got = stdp_emulated(*t_(q, k, v), scale=0.125)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.stdp_attention_ref(q, k, v, scale=0.125)))
    assert float(got.abs().max()) > 0


@pytest.mark.parametrize("nq,nkv,causal", [(1, 1, True), (65, 65, True),
                                           (100, 100, True), (196, 196, True),
                                           (1, 196, True), (65, 100, False),
                                           (196, 65, False)])
@pytest.mark.parametrize("dh", [32, 64, 128, 160])
def test_flash_scheme_holds_the_flash_tolerance(nq, nkv, causal, dh):
    """Within atol = rtol = 2e-4 of the reference's exact softmax
    (``flash_attention_ref``) and the port's, on the kernel's head dims."""
    q, k, v = normal(nq + dh, 3, nq, dh), *(normal(nkv + dh + i, 3, nkv, dh)
                                            for i in (1, 2))
    got = flash_emulated(*t_(q, k, v), scale=dh ** -0.5, causal=causal)
    for want in (np.asarray(jref.flash_attention_ref(
            q, k, v, scale=dh ** -0.5, causal=causal)),
                 ref.flash_attention_ref(*t_(q, k, v), scale=dh ** -0.5,
                                         causal=causal).numpy()):
        np.testing.assert_allclose(got.numpy(), want, atol=FLASH_TOL,
                                   rtol=FLASH_TOL)


@pytest.mark.parametrize("nq,nkv,causal", [(65, 65, True), (196, 196, True),
                                           (1, 196, True), (196, 65, False)])
@pytest.mark.parametrize("dh,bkv", [(96, 64), (128, 64), (160, 32),
                                    (224, 32), (256, 32), (512, 64),
                                    (576, 64)])
def test_wide_flash_scheme_holds_the_flash_tolerance(nq, nkv, causal, dh,
                                                     bkv):
    """Past Dh 64 the f32 kernel takes KV tiles of 64 keys up to Dh 128, of
    32 up to 256 (``Wide`` in ``csrc/flash_attention.cu``) and of 64 past
    it (``Sliced``: a block's column slice sums S over every box of Dh in
    the same ascending k-steps): the same scheme at those tiles, at
    phi-3-mini's, glm4's, stablelm-12b's, Qwen3-Next's, DeepSeek-V4's and
    sarvam-105b's head dims and 224, within atol = rtol = 2e-4 of both
    references."""
    q, k, v = normal(nq + dh, 2, nq, dh), *(normal(nkv + dh + i, 2, nkv, dh)
                                            for i in (1, 2))
    got = flash_emulated(*t_(q, k, v), scale=dh ** -0.5, causal=causal,
                         bkv=bkv)
    for want in (np.asarray(jref.flash_attention_ref(
            q, k, v, scale=dh ** -0.5, causal=causal)),
                 ref.flash_attention_ref(*t_(q, k, v), scale=dh ** -0.5,
                                         causal=causal).numpy()):
        np.testing.assert_allclose(got.numpy(), want, atol=FLASH_TOL,
                                   rtol=FLASH_TOL)


def test_unsplit_products_break_the_flash_tolerance():
    """Why both dots are split: one TF32 product a step (2^-12 of each
    factor) moves s by ~1e-3 where |s| ~ 4 and misses 2e-4."""
    q, k, v = t_(*(normal(300 + i, 3, 200, 64) for i in range(3)))
    want = ref.flash_attention_ref(q, k, v, scale=0.125)
    rough = flash_emulated(q, k, v, scale=0.125, causal=True, split_p=False)
    excess = (rough - want).abs() - (FLASH_TOL + FLASH_TOL * want.abs())
    assert float(excess.max()) > 0
    got = flash_emulated(q, k, v, scale=0.125, causal=True)
    excess = (got - want).abs() - (FLASH_TOL + FLASH_TOL * want.abs())
    assert float(excess.max()) <= 0
