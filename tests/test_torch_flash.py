"""Kernel 7, flash attention: the port's wrapper on CPU operands (its plain
version, the exact softmax of ``flash_attention_ref``) against the JAX
Pallas kernel in interpret mode and against the reference's
``flash_attention_ref``, on seeded numpy inputs; grouped-query heads and
strided views against the expanded call; and a plain emulation of the bf16
tensor-core kernel's numeric scheme. The CUDA kernels themselves are held
to the same plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``).

Tolerance: atol = rtol = 2e-4, the reference's own flash tests'. The
online softmax (the Pallas kernel) and the exact one differ only in the
order of f32 sums; the largest difference seen is below 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ref import flash_attention_ref as jref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as flash_kernels_module
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_f32,
                                                 flash_attention_tc)
from repro_torch.kernels.ref import flash_attention_ref
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 2e-4


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def qkv(seed, bh, nq, nkv, dh):
    r = np.random.default_rng(seed)
    return (r.normal(size=(bh, nq, dh)).astype(np.float32),
            r.normal(size=(bh, nkv, dh)).astype(np.float32),
            r.normal(size=(bh, nkv, dh)).astype(np.float32))


def t_(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dh", [32, 64, 96, 160])
@pytest.mark.parametrize("nq,nkv", [(128, 128), (64, 256), (1, 512),
                                    (200, 200), (100, 333)])
def test_plain_flash_matches_pallas_interpret_and_ref(nq, nkv, dh):
    """Causal, query i at position nkv - nq + i: square, decode-like (one
    query over 512 keys), prefill against a longer cache, and lengths that
    are not multiples of the 128-row tiles (both sides pad); at head dims
    of the kernels (stablelm-12b's 160 among them) and one that is not a
    multiple of 64 (96)."""
    q, k, v = qkv(nq * 1000 + nkv + dh, 3, nq, nkv, dh)
    scale = dh ** -0.5
    got = flash_attention(*t_(q, k, v), scale=scale)
    assert got.dtype == torch.float32 and got.shape == (3, nq, dh)
    close(got, jflash(q, k, v, scale=scale, interpret=True))
    close(got, jref(q, k, v, scale=scale))
    close(ops.flash_attention(*t_(q, k, v), scale=scale), got)
    close(ops.flash_attention(*t_(q, k, v), scale=scale, plain=True),
          jops.flash_attention(q, k, v, scale=scale, pallas=False))


@pytest.mark.parametrize("nq,nkv", [(128, 256), (100, 333), (77, 40)])
def test_non_causal_masks_padded_keys(nq, nkv):
    """Non-causal: every real key counts and no padded one. The reference's
    Pallas wrapper refuses KV padding here (``NotImplementedError``); the
    port's kernel masks keys past Nkv and is held to
    ``flash_attention_ref``, and to the Pallas kernel where it runs."""
    q, k, v = qkv(nq + nkv, 2, nq, nkv, 64)
    got = flash_attention(*t_(q, k, v), scale=0.125, causal=False)
    close(got, jref(q, k, v, scale=0.125, causal=False))
    if nkv % min(128, nkv):
        with pytest.raises(NotImplementedError):
            jflash(q, k, v, scale=0.125, causal=False, interpret=True)
    else:
        close(got, jflash(q, k, v, scale=0.125, causal=False,
                          interpret=True))


@pytest.mark.parametrize("dh", [96, 160])
@pytest.mark.parametrize("nq,nkv", [(128, 256), (100, 333), (77, 40)])
def test_non_causal_masks_padded_keys_at_wide_heads(nq, nkv, dh):
    """``test_non_causal_masks_padded_keys`` at Dh 96 and 160: the plain
    version against ``flash_attention_ref``, and against the Pallas kernel
    where its wrapper takes the padding."""
    q, k, v = qkv(nq + nkv + dh, 2, nq, nkv, dh)
    scale = dh ** -0.5
    got = flash_attention(*t_(q, k, v), scale=scale, causal=False)
    assert got.shape == (2, nq, dh)
    close(got, jref(q, k, v, scale=scale, causal=False))
    if nkv % min(128, nkv) == 0:
        close(got, jflash(q, k, v, scale=scale, causal=False,
                          interpret=True))


# what each kernel takes on the card: (dtype, Dh, the Dh the launcher
# gets, or None where the wrapper refuses): every Dh from 1 up, past 256
# (DeepSeek-V4's 512, sarvam-105b's 576) too; a Dh TMA cannot read row by
# row (not a multiple of 8 bf16 or 4 f32 values) is zero-padded to one
HEAD_DIM_CASES = [(torch.bfloat16, dh, dh + -dh % 8)
                  for dh in (4, 8, 12, 32, 96, 160, 192, 200, 256, 264, 300,
                             512, 576, 1024)]
HEAD_DIM_CASES += [(torch.float32, dh, dh + -dh % 4)
                   for dh in (1, 32, 48, 60, 64, 96, 102, 128, 160, 192, 256,
                              264, 298, 512, 576, 1024)]
HEAD_DIM_CASES += [(dtype, 0, None) for dtype in (torch.bfloat16,
                                                  torch.float32)]


@pytest.mark.parametrize("dtype,dh,launched", HEAD_DIM_CASES)
def test_card_dispatch_by_head_dim(monkeypatch, dtype, dh, launched):
    """On card operands (``_build.on_cpu`` patched to say so; the launcher
    replaced by a recorder) every head dim from 1 up goes to the dtype's
    kernel in one launch, with Dh as given or zero-padded to whole 16-byte
    rows (q, k and v alike), the output cut back to q's shape; an empty
    head dim raises ``ValueError``, with no launch and no fallback to the
    plain version."""
    calls = []

    def kernel_function(name, symbol, argtypes):
        return lambda *args: calls.append((name, args)) or 0
    monkeypatch.setattr(_build, "on_cpu", lambda *z: False)
    monkeypatch.setattr(_build, "kernel_function", kernel_function)
    monkeypatch.setattr(_build, "stream", lambda z: 0)
    monkeypatch.setattr(flash_kernels_module, "flash_attention_plain",
                        None)
    q = torch.zeros((1, 4, 16, dh), dtype=dtype)
    k = torch.zeros((1, 2, 16, dh), dtype=dtype)
    ops.reset_launch_counts()
    if launched:
        out = flash_attention(q, k, k, scale=0.125)
        assert out.shape == q.shape
        [(name, args)] = calls
        assert name == ("flash_attention_tc" if dtype == torch.bfloat16
                        else "flash_attention")
        assert args[9] == launched
        # (batch, head, row) strides of q, k and v: whole padded rows (a
        # size-1 batch's stride replaced by 8 rows)
        assert args[10:19] == (8 * launched, 16 * launched, launched) * 3
    else:
        with pytest.raises(ValueError, match="Dh >= 1"):
            flash_attention(q, k, k, scale=0.125)
        assert calls == []
    assert sum(ops.launch_counts().values()) == int(bool(launched))
    ops.reset_launch_counts()


@pytest.mark.parametrize("dh", [60, 96, 112, 200, 256])
@pytest.mark.parametrize("nq,nkv,causal", [(128, 128, True),
                                           (100, 333, True),
                                           (77, 40, False)])
def test_plain_flash_matches_pallas_interpret_past_dh_160(nq, nkv, causal,
                                                          dh):
    """The plain version against the Pallas kernel in interpret mode and
    the reference's ``flash_attention_ref`` at the head dims the card's
    kernels take from this slice on: one TMA cannot read row by row in f32
    (60 is, 102 would be padded), phi-3-mini's 96, 112, two past the old
    bf16 limit of 192 and Qwen3-Next's 256; causal over a square and a
    ragged shape, non-causal over fewer keys than queries (one KV tile,
    which the Pallas wrapper takes unpadded)."""
    q, k, v = qkv(nq * 7 + nkv + dh, 2, nq, nkv, dh)
    scale = dh ** -0.5
    got = flash_attention(*t_(q, k, v), scale=scale, causal=causal)
    assert got.shape == (2, nq, dh)
    close(got, jref(q, k, v, scale=scale, causal=causal))
    close(got, jflash(q, k, v, scale=scale, causal=causal, interpret=True))


@pytest.mark.parametrize("dh", [264, 512, 576])
@pytest.mark.parametrize("nq,nkv,causal", [(70, 133, True),
                                           (70, 133, False),
                                           (128, 128, True),
                                           (128, 128, False)])
def test_plain_flash_matches_pallas_interpret_past_dh_256(nq, nkv, causal,
                                                          dh):
    """The head dims past 256 that the card's kernels take in column
    slices (264, DeepSeek-V4's 512, sarvam-105b's 576): the port's call
    with q's two heads grouped over one KV head, against the Pallas kernel
    in interpret mode and the reference's ``flash_attention_ref`` on KV
    expanded to the q heads (the Pallas wrapper refuses the non-causal
    ragged case, whose keys it would pad: there only the reference)."""
    r = np.random.default_rng(nq * 5 + nkv + dh + causal)
    q = r.normal(size=(1, 2, nq, dh)).astype(np.float32)
    k, v = (r.normal(size=(1, 1, nkv, dh)).astype(np.float32)
            for _ in range(2))
    scale = dh ** -0.5
    got = flash_attention(*t_(q, k, v), scale=scale, causal=causal)
    assert got.shape == (1, 2, nq, dh) and got.dtype == torch.float32
    eq, ek, ev = q[0], np.repeat(k[0], 2, axis=0), np.repeat(v[0], 2, axis=0)
    close(got[0], jref(eq, ek, ev, scale=scale, causal=causal))
    if causal or nkv % 128 == 0:
        close(got[0], jflash(eq, ek, ev, scale=scale, causal=causal,
                             interpret=True))


def test_bf16_operands_compute_in_f32():
    """bf16 q, k, v: the math is f32 on the rounded values and the result
    is f32, as in the reference kernel (``astype(jnp.float32)`` of each
    block)."""
    q, k, v = qkv(7, 2, 96, 160, 64)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(qb, kb, vb, scale=0.125)
    assert got.dtype == torch.float32
    rounded = [x.to(torch.float32).numpy() for x in (qb, kb, vb)]
    close(got, jref(*rounded, scale=0.125))
    close(got, jflash(*(jnp.asarray(x, jnp.bfloat16) for x in rounded),
                      scale=0.125, interpret=True))


@pytest.mark.parametrize("case", ["dtype_mix", "int", "rank", "shape",
                                  "strided", "no_key", "causal_nq_gt_nkv",
                                  "group", "rank_mix"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v = t_(*qkv(3, 2, 8, 8, 32))
    if case == "group":                 # 3 q heads over 2 KV heads
        q, k, v = q.repeat(3, 1, 1)[None, :3], k[None], v[None]
    elif case == "rank_mix":
        q = q[None]
    elif case == "dtype_mix":
        k = k.to(torch.bfloat16)
    elif case == "int":
        q, k, v = (x.to(torch.int32) for x in (q, k, v))
    elif case == "rank":
        q = q[0]
    elif case == "shape":
        v = v[:, :4]
    elif case == "strided":
        q = torch.cat([q, q], dim=2)[:, :, ::2]
    elif case == "no_key":
        k, v = k[:, :0], v[:, :0]
    else:
        q = torch.cat([q, q], dim=1)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, scale=0.125)


def test_cpu_calls_count_no_launch():
    ops.reset_launch_counts()
    q, k, v = t_(*qkv(5, 2, 16, 16, 32))
    flash_attention(q, k, v, scale=0.125)
    ops.flash_attention(q, k, v, scale=0.125)
    assert ops.launch_counts()["flash_attention_tc"] == 0
    assert ops.launch_counts()["flash_attention_f32"] == 0
    assert ops.KERNELS["flash_attention_tc"] is flash_attention_tc
    assert ops.KERNELS["flash_attention_f32"] is flash_attention_f32


@pytest.mark.parametrize("wrapper,lib", [
    (flash_attention_f32, "flash_attention"),
    (flash_attention_tc, "flash_attention_tc")])
def test_kernel_wrappers_hand_the_lm_views_over_in_place(monkeypatch,
                                                         wrapper, lib):
    """Both kernels' wrappers pass the LM path's operands as they lie: q
    transposed from (B, S, Hq, Dh), k and v the first rows of a longer
    cache over its 5 KV heads, each at its own address with its own
    strides (a size-1 batch's stride replaced by a valid one); no
    ``repeat_interleave``, no copy. The launcher is replaced by a recorder
    (the kernels run only on the card)."""
    calls = []

    def kernel_function(name, symbol, argtypes):
        def fn(*args):
            calls.append((name, symbol, args))
            return 0
        return fn

    def refuse(*a, **kw):
        raise AssertionError("the wrapper copied an operand")

    dtype = torch.float32 if wrapper is flash_attention_f32 else \
        torch.bfloat16
    q = torch.zeros((1, 77, 15, 64), dtype=dtype).transpose(1, 2)
    cache = torch.zeros((2, 1, 5, 96, 64), dtype=dtype)
    k, v = cache[0, :, :, :77], cache[1, :, :, :77]
    monkeypatch.setattr(_build, "kernel_function", kernel_function)
    monkeypatch.setattr(_build, "stream", lambda z: 0)
    for name in ("repeat_interleave", "contiguous", "clone"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    ops.reset_launch_counts()
    out = wrapper(q, k, v, scale=0.125)
    monkeypatch.undo()
    assert out.shape == (1, 15, 77, 64) and out.dtype == torch.float32
    [(name, symbol, args)] = calls
    assert (name, symbol) == (lib, lib + "_launch")
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[4:10] == (1, 15, 5, 77, 77, 64)
    assert args[10:19] == (8 * 64, 64, 15 * 64, 8 * 64, 96 * 64, 64,
                           8 * 64, 96 * 64, 64)
    assert ops.launch_counts()[wrapper.__name__] == 1
    ops.reset_launch_counts()


@pytest.mark.parametrize("wrapper,lib", [
    (flash_attention_f32, "flash_attention"),
    (flash_attention_tc, "flash_attention_tc")])
def test_kernel_wrappers_hand_dh160_views_over_in_place(monkeypatch, wrapper,
                                                        lib):
    """stablelm-12b's prefill layout at Dh 160: q transposed from (1, S,
    32, 160), k and v the first rows of a (1, 8, L, 160) cache, handed to
    each kernel's launcher at their own addresses and strides, no copy."""
    calls = []

    def kernel_function(name, symbol, argtypes):
        return lambda *args: calls.append((name, args)) or 0

    def refuse(*a, **kw):
        raise AssertionError("the wrapper copied an operand")

    dtype = torch.float32 if wrapper is flash_attention_f32 else \
        torch.bfloat16
    q = torch.zeros((1, 77, 32, 160), dtype=dtype).transpose(1, 2)
    cache = torch.zeros((2, 1, 8, 96, 160), dtype=dtype)
    k, v = cache[0, :, :, :77], cache[1, :, :, :77]
    monkeypatch.setattr(_build, "kernel_function", kernel_function)
    monkeypatch.setattr(_build, "stream", lambda z: 0)
    for name in ("repeat_interleave", "contiguous", "clone"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = wrapper(q, k, v, scale=160 ** -0.5)
    monkeypatch.undo()
    assert out.shape == (1, 32, 77, 160) and out.dtype == torch.float32
    [(name, args)] = calls
    assert name == lib
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[4:10] == (1, 32, 8, 77, 77, 160)
    assert args[10:19] == (8 * 160, 160, 32 * 160, 8 * 160, 96 * 160, 160,
                           8 * 160, 96 * 160, 160)
    ops.reset_launch_counts()


def test_ref_matches_reference_ref():
    """The port's oracle against the reference's, causal and not, with
    Nq < Nkv."""
    q, k, v = qkv(11, 2, 33, 70, 32)
    for causal in (True, False):
        close(flash_attention_ref(*t_(q, k, v), scale=0.2, causal=causal),
              jref(q, k, v, scale=0.2, causal=causal))


@pytest.mark.parametrize("b,hq,kvh,nq,nkv,dh,causal", [
    (1, 15, 5, 77, 77, 64, True), (2, 6, 2, 50, 120, 32, True),
    (2, 4, 1, 40, 33, 64, False)])
def test_grouped_heads_and_strided_views_match_the_expanded_call(
        b, hq, kvh, nq, nkv, dh, causal):
    """The LM path's call: q transposed from (B, S, Hq, Dh), k and v the
    first Nkv rows of a longer (B, KV, L, Dh) cache, q head h on KV head
    h // (Hq // KV). Against the 3-d call on KV expanded to the q heads
    and made contiguous, and against the Pallas kernel in interpret mode
    on the same expanded values."""
    r = np.random.default_rng(hq * nkv + dh)
    q = r.normal(size=(b, nq, hq, dh)).astype(np.float32)
    cache = r.normal(size=(2, b, kvh, nkv + 9, dh)).astype(np.float32)
    tq = torch.from_numpy(q).transpose(1, 2)
    tk, tv = (torch.from_numpy(c)[:, :, :nkv] for c in cache)
    assert not tq.is_contiguous() and not tk.is_contiguous()
    got = ops.flash_attention(tq, tk, tv, scale=dh ** -0.5, causal=causal)
    assert got.shape == (b, hq, nq, dh) and got.dtype == torch.float32
    g = hq // kvh
    eq = np.ascontiguousarray(q.transpose(0, 2, 1, 3)).reshape(b * hq, nq, dh)
    ek, ev = (np.repeat(c[:, :, :nkv], g, axis=1).reshape(b * hq, nkv, dh)
              for c in cache)
    want = flash_attention(*t_(eq, ek, ev), scale=dh ** -0.5, causal=causal)
    close(got.reshape(b * hq, nq, dh), want)
    close(got, ops.flash_attention(tq, tk, tv, scale=dh ** -0.5,
                                   causal=causal, plain=True))
    if causal:
        close(want, jflash(eq, ek, ev, scale=dh ** -0.5, interpret=True))


def emulate_tensor_core_scheme(q, k, v, *, scale, causal, split=True,
                               bkv=64):
    """The bf16 tensor-core kernel's arithmetic, in torch on the CPU: bf16
    q, k, v; s = (q k^T) in f32 from the exact bf16 products, times scale
    after the product; masked entries -1e30; ascending 64-key tiles with
    the reference's online-softmax update; p split into bf16 p_hi and
    p_lo = bf16(p - p_hi), both multiplied by the bf16 v into f32
    (``split=False`` rounds p once)."""
    q, k, v = (x.to(torch.bfloat16).to(torch.float32) for x in (q, k, v))
    bh, nq, dh = q.shape
    nkv = k.shape[1]
    qpos = (nkv - nq) + torch.arange(nq)[:, None]
    m = torch.full((bh, nq, 1), -1e30)
    l = torch.zeros((bh, nq, 1))
    acc = torch.zeros((bh, nq, dh))
    for k0 in range(0, nkv, bkv):
        kt, vt = k[:, k0:k0 + bkv], v[:, k0:k0 + bkv]
        s = torch.einsum("bnd,bmd->bnm", q, kt) * scale
        if causal:
            kpos = k0 + torch.arange(kt.shape[1])[None, :]
            s = torch.where(qpos >= kpos, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).to(torch.float32)
        pv = torch.einsum("bnm,bmd->bnd", hi, vt)
        if split:
            lo = (p - hi).to(torch.bfloat16).to(torch.float32)
            pv = pv + torch.einsum("bnm,bmd->bnd", lo, vt)
        acc = acc * alpha + pv
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


@pytest.mark.parametrize("bh,nq,nkv,dh,causal", [
    (3, 200, 200, 64, True), (2, 100, 333, 64, False),
    (15, 2048, 2048, 64, True), (3, 200, 200, 160, True),
    (2, 100, 333, 160, False), (32, 2048, 2048, 160, True)])
def test_tensor_core_scheme_holds_the_flash_tolerance(bh, nq, nkv, dh,
                                                      causal):
    """With p split into two bf16 terms, the kernel's scheme stays within
    atol = rtol = 2e-4 of ``flash_attention_ref`` on the same bf16 values,
    at the card tests' shapes and the 2048-token prefills of smollm-360m
    (Dh 64) and stablelm-12b (32 heads of Dh 160) (the reference is taken
    one head at a time to bound memory)."""
    q, k, v = (x.to(torch.bfloat16) for x in t_(*qkv(nq + dh, bh, nq, nkv,
                                                      dh)))
    got = emulate_tensor_core_scheme(q, k, v, scale=dh ** -0.5,
                                     causal=causal)
    for h in range(bh):
        want = flash_attention_ref(q[h:h + 1], k[h:h + 1], v[h:h + 1],
                                   scale=dh ** -0.5, causal=causal)
        close(got[h:h + 1], want)


def test_unsplit_p_breaks_the_flash_tolerance():
    """Why the kernel splits p: rounding p to bf16 once (relative error up
    to 2^-9 a weight) misses 2e-4 on the early causal rows, where a few
    keys share the weight."""
    q, k, v = (x.to(torch.bfloat16) for x in t_(*qkv(264, 3, 200, 200,
                                                      64)))
    want = flash_attention_ref(q, k, v, scale=0.125)
    got = emulate_tensor_core_scheme(q, k, v, scale=0.125, causal=True,
                                     split=False)
    excess = (got - want).abs() - (TOL + TOL * want.abs())
    assert float(excess.max()) > 0
    split = emulate_tensor_core_scheme(q, k, v, scale=0.125, causal=True)
    assert float(((split - want).abs() - (TOL + TOL * want.abs())).max()) <= 0
