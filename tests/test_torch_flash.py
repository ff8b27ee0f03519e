"""Kernel 7, flash attention: the port's wrapper on CPU operands (its plain
version, the exact softmax of ``flash_attention_ref``) against the JAX
Pallas kernel in interpret mode and against the reference's
``flash_attention_ref``, on seeded numpy inputs. The CUDA kernel itself is
held to the same plain version on the card (``test_torch_cuda.py``,
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
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import flash_attention_ref

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


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("nq,nkv", [(128, 128), (64, 256), (1, 512),
                                    (200, 200), (100, 333)])
def test_plain_flash_matches_pallas_interpret_and_ref(nq, nkv, dh):
    """Causal, query i at position nkv - nq + i: square, decode-like (one
    query over 512 keys), prefill against a longer cache, and lengths that
    are not multiples of the 128-row tiles (both sides pad)."""
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
                                  "strided", "no_key", "causal_nq_gt_nkv"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v = t_(*qkv(3, 2, 8, 8, 32))
    if case == "dtype_mix":
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
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.KERNELS["flash_attention"] is flash_attention


def test_ref_matches_reference_ref():
    """The port's oracle against the reference's, causal and not, with
    Nq < Nkv."""
    q, k, v = qkv(11, 2, 33, 70, 32)
    for causal in (True, False):
        close(flash_attention_ref(*t_(q, k, v), scale=0.2, causal=causal),
              jref(q, k, v, scale=0.2, causal=causal))
