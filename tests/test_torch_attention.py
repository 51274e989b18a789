"""The port's attention (plain versions, CPU dispatch) against the JAX
reference's ``attention_ref`` / ``decode_attention_ref``.

Inputs come from numpy with a seed and go through both functions.  The
reference side is the jnp oracle, never the Pallas interpret path.  The
kernel itself runs only on a card (``tests/test_torch_kernels_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import (
    attention_ref, decode_attention_ref,
)
from repro_torch.kernels.flash_attention import ops
from torch_threads import one_thread  # noqa: F401 (autouse)
from torch_tf32 import mma_chain, split_tf32

F32_TOL = 2e-5
BF16_TOL = 2e-2


def rand_qkv(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, sk, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, sk, d), dtype=np.float32)
    return q, k, v


def both(q, k, v, dtype, **kw):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    want = attention_ref(*(jnp.asarray(a, jd) for a in (q, k, v)), **kw)
    got = ops.flash_attention(*(torch.from_numpy(a).to(td)
                                for a in (q, k, v)), **kw)
    return (got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 4, 4, 256, 64),      # MHA
    (2, 8, 2, 256, 64),      # GQA 4:1
    (1, 4, 1, 512, 128),     # MQA
    (1, 2, 2, 256, 256),     # gemma3 head_dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_matches_ref(b, hq, hkv, s, d, dtype):
    got, want = both(*rand_qkv(0, b, hq, hkv, s, s, d), dtype, causal=True)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [1, 128, 384, 1024])
def test_sliding_window_matches_ref(window):
    got, want = both(*rand_qkv(1, 1, 4, 2, 512, 512, 64), "float32",
                     causal=True, window=window)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (128, 640, True, None),     # queries at the tail of a longer timeline
    (1, 777, True, None),       # one query against a long prefix
    (300, 1000, True, 200),
    (100, 100, True, None),     # ragged: no 128-multiple anywhere
    (37, 131, True, 50),
    (1500 // 10, 1500 // 10, False, None),   # non-causal (encoder)
    (64, 200, False, None),
])
def test_shapes_and_masks_match_ref(sq, sk, causal, window):
    got, want = both(*rand_qkv(2, 2, 4, 2, sq, sk, 112), "float32",
                     causal=causal, window=window)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("hq,hkv,lengths", [
    (4, 4, (17, 64)),
    (8, 2, (1, 40)),
    (4, 1, (64, 64)),
])
def test_decode_attention_matches_ref(hq, hkv, lengths):
    rng = np.random.default_rng(3)
    b, s, d = len(lengths), 64, 32
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    lens = np.asarray(lengths, np.int32)
    want = decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(lens))
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=F32_TOL, rtol=F32_TOL)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    q, k, v = (torch.from_numpy(a) for a in rand_qkv(4, 1, 4, 2, 48, 48, 40))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True, window=16)
    want = ops.attention_plain(q, k, v, causal=True, window=16)
    assert torch.equal(got, want)
    assert ops.flash_attention.launches == before


@pytest.mark.parametrize("shapes", [
    ((1, 4, 8, 16), (1, 3, 8, 16), (1, 3, 8, 16)),     # Hq % Hkv != 0
    ((1, 4, 8, 16), (1, 2, 8, 8), (1, 2, 8, 8)),       # head dims differ
    ((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 9, 16)),     # k, v differ
])
def test_bad_shapes_raise(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)


# --- the float32 kernel's arithmetic (3xTF32 on mma.sync), emulated ---------
#
# csrc/flash_attention.cu's float32 path splits every operand x into
# hi = tf32(x) and lo = tf32(x - hi) (rounded as cvt.rna.tf32.f32 does)
# and takes each product from hi * hi and the small terms lo * hi and
# hi * lo, 8 deep a tensor-core step, under an online softmax over key
# tiles of the kernel's sizes (32 keys at D <= 96, else 16): S = Q K^T with
# the hi * hi products and the small terms in two accumulators, added at
# the end; each output column block's P V over a key tile in a fresh
# accumulator (lo * hi, hi * lo, hi * hi a step), added to the rescaled
# output by one FMA.  The kernel runs only on a card; here its arithmetic
# runs in numpy (``tests/torch_tf32.py``), each mma modelled as one float32
# rounding of the accumulator plus its 8 exact products.

# of max |attention_plain|: the cases below read 2.5e-7..1.2e-6, and
# 2.7e-4..5.3e-4 with one pass (hi * hi alone)
TF32_BOUND = 5e-6
LOG2E = np.float32(1.4426950408889634)


def attention_3xtf32(q, k, v, causal, window, passes=3):
    """The float32 kernel's attention, q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D];
    ``passes`` 1 drops the small terms (a one-pass TF32 kernel)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    bk = 32 if d <= 96 else 16
    dp = -(-d // 8) * 8
    pad = [(0, 0)] * 3 + [(0, dp - d)]
    qh, ql = split_tf32(np.pad(q * np.float32(1.0 / d ** 0.5), pad))
    kf = np.pad(np.repeat(k, hq // hkv, axis=1), pad)
    vf = np.pad(np.repeat(v, hq // hkv, axis=1), pad)
    qpos = np.arange(sq)[:, None] + (sk - sq)
    m = np.full((b, hq, sq, 1), -np.inf, np.float32)
    l = np.zeros((b, hq, sq, 1), np.float32)
    acc = np.zeros((b, hq, sq, dp), np.float32)
    for k0 in range(0, sk, bk):
        (kh, kl), (vh, vl) = (split_tf32(x[:, :, k0:k0 + bk])
                              for x in (kf, vf))
        kh, kl = kh.swapaxes(-1, -2), kl.swapaxes(-1, -2)
        zero = np.zeros((b, hq, sq, kh.shape[-1]), np.float32)
        s = mma_chain(zero, [(qh, kh)])
        if passes == 3:
            s = s + mma_chain(zero, [(ql, kh), (qh, kl)])
        kpos = np.arange(k0, k0 + kh.shape[-1])[None, :]
        ok = np.ones((sq, kh.shape[-1]), bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        s = np.where(ok, s, np.float32(-np.inf))
        mx = np.maximum(m, s.max(-1, keepdims=True))
        msc = np.where(mx == -np.inf, np.float32(0), mx) * LOG2E
        with np.errstate(invalid="ignore"):
            alpha = np.exp2((m.astype(np.float64) * LOG2E - msc)
                            .astype(np.float32)).astype(np.float32)
            p = np.exp2((s.astype(np.float64) * LOG2E - msc)
                        .astype(np.float32)).astype(np.float32)
        m = mx
        l = l * alpha + p.sum(-1, keepdims=True, dtype=np.float32)
        ph, pl = split_tf32(p)
        pairs = [(pl, vh), (ph, vl), (ph, vh)] if passes == 3 else [(ph, vh)]
        pv = mma_chain(np.zeros_like(acc), pairs)
        acc = (acc.astype(np.float64) * alpha + pv).astype(np.float32)
    return (acc / l)[..., :d]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window", [
    (1, 4, 4, 96, 96, 96, True, None),        # phi3's head dim
    (1, 4, 2, 100, 100, 112, True, None),     # GQA, ragged key tiles
    (2, 4, 2, 37, 131, 112, True, 50),        # Sq < Sk under a window
    (1, 4, 1, 128, 128, 128, True, None),     # MQA
    (1, 2, 2, 64, 200, 112, False, None),     # non-causal, Sq < Sk
    (1, 2, 2, 96, 96, 256, True, None),       # gemma3's head dim
    (1, 4, 2, 128, 128, 64, True, 16),        # window within a key tile
    (1, 2, 2, 1, 777, 128, True, None),       # one query, a long prefix
])
def test_3xtf32_arithmetic_is_float32_accurate(b, hq, hkv, sq, sk, d,
                                               causal, window):
    q, k, v = rand_qkv(5, b, hq, hkv, sq, sk, d)
    want = ops.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, window=window).numpy()
    top = np.abs(want).max()
    err3 = np.abs(attention_3xtf32(q, k, v, causal, window) - want).max()
    err1 = np.abs(attention_3xtf32(q, k, v, causal, window, passes=1)
                  - want).max()
    assert err3 <= TF32_BOUND * top, (err3 / top, TF32_BOUND)
    # the planted one-pass kernel (lo terms dropped) fails the same gate
    assert err1 > TF32_BOUND * top, (err1 / top, TF32_BOUND)
