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
