"""The port's float kernels against their plain versions on a CUDA card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a card.  The file imports neither JAX nor the reference, so
it runs on a machine with PyTorch for CUDA alone::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.mamba2_ssd import ops as sd

pytestmark = pytest.mark.cuda

# atol = rtol, as tests/test_kernels_attention.py holds bf16; the SSD
# against max |plain output|
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(dev, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,kw", [
    (1, 8, 2, 300, 1000, 112, dict(causal=True)),
    (2, 4, 4, 129, 129, 256, dict(causal=True, window=40)),
    (1, 4, 1, 77, 77, 64, dict(causal=False)),
    (1, 3, 3, 1, 33, 20, dict(causal=True)),
])
def test_flash_attention_matches_plain(card, dtype, b, hq, hkv, sq, sk, d,
                                       kw):
    rng = np.random.default_rng(0)
    td = getattr(torch, dtype)
    q = _randn(rng, (b, hq, sq, d), td, card)
    k = _randn(rng, (b, hkv, sk, d), td, card)
    v = _randn(rng, (b, hkv, sk, d), td, card)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, **kw).float()
    want = fa.attention_plain(q, k, v, **kw).float()
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,p,g,n", [
    (1, 127, 8, 64, 1, 64),
    (2, 70, 6, 40, 2, 100),
    (1, 1, 4, 8, 4, 3),
])
def test_ssd_matches_plain(card, dtype, b, t, h, p, g, n):
    rng = np.random.default_rng(1)
    td = getattr(torch, dtype)
    x = _randn(rng, (b, t, h, p), td, card)
    dt = torch.nn.functional.softplus(_randn(rng, (b, t, h), torch.float32,
                                             card)).to(td)
    A = -torch.exp(_randn(rng, (h,), torch.float32, card))
    Bm = _randn(rng, (b, t, g, n), td, card)
    Cm = _randn(rng, (b, t, g, n), td, card)
    before = sd.ssd.launches
    got = sd.ssd(x, dt, A, Bm, Cm).float()
    want = sd.ssd_plain(x, dt, A, Bm, Cm).float()
    assert sd.ssd.launches == before + 1
    assert ((got - want).abs().max() / want.abs().max()).item() <= TOL[dtype]


def test_unsupported_inputs_raise(card):
    q = torch.zeros((1, 2, 4, 8), device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 4, 300), device=card)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
