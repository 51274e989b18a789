"""The port's Mamba2 SSD (plain versions, CPU dispatch) against the JAX
reference's ``ssd_ref`` / ``ssd_decode_ref``.

Inputs come from numpy with a seed.  The kernel runs only on a card
(``tests/test_torch_kernels_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_ssd.ref import ssd_decode_ref, ssd_ref
from repro_torch.kernels.mamba2_ssd import ops
from torch_threads import one_thread  # noqa: F401 (autouse)

TOL = 2e-5


def rand_ssd(seed, b, t, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((h,))).astype(np.float32)
    Bm = rng.standard_normal((b, t, g, n), dtype=np.float32)
    Cm = rng.standard_normal((b, t, g, n), dtype=np.float32)
    return x, dt, A, Bm, Cm


def _rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("b,t,h,p,g,n", [
    (1, 128, 2, 64, 2, 32),
    (2, 64, 4, 64, 1, 64),      # grouped B/C (all heads share)
    (1, 64, 8, 32, 2, 16),      # 4 heads per group
    (1, 37, 6, 24, 3, 12),      # ragged T, G = 3, odd sizes
    (2, 1, 2, 8, 1, 4),         # a single step
])
def test_ssd_plain_matches_ref(b, t, h, p, g, n):
    args = rand_ssd(0, b, t, h, p, g, n)
    want = np.asarray(ssd_ref(*(jnp.asarray(a) for a in args)))
    got = ops.ssd(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_ssd_bf16_inputs_match_ref():
    args = rand_ssd(1, 1, 40, 4, 16, 2, 8)
    want = np.asarray(ssd_ref(*(jnp.asarray(a, jnp.bfloat16)
                                for a in args)), np.float32)
    got = ops.ssd_plain(*(torch.from_numpy(a).to(torch.bfloat16)
                          for a in args)).float().numpy()
    assert _rel_err(got, want) <= 2e-2


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_matches_ref(g):
    x, dt, A, Bm, Cm = rand_ssd(2, 2, 1, 4, 16, g, 8)
    state = np.random.default_rng(3).standard_normal(
        (2, 4, 8, 16), dtype=np.float32)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], state)
    want_y, want_s = ssd_decode_ref(*(jnp.asarray(a) for a in args))
    got_y, got_s = ops.ssd_decode(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=TOL, rtol=TOL)


def test_decode_steps_rebuild_the_scan():
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in rand_ssd(4, 1, 16, 2, 16, 2, 8))
    state = torch.zeros((1, 2, 8, 16))
    ys = []
    for t in range(16):
        y, state = ops.ssd_decode(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t],
                                  state)
        ys.append(y)
    want = ops.ssd_plain(x, dt, A, Bm, Cm)
    torch.testing.assert_close(torch.stack(ys, 1), want, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("t", [1, 37, 65, 128])
@pytest.mark.parametrize("g", [1, 3])
def test_chunked_algebra_matches_the_scan(chunk, t, g):
    """The kernel's chunked algebra (``csrc/mamba2_ssd.cu``'s bf16 path),
    as ``ops.ssd_chunked`` states it in float32 torch, against ssd_plain
    and ssd_ref, with strong decays (A dt down to -20) so a wrong mask or
    decay shows; the last chunk padded with dt = 0 and x = 0."""
    args = _strong_decays(t, g)
    got = ops.ssd_chunked(*(torch.from_numpy(a) for a in args),
                          chunk=chunk).numpy()
    plain = ops.ssd_plain(*(torch.from_numpy(a) for a in args)).numpy()
    ref = np.asarray(ssd_ref(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, plain, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def _strong_decays(t, g, b=2, h=6, p=8, n=5):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, t, h, p), dtype=np.float32)
    dt = rng.uniform(0.01, 1.0, (b, t, h)).astype(np.float32)
    A = -rng.uniform(0.1, 20.0, (h,)).astype(np.float32)
    Bm = rng.standard_normal((b, t, g, n), dtype=np.float32)
    Cm = rng.standard_normal((b, t, g, n), dtype=np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("t", [1, 37, 65, 130])
@pytest.mark.parametrize("g", [1, 3])
def test_gradient_recomputes_the_chunked_form(t, g):
    """``ssd``'s backward (the CPU forward, then ``ssd_chunked``'s VJP)
    gives every input's gradient of the scan's within TOL of its max, at
    strong decays and with a ragged last chunk."""
    args = [torch.from_numpy(a) for a in _strong_decays(t, g)]
    got_in = [a.clone().requires_grad_(True) for a in args]
    want_in = [a.clone().requires_grad_(True) for a in args]
    y = ops.ssd(*got_in)
    g_out = torch.randn(y.shape, generator=torch.Generator().manual_seed(t))
    got = torch.autograd.grad(y, got_in, g_out)
    want = torch.autograd.grad(ops.ssd_plain(*want_in), want_in, g_out)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel_err(a.numpy(), b.numpy()) <= TOL


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    args = [torch.from_numpy(a) for a in rand_ssd(5, 1, 20, 2, 8, 1, 4)]
    before = ops.ssd.launches
    assert torch.equal(ops.ssd(*args), ops.ssd_plain(*args))
    assert ops.ssd.launches == before


def test_bad_shapes_raise():
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in rand_ssd(6, 1, 8, 3, 8, 1, 4))
    with pytest.raises(ValueError):
        ops.ssd(x, dt[:, :4], A, Bm, Cm)
    with pytest.raises(ValueError):                  # 3 heads, 2 groups
        ops.ssd(x, dt, A, torch.cat([Bm, Bm], 2), torch.cat([Cm, Cm], 2))
