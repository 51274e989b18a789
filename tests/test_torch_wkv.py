"""The port's RWKV6 WKV (plain versions, CPU dispatch) against the JAX
reference's ``wkv6_ref`` / ``wkv6_decode_ref``.

Inputs come from numpy with a seed; decays are ``exp(-exp(x))`` with x
uniform on [-6, 1] (0.066 .. 0.9975, where the state carries farthest).
The reference's Pallas ``wkv6`` is not used: it does not trace on the
installed JAX.  The kernel runs only on a card
(``tests/test_torch_kernels_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv.ref import wkv6_decode_ref, wkv6_ref
from repro_torch.kernels.rwkv6_wkv import ops

TOL = 2e-5


def rand_wkv(seed, b, h, t, k, v):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, h, t, k), dtype=np.float32)
    kk = rng.standard_normal((b, h, t, k), dtype=np.float32)
    vv = rng.standard_normal((b, h, t, v), dtype=np.float32)
    w = np.exp(-np.exp(rng.uniform(-6.0, 1.0, (b, h, t, k)))).astype(
        np.float32)
    u = rng.standard_normal((h, k), dtype=np.float32)
    return r, kk, vv, w, u


def _rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("b,h,t,k,v", [
    (2, 4, 37, 32, 32),         # the smoke config's heads, ragged T
    (1, 2, 128, 64, 64),        # rwkv6-7b's head size
    (1, 3, 1, 16, 16),          # a single step
    (2, 2, 50, 64, 48),         # ragged V
    (1, 2, 20, 12, 40),         # K < V
])
def test_wkv6_plain_matches_ref(b, h, t, k, v):
    args = rand_wkv(0, b, h, t, k, v)
    want = np.asarray(wkv6_ref(*(jnp.asarray(a) for a in args)))
    got = ops.wkv6(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.shape == want.shape == (b, h, t, v)
    assert _rel_err(got, want) <= TOL


def test_wkv6_bf16_inputs_match_ref():
    args = rand_wkv(1, 1, 4, 40, 32, 32)
    want = np.asarray(wkv6_ref(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in args)), np.float32)
    got = ops.wkv6_plain(*(torch.from_numpy(a).to(torch.bfloat16)
                           for a in args))
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float().numpy(), want) <= 2e-2


def test_wkv6_decode_matches_ref():
    r, k, v, w, u = rand_wkv(2, 2, 4, 1, 16, 24)
    state = np.random.default_rng(3).standard_normal(
        (2, 4, 16, 24), dtype=np.float32)
    args = (r[:, :, 0], k[:, :, 0], v[:, :, 0], w[:, :, 0], u, state)
    want_y, want_s = wkv6_decode_ref(*(jnp.asarray(a) for a in args))
    got_y, got_s = ops.wkv6_decode(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=TOL, rtol=TOL)


def test_decode_steps_rebuild_the_scan():
    r, k, v, w, u = (torch.from_numpy(a)
                     for a in rand_wkv(4, 2, 3, 24, 16, 20))
    state = torch.zeros((2, 3, 16, 20))
    ys = []
    for t in range(24):
        y, state = ops.wkv6_decode(r[:, :, t], k[:, :, t], v[:, :, t],
                                   w[:, :, t], u, state)
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 2), ops.wkv6_plain(r, k, v,
                                                                  w, u),
                               atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    args = [torch.from_numpy(a) for a in rand_wkv(5, 1, 2, 20, 8, 8)]
    before = ops.wkv6.launches
    assert torch.equal(ops.wkv6(*args), ops.wkv6_plain(*args))
    assert ops.wkv6.launches == before


def test_empty_sequence_gives_an_empty_output():
    r, k, v, w, u = (torch.from_numpy(a) for a in rand_wkv(6, 2, 3, 0, 8, 5))
    y = ops.wkv6(r, k, v, w, u)
    assert y.shape == (2, 3, 0, 5) and y.dtype == r.dtype


def test_bad_shapes_and_devices_raise():
    r, k, v, w, u = (torch.from_numpy(a)
                     for a in rand_wkv(7, 1, 2, 8, 8, 8))
    with pytest.raises(ValueError):                  # k of another length
        ops.wkv6(r, k[:, :, :4], v, w, u)
    with pytest.raises(ValueError):                  # u for 3 heads
        ops.wkv6(r, k, v, w, torch.zeros((3, 8)))
    with pytest.raises(ValueError):                  # r without a batch axis
        ops.wkv6(r[0], k[0], v[0], w[0], u)
    with pytest.raises(ValueError, match="meta"):    # mixed devices
        ops.wkv6(r, k, v, w.to("meta"), u)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.wkv6(*(a.to("meta") for a in (r, k, v, w, u)))
