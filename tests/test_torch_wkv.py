"""The port's RWKV6 WKV (plain versions, CPU dispatch) against the JAX
reference's ``wkv6_ref`` / ``wkv6_decode_ref``.

Inputs come from numpy with a seed; decays are ``exp(-exp(x))`` with x
uniform on [-6, 1] (0.066 .. 0.9975, where the state carries farthest).
The reference's Pallas ``wkv6`` is not used: it does not trace on the
installed JAX.  The kernels run only on a card
(``tests/test_torch_kernels_cuda.py``); ``wkv6_chunked`` below states the
bf16 kernel's chunked algebra in float32 torch, held here against both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv.ref import wkv6_decode_ref, wkv6_ref
from repro_torch.kernels.rwkv6_wkv import ops
from torch_threads import one_thread  # noqa: F401 (autouse)

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


def _decays(rng, shape, regime):
    """exp(-exp(x)) as the model makes them: x uniform on [-6, 1]
    ("moderate"), on [-1, 5] ("strong": about 6 % underflow to exactly 0),
    or w = 1 exactly ("one": the state never decays)."""
    if regime == "one":
        return np.ones(shape, np.float32)
    lo, hi = {"moderate": (-6.0, 1.0), "strong": (-1.0, 5.0)}[regime]
    return np.exp(-np.exp(rng.uniform(lo, hi, shape))).astype(np.float32)


def _excl_cumprod(x, dim, reverse=False):
    """prod of x over the indices before (after, with reverse) each one."""
    if reverse:
        return _excl_cumprod(x.flip(dim), dim).flip(dim)
    ones = torch.ones_like(x.narrow(dim, 0, 1))
    body = torch.cumprod(x, dim).narrow(dim, 0, x.shape[dim] - 1)
    return torch.cat([ones, body], dim)


def wkv6_chunked(r, k, v, w, u, chunk, sub):
    """The bf16 kernel's chunked form (``csrc/rwkv6_wkv.cu``), stated in
    float32 torch.  Per chunk of ``chunk`` steps entering with state S,
    with P_t the product of w over the chunk's steps before t and Q_s over
    those after s::

        y  = A v + (r .* P) S,   S' = P_L .* S + (k .* Q)^T v
        A[t, s] = sum_k r_t k_s prod_{s<i<t} w_i   (s < t)
        A[t, t] = sum_k r_t u k_t

    A pair s < t whose highest differing bit b = msb(t ^ s) is at least
    ``sub`` is factored at ref, the start of the upper half of the aligned
    2b-block holding both: X_b[t] = r_t prod_{ref<=i<t} w_i and X_b[s] =
    k_s prod_{s<i<ref} w_i, one tile a level, entries of X_b X_b^T.  The
    pairs closer than ``sub`` are taken elementwise, per (t, s, k): sub = 1
    is the kernel's form, sub = 16 that of Yang et al.'s sub-chunks.  Every
    factor is a product of w in [0, 1].  The last chunk is padded with
    r = k = v = 0 and w = 0, as the kernel reads steps past T."""
    b, h, t, dk = r.shape
    pad = -t % chunk
    F = torch.nn.functional
    rf, kf, wf = (F.pad(a.float(), (0, 0, 0, pad)) for a in (r, k, w))
    vf = F.pad(v.float(), (0, 0, 0, pad))
    uf = u.float()[None, :, None, :]
    idx = torch.arange(chunk)
    lower = idx[:, None] > idx[None, :]
    S = torch.zeros((b, h, dk, v.shape[-1]))
    ys = []
    for c0 in range(0, t + pad, chunk):
        rc, kc, wc, vc = (a[:, :, c0:c0 + chunk] for a in (rf, kf, wf, vf))
        A = torch.zeros((b, h, chunk, chunk))
        lvl = chunk // 2
        while lvl >= sub:
            halves = wc.reshape(b, h, chunk // lvl, lvl, dk)
            from_ref = _excl_cumprod(halves, 3).reshape(b, h, chunk, dk)
            to_ref = _excl_cumprod(halves, 3, True).reshape(b, h, chunk, dk)
            upper = ((idx // lvl) % 2 == 1)[None, None, :, None]
            X = torch.where(upper, rc * from_ref, kc * to_ref)
            x = idx[:, None] ^ idx[None, :]
            pick = lower & (x >= lvl) & (x < 2 * lvl)
            A = A + torch.where(pick, X @ X.transpose(-1, -2), 0.0)
            lvl //= 2
        for tt in range(chunk):           # pairs closer than sub
            for s in range(tt - tt % sub, tt):
                f = torch.prod(wc[:, :, s + 1:tt], dim=2)
                A[:, :, tt, s] = (rc[:, :, tt] * kc[:, :, s] * f).sum(-1)
        A = A + torch.diag_embed((rc * uf * kc).sum(-1))
        P = _excl_cumprod(wc, 2)
        Q = _excl_cumprod(wc, 2, reverse=True)
        ys.append(A @ vc + (rc * P) @ S)
        S = torch.prod(wc, 2)[..., None] * S + (kc * Q).transpose(-1, -2) @ vc
    return torch.cat(ys, 2)[:, :, :t]


@pytest.mark.parametrize("regime", ["moderate", "strong", "one"])
@pytest.mark.parametrize("t", [1, 37, 65, 128])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("sub", [1, 16])
def test_chunked_algebra_matches_the_scan(sub, chunk, t, regime):
    """The kernel's chunked algebra (sub = 1) and the sub-chunked one
    against wkv6_plain and wkv6_ref, in three decay regimes."""
    rng = np.random.default_rng(8)
    b, h, dk, dv = 2, 3, 16, 12
    r, kk, vv, _, u = rand_wkv(8, b, h, t, dk, dv)
    w = _decays(rng, (b, h, t, dk), regime)
    if regime == "strong":
        assert (w == 0).any()
    args = (r, kk, vv, w, u)
    got = wkv6_chunked(*(torch.from_numpy(a) for a in args), chunk,
                       sub).numpy()
    plain = ops.wkv6_plain(*(torch.from_numpy(a) for a in args)).numpy()
    ref = np.asarray(wkv6_ref(*(jnp.asarray(a) for a in args)))
    assert np.isfinite(got).all()
    assert _rel_err(got, plain) <= TOL
    assert _rel_err(got, ref) <= TOL


def test_one_reference_a_chunk_is_not_finite_with_zero_decays():
    """The factorization the hierarchy avoids: the chunk start as the one
    reference, A[t, s] = (r_t P_t) . (k_s / P_{s+1}), divides by P = 0 once
    a decay is exactly 0, so the test above is known to bite."""
    rng = np.random.default_rng(9)
    r, kk, _, _, _ = (torch.from_numpy(a)
                      for a in rand_wkv(9, 1, 2, 64, 16, 8))
    w = torch.from_numpy(_decays(rng, (1, 2, 64, 16), "strong"))
    assert bool((w == 0).any())
    P = _excl_cumprod(w, 2)
    P_next = torch.cumprod(w, 2)        # P_{s+1}
    A = (r * P) @ (kk / P_next).transpose(-1, -2)
    lower = torch.ones(64, 64).tril(-1).bool()
    assert not bool(A[..., lower].isfinite().all())
