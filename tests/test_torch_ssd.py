"""The port's Mamba2 SSD (plain versions, CPU dispatch) against the JAX
reference's ``ssd_ref`` / ``ssd_decode_ref``.

Inputs come from numpy with a seed.  The kernel runs only on a card
(``tests/test_torch_kernels_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_ssd.ref import ssd_decode_ref, ssd_ref
from repro_torch.kernels.mamba2_ssd import ops
from torch_tf32 import mma_chain, split_tf32
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


# --- the float32 kernel's arithmetic (3xTF32 on mma.sync), emulated ---------
#
# csrc/mamba2_ssd.cu's float32 path computes the chunked dual form in
# chunks of 32 steps: la = cumsum(dt A log2 e) from the chunk's start by the
# warp's shuffle scan (a tree of float32 sums), seg = exp2(la_t - la_s);
# every product in 3xTF32, 8 deep a step (tests/torch_tf32.py), in the
# kernel's term order: C B^T and C S_in with the hi * hi products apart
# from the small terms, added at the end, and C B^T and ((C B^T) .* seg)
# (dt x) with their even and odd k-steps apart; the carry's B^T (dt x
# exp2(la_L - la)) in a fresh accumulator, added to the decayed state by
# one FMA; the state carried in float32 and split for C S_in.  The kernel
# runs only on a card; here its arithmetic runs in numpy.

# of max |ssd_plain| and of max |ssd_ref|: the cases below read
# 9.3e-8..3.2e-6, and 1.6e-4..5.0e-3 with one pass (hi * hi alone)
TF32_BOUND = 1e-5
CHUNK = 32
LOG2E = np.float32(1.4426950408889634)
# compiled once a shape: both input kinds of a case share it
ssd_ref_jit = jax.jit(ssd_ref)


def warp_scan(v):
    """Inclusive sums along the last axis (32 lanes) in the order of
    __shfl_up_sync's tree, each sum a float32 rounding."""
    v = v.copy()
    for o in (1, 2, 4, 8, 16):
        v[..., o:] = v[..., o:] + v[..., :-o]
    return v


def ssd_3xtf32(x, dt, A, Bm, Cm, passes=3):
    """The float32 kernel's SSD on numpy inputs x [B,T,H,P], dt [B,T,H],
    A [H], Bm/Cm [B,T,G,N]; ``passes`` 1 keeps hi * hi alone."""
    b, t, h, p = x.shape
    g, n = Bm.shape[2:]
    npad = -(-n // 16) * 16
    nc = -(-t // CHUNK)
    tpad = nc * CHUNK - t

    def chunks(v, last=0):     # [B, T, H, K] -> [B, H, nc, L, K]
        v = np.pad(v, [(0, 0), (0, tpad), (0, 0), (0, last)])
        return np.moveaxis(v.reshape(b, nc, CHUNK, *v.shape[2:]), 3, 1)

    xs, ds = chunks(x), chunks(dt[..., None])[..., 0]
    Bs = np.repeat(chunks(Bm, npad - n), h // g, axis=1)
    Cs = np.repeat(chunks(Cm, npad - n), h // g, axis=1)
    a2 = (A * LOG2E).astype(np.float32)[None, :, None, None]
    la = warp_scan((ds * a2).astype(np.float32))       # [B, H, nc, L]
    ela = np.exp2(la)
    w = np.exp2(la[..., -1:] - la)
    tri = np.tri(CHUNK, dtype=bool)
    with np.errstate(over="ignore"):
        seg = np.where(tri, np.exp2(la[..., :, None] - la[..., None, :]),
                       np.float32(0))
    S = np.zeros((b, h, npad, p), np.float32)
    y = np.zeros((b, h, nc, CHUNK, p), np.float32)

    def product(acc, a, b, small, parity=None):
        """acc += a @ b, the small terms in the order ``small`` of
        ("lo", "hi") pairs naming a's and b's parts, then hi * hi."""
        (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
        part = {"hi": (ah, bh), "lo": (al, bl)}
        pairs = [(part[i][0], part[j][1]) for i, j in small] \
            if passes == 3 else []
        return mma_chain(acc, pairs + [(ah, bh)], parity)

    def parities(fn):          # the even and the odd k-steps apart, added
        return fn(0) + fn(1)

    for c in range(nc):
        x_c, d_c, B_c, C_c = xs[:, :, c], ds[:, :, c], Bs[:, :, c], Cs[:, :, c]
        xd = d_c[..., None] * x_c
        xw = (d_c * w[:, :, c])[..., None] * x_c
        (Ch, Cl), (Bh, Bl), (Sh, Sl) = (split_tf32(v) for v in (C_c, B_c, S))
        BhT, BlT = Bh.swapaxes(-1, -2), Bl.swapaxes(-1, -2)
        zero = np.zeros((b, h, CHUNK, CHUNK), np.float32)
        # C B^T (by k-step parity) and C S_in: hi * hi apart from the
        # small terms
        cb = parities(lambda k: mma_chain(zero, [(Ch, BhT)], k))
        cs = mma_chain(np.zeros_like(x_c), [(Ch, Sh)])
        if passes == 3:
            cb = cb + parities(
                lambda k: mma_chain(zero, [(Cl, BhT), (Ch, BlT)], k))
            cs = cs + mma_chain(np.zeros_like(x_c), [(Ch, Sl), (Cl, Sh)])
        # the kernel takes y^T = (dt x)^T M^T (by key-step parity) and S^T'
        # from (dt x w)^T B: their small terms lo * hi of (dt x), then
        # hi * lo
        m_c = cb * seg[:, :, c]
        yo = parities(lambda k: product(np.zeros_like(x_c), m_c, xd,
                                        [("hi", "lo"), ("lo", "hi")], k))
        y[:, :, c] = (ela[:, :, c, :, None].astype(np.float64) * cs
                      + yo).astype(np.float32)
        f = product(np.zeros_like(S), B_c.swapaxes(-1, -2), xw,
                    [("hi", "lo"), ("lo", "hi")])
        S = (S.astype(np.float64) * ela[:, :, c, -1, None, None]
             + f).astype(np.float32)
    return np.moveaxis(y.reshape(b, h, nc * CHUNK, p), 1, 2)[:, :t]


@pytest.mark.parametrize("inputs", ["strong decays", "unit normal"])
@pytest.mark.parametrize("n", [16, 64, 128])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("t", [1, 37, 65, 130])
def test_3xtf32_arithmetic_is_float32_accurate(inputs, n, g, t):
    """The float32 kernel's arithmetic within TF32_BOUND of max |y| of
    ssd_plain and of ssd_ref; the same arithmetic in one pass (the lo terms
    dropped) misses it."""
    if inputs == "strong decays":
        args = _strong_decays(t, g, h=4, n=n)
    else:
        args = rand_ssd(8, 2, t, 4, 8, g, n)
    plain = ops.ssd_plain(*(torch.from_numpy(a) for a in args)).numpy()
    ref = np.asarray(ssd_ref_jit(*(jnp.asarray(a) for a in args)))
    got3, got1 = ssd_3xtf32(*args), ssd_3xtf32(*args, passes=1)
    for want in (plain, ref):
        top = np.abs(want).max()
        err3, err1 = np.abs(got3 - want).max(), np.abs(got1 - want).max()
        assert err3 <= TF32_BOUND * top, (err3 / top, TF32_BOUND)
        assert err1 > TF32_BOUND * top, (err1 / top, TF32_BOUND)
