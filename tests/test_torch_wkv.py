"""The port's RWKV6 WKV (plain versions, CPU dispatch) against the JAX
reference's ``wkv6_ref`` / ``wkv6_decode_ref``.

Inputs come from numpy with a seed; decays are ``exp(-exp(x))`` with x
uniform on [-6, 1] (0.066 .. 0.9975, where the state carries farthest).
The reference's Pallas ``wkv6`` is not used: it does not trace on the
installed JAX.  The kernels run only on a card
(``tests/test_torch_kernels_cuda.py``); ``wkv6_chunked`` below states the
kernels' chunked algebra in float32 torch, and ``wkv6_3xtf32`` the float32
kernel's tensor-core arithmetic in numpy, each held here against both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv.ref import wkv6_decode_ref, wkv6_ref
from repro_torch.kernels.rwkv6_wkv import ops
from torch_tf32 import mma_chain, split_tf32
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
    factor is a product of w in [0, 1].  The bf16 kernel takes chunk = 64,
    sub = 1; the float32 kernel chunk = 32, sub = 8.  The last chunk is
    padded with r = k = v = 0 and w = 0, as the kernels read steps past
    T."""
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
@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("sub", [1, 8, 16])
def test_chunked_algebra_matches_the_scan(sub, chunk, t, regime):
    """The kernels' chunked algebra (bf16: 64 and 1; float32: 32 and 8)
    and the sub-chunked one against wkv6_plain and wkv6_ref, in three decay
    regimes."""
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


# --- the float32 kernel's arithmetic (3xTF32 on mma.sync), emulated ---------
#
# csrc/rwkv6_wkv.cu's float32 path computes wkv6_chunked's algebra at
# chunk = 32, sub = 8: per 8-step block of the chunk and per key, the
# prefix and suffix products of w inside the block, the block's total G,
# the products of the totals before and after it, all float32 in the
# kernel's order; r P, k Q, X_16 and X_8 split into tf32 hi and lo; the
# level products X_16 X_16^T (rows 16 .., keys 0 .. 15) and X_8 X_8^T
# (rows 8 .. 15 x 0 .. 7, 24 .. 31 x 16 .. 23) with hi * hi apart from the
# small terms, each by k-step parity; the pairs inside an 8-step block and
# the bonus in float32, summed over each half of the keys, the halves
# added; A split; y as two partial sums, one a half of the keys: S (r P)
# over the half's keys (hi * hi apart from the small terms) plus A V for
# rows 0 .. 23 (first half) or 24 .. 31 (second), added as y goes out; the
# carry (k Q)^T V in a fresh accumulator added to P_L .* S by one FMA; the
# state carried in float32 and split for S (r P).  Every product is 8 deep
# a tensor-core step (tests/torch_tf32.py).  The kernel runs only on a
# card; here its arithmetic runs in numpy.

# of max |wkv6_plain| and of max |wkv6_ref|: the cases below read
# 9.1e-8 .. 5.5e-7, and 2.7e-4 .. 5.9e-4 with one pass (hi * hi alone)
TF32_BOUND = 1e-5
F32_CHUNK, F32_SUB = 32, 8
# compiled once a shape: both input kinds of a case share it
wkv6_ref_jit = jax.jit(wkv6_ref)


def wkv6_3xtf32(r, k, v, w, u, passes=3):
    """The float32 kernel's WKV on numpy inputs r, k, w [B,H,T,K], v
    [B,H,T,V], u [H,K]; ``passes`` 1 keeps hi * hi alone."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    kp = -(-dk // 16) * 16
    kh = kp // 2
    L, nb = F32_CHUNK, F32_CHUNK // F32_SUB
    nc = -(-t // L)

    def chunks(a, width):      # [B, H, T, X] -> [B, H, nc, L, width]
        a = np.pad(a.astype(np.float32), [(0, 0), (0, 0), (0, nc * L - t),
                                          (0, width - a.shape[-1])])
        return a.reshape(b, h, nc, L, width)

    rs, ks, ws = (chunks(a, kp) for a in (r, k, w))
    vs = chunks(v, dv)
    uk = np.pad(u.astype(np.float32), [(0, 0), (0, kp - dk)])[None, :, None]
    S = np.zeros((b, h, kp, dv), np.float32)
    y = np.zeros((b, h, nc, L, dv), np.float32)
    small = passes == 3

    def split_pairs(x, y_):    # the passes' (x, y) pairs, small terms first
        (xh, xl), (yh, yl) = split_tf32(x), split_tf32(y_)
        return ([(xh, yl), (xl, yh)] if small else []) + [(xh, yh)]

    def level(xa, xb):         # xa @ xb^T: hi * hi apart, by k-step parity
        (ah, al), (bh, bl) = split_tf32(xa), split_tf32(xb.swapaxes(-1, -2))
        zero = np.zeros(xa.shape[:-1] + xb.shape[-2:-1], np.float32)
        hi = [mma_chain(zero, [(ah, bh)], p) for p in (0, 1)]
        lo = [mma_chain(zero, [(al, bh), (ah, bl)], p) if small else zero
              for p in (0, 1)]
        return (hi[0] + hi[1]) + (lo[0] + lo[1])

    for c in range(nc):
        rc, kc, wc, vc = rs[:, :, c], ks[:, :, c], ws[:, :, c], vs[:, :, c]
        blk = wc.reshape(b, h, nb, F32_SUB, kp)
        pr = np.ones_like(blk)                 # prod_{block start <= j < i}
        sf = np.ones_like(blk)                 # prod_{i < j < block end}
        for i in range(1, F32_SUB):
            pr[:, :, :, i] = pr[:, :, :, i - 1] * blk[:, :, :, i - 1]
        for i in range(F32_SUB - 2, -1, -1):
            sf[:, :, :, i] = sf[:, :, :, i + 1] * blk[:, :, :, i + 1]
        G = pr[:, :, :, -1] * blk[:, :, :, -1]         # [B, H, nb, KP]
        one = np.ones_like(G[:, :, 0])
        pre, post = [], []
        for j in range(nb):
            a, z = one, one
            for i in range(nb):
                if i < j:
                    a = a * G[:, :, i]
                if i > j:
                    z = z * G[:, :, i]
            pre.append(a)
            post.append(z)
        pre, post = np.stack(pre, 2)[:, :, :, None], np.stack(post, 2)[
            :, :, :, None]
        PL = (G[:, :, 0] * G[:, :, 1]) * (G[:, :, 2] * G[:, :, 3])
        rb, kb = rc.reshape(blk.shape), kc.reshape(blk.shape)
        rP = (rb * (pre * pr)).reshape(rc.shape)
        kQ = (kb * (sf * post)).reshape(kc.shape)
        g16u = np.stack([one, one, one, G[:, :, 2]], 2)[:, :, :, None]
        g16l = np.stack([G[:, :, 1], one, one, one], 2)[:, :, :, None]
        x16 = np.concatenate([(kb * (sf * g16l))[:, :, :2],
                              (rb * (g16u * pr))[:, :, 2:]], 2).reshape(
                                  rc.shape)
        x8 = np.stack([kb[:, :, 0] * sf[:, :, 0], rb[:, :, 1] * pr[:, :, 1],
                       kb[:, :, 2] * sf[:, :, 2], rb[:, :, 3] * pr[:, :, 3]],
                      2).reshape(rc.shape)
        A = np.zeros((b, h, L, L), np.float32)
        A[:, :, 16:, :16] = level(x16[:, :, 16:], x16[:, :, :16])
        A[:, :, 8:16, :8] = level(x8[:, :, 8:16], x8[:, :, :8])
        A[:, :, 24:, 16:24] = level(x8[:, :, 24:], x8[:, :, 16:24])
        # the 8-step blocks: r_t k_s prod_{s<i<t} w_i and the bonus per key
        # in float32, summed over each half of the keys, the halves added
        for j in range(nb):
            o = F32_SUB * j
            terms = np.zeros((b, h, F32_SUB, F32_SUB, kp), np.float32)
            for s_ in range(F32_SUB - 1):
                f = kc[:, :, o + s_]
                for t_ in range(s_ + 1, F32_SUB):
                    terms[:, :, t_, s_] = rc[:, :, o + t_] * f
                    f = f * wc[:, :, o + t_]
            for t_ in range(F32_SUB):
                terms[:, :, t_, t_] = rc[:, :, o + t_] * uk[:, :, 0] * \
                    kc[:, :, o + t_]
            halves = [terms[..., i * 32:(i + 1) * 32].sum(-1, dtype=np.float64
                                                          ).astype(np.float32)
                      for i in range(-(-kp // 32))]
            A[:, :, o:o + F32_SUB, o:o + F32_SUB] = np.tril(sum(halves))
        # y as the two halves' partial sums
        S_pairs = [split_pairs(rP[..., i * kh:(i + 1) * kh],
                               S[:, :, i * kh:(i + 1) * kh]) for i in (0, 1)]
        zero_y = np.zeros((b, h, L, dv), np.float32)
        yo = mma_chain(zero_y, split_pairs(A, vc))
        part = []
        for i, pairs in enumerate(S_pairs):
            yi = mma_chain(zero_y, pairs[-1:])
            yil = mma_chain(zero_y, pairs[:-1]) if small else zero_y
            rows = slice(0, 24) if i == 0 else slice(24, L)
            own = np.zeros_like(yo)
            own[:, :, rows] = yo[:, :, rows]
            part.append((yi + yil) + own)
        y[:, :, c] = part[0] + part[1]
        f = mma_chain(np.zeros_like(S), split_pairs(kQ.swapaxes(-1, -2), vc))
        S = (S.astype(np.float64) * PL[..., None] + f).astype(np.float32)
    return y.reshape(b, h, nc * L, dv)[:, :, :t]


@pytest.mark.parametrize("regime", ["moderate", "strong", "one"])
@pytest.mark.parametrize("t", [1, 37, 65, 130])
@pytest.mark.parametrize("dk", [16, 40, 64])
def test_3xtf32_arithmetic_is_float32_accurate(regime, t, dk):
    """The float32 kernel's arithmetic within TF32_BOUND of max |y| of
    wkv6_plain and of wkv6_ref, in three decay regimes; the same arithmetic
    in one pass (the lo terms dropped) misses it."""
    rng = np.random.default_rng(10)
    b, h, dv = 2, 2, 24
    r, kk, vv, _, u = rand_wkv(10, b, h, t, dk, dv)
    w = _decays(rng, (b, h, t, dk), regime)
    args = (r, kk, vv, w, u)
    plain = ops.wkv6_plain(*(torch.from_numpy(a) for a in args)).numpy()
    ref = np.asarray(wkv6_ref_jit(*(jnp.asarray(a) for a in args)))
    got3, got1 = wkv6_3xtf32(*args), wkv6_3xtf32(*args, passes=1)
    assert np.isfinite(got3).all()
    for want in (plain, ref):
        top = np.abs(want).max()
        err3, err1 = np.abs(got3 - want).max(), np.abs(got1 - want).max()
        assert err3 <= TF32_BOUND * top, (err3 / top, TF32_BOUND)
        assert err1 > TF32_BOUND * top, (err1 / top, TF32_BOUND)
