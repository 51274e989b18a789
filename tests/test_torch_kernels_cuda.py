"""The port's float kernels and the staged ``paxos_propose`` entry against
their plain versions on a CUDA card.

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
from repro_torch.kernels.paxos_propose import ops as pp
from repro_torch.kernels.rwkv6_wkv import ops as wk

pytestmark = pytest.mark.cuda

# atol = rtol, as tests/test_kernels_attention.py holds bf16; the SSD and
# the WKV against max |plain output|
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
    (1, 2, 2, 37, 50, 30, dict(causal=True)),   # D % 4 != 0: plain loads
    (1, 8, 8, 129, 129, 112, dict(causal=True, window=70)),  # window edge
    (1, 4, 4, 512, 512, 112, dict(causal=True)),              # zamba2's
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
    (1, 65, 8, 64, 1, 64),      # ragged by one step against 64-step chunks
    (1, 4097, 4, 64, 1, 64),
    (1, 300, 4, 64, 2, 128),    # the largest state
    (1, 256, 8, 64, 1, 64),     # zamba2's
    (2, 1024, 112, 64, 1, 64),  # zamba2-7b's train step, B = 2
    (1, 65, 4, 37, 2, 30),      # P, N % 4 != 0: plain loads, odd P
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


def _wkv_decays(rng, shape, regime):
    """exp(-exp(x)) as the model makes them: x uniform on [-6, 1]
    ("moderate", 0.066 .. 0.9975), on [-1, 5] ("strong": about 6 % of them
    underflow to exactly 0), or w = 1 exactly ("one": the state never
    decays and grows largest)."""
    if regime == "one":
        return np.ones(shape, np.float32)
    lo, hi = {"moderate": (-6.0, 1.0), "strong": (-1.0, 5.0)}[regime]
    return np.exp(-np.exp(rng.uniform(lo, hi, shape))).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,t,k,v,regime", [
    (1, 64, 4096, 64, 64, "moderate"),   # rwkv6-7b's prefill
    (2, 4, 37, 32, 32, "moderate"),      # the smoke config's
    (1, 3, 1, 64, 64, "moderate"),
    (1, 2, 1000, 64, 48, "moderate"),    # ragged V
    (2, 2, 70, 20, 100, "moderate"),     # ragged K, V past one block
    (1, 8, 65, 64, 64, "moderate"),      # ragged by one chunk step
    (1, 8, 4097, 64, 64, "moderate"),
    (1, 8, 300, 40, 64, "moderate"),     # K not a multiple of 16
    (1, 8, 1000, 64, 64, "strong"),      # exact zero decays
    (1, 8, 4096, 64, 64, "one"),         # no decay over 4096 steps
    (2, 64, 1024, 64, 64, "moderate"),   # rwkv6-7b's train step
    (1, 32, 1024, 64, 64, "moderate"),   # a rank's head block of it
])
def test_wkv6_matches_plain(card, dtype, b, h, t, k, v, regime):
    rng = np.random.default_rng(2)
    td = getattr(torch, dtype)
    r = _randn(rng, (b, h, t, k), td, card)
    kk = _randn(rng, (b, h, t, k), td, card)
    vv = _randn(rng, (b, h, t, v), td, card)
    w = torch.from_numpy(_wkv_decays(rng, (b, h, t, k), regime)).to(card, td)
    u = _randn(rng, (h, k), torch.float32, card)
    before = wk.wkv6.launches
    got = wk.wkv6(r, kk, vv, w, u).float()
    want = wk.wkv6_plain(r, kk, vv, w, u).float()
    assert wk.wkv6.launches == before + 1
    assert bool(got.isfinite().all())
    assert ((got - want).abs().max() / want.abs().max()).item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_is_deterministic_and_blockwise(card, dtype):
    """Equal inputs give equal bits, and a rank's block of heads (batch 1,
    heads 32 .. 63 of rwkv6-7b's train step) gives the same bits as those
    heads of the whole call: no sum depends on B, H or the grid."""
    rng = np.random.default_rng(6)
    td = getattr(torch, dtype)
    b, h, t, k, v = 2, 64, 1024, 64, 64
    r = _randn(rng, (b, h, t, k), td, card)
    kk = _randn(rng, (b, h, t, k), td, card)
    vv = _randn(rng, (b, h, t, v), td, card)
    w = torch.from_numpy(_wkv_decays(rng, (b, h, t, k), "moderate")).to(
        card, td)
    u = _randn(rng, (h, k), torch.float32, card)
    whole = wk.wkv6(r, kk, vv, w, u)
    assert torch.equal(wk.wkv6(r, kk, vv, w, u), whole)
    part = [a[1:, 32:].clone() for a in (r, kk, vv, w)]
    block = wk.wkv6(*part, u[32:].clone())
    assert torch.equal(block, whole[1:, 32:])


# the gradients: each Function's backward recomputes the plain version, so
# its gradients are the plain version's own autograd up to the order of
# float32 sums (1e-5 relative to each gradient's largest magnitude); the
# forward launches the kernel once
GRAD_TOL = 1e-5


def _grads_vs_plain(wrapper, plain, inputs, kw, dtype):
    """(forward error, worst gradient error), both relative to max |plain|,
    and the launches the wrapper counted."""
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    ref = [t.detach().clone().requires_grad_(True) for t in inputs]
    before = wrapper.launches
    out = wrapper(*ins, **kw)
    launched = wrapper.launches - before
    want = plain(*ref, **kw)
    g_out = torch.randn(want.shape, generator=torch.Generator(
        device=want.device).manual_seed(7), device=want.device).to(dtype)
    got_g = torch.autograd.grad(out, ins, g_out)
    want_g = torch.autograd.grad(want, ref, g_out)
    fwd = float((out - want).detach().abs().max() / want.detach().abs().max())
    worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(got_g, want_g))
    for a, b in zip(got_g, want_g):
        assert a.shape == b.shape and a.dtype == b.dtype
    return fwd, worst, launched


@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (1, 4, 4, 130, 112, None),        # zamba2's head dim, ragged S
    (2, 8, 2, 97, 64, 33),            # GQA and a window
])
def test_flash_attention_grads_match_plain(card, b, hq, hkv, s, d, window):
    rng = np.random.default_rng(3)
    q = _randn(rng, (b, hq, s, d), torch.float32, card)
    k = _randn(rng, (b, hkv, s, d), torch.float32, card)
    v = _randn(rng, (b, hkv, s, d), torch.float32, card)
    fwd, worst, launched = _grads_vs_plain(
        fa.flash_attention, fa.attention_plain, (q, k, v),
        dict(causal=True, window=window), torch.float32)
    assert launched == 1
    assert fwd <= TOL["float32"] and worst <= GRAD_TOL


def test_ssd_grads_match_plain(card):
    rng = np.random.default_rng(4)
    b, t, h, p, g, n = 2, 70, 6, 16, 2, 8
    x = _randn(rng, (b, t, h, p), torch.float32, card)
    dt = torch.nn.functional.softplus(_randn(rng, (b, t, h), torch.float32,
                                             card))
    A = -torch.exp(_randn(rng, (h,), torch.float32, card))
    Bm = _randn(rng, (b, t, g, n), torch.float32, card)
    Cm = _randn(rng, (b, t, g, n), torch.float32, card)
    fwd, worst, launched = _grads_vs_plain(sd.ssd, sd.ssd_plain,
                                           (x, dt, A, Bm, Cm), {},
                                           torch.float32)
    assert launched == 1
    assert fwd <= TOL["float32"] and worst <= GRAD_TOL


def test_wkv6_grads_match_plain(card):
    rng = np.random.default_rng(5)
    b, h, t, k, v = 2, 3, 50, 16, 24
    r = _randn(rng, (b, h, t, k), torch.float32, card)
    kk = _randn(rng, (b, h, t, k), torch.float32, card)
    vv = _randn(rng, (b, h, t, v), torch.float32, card)
    w = torch.from_numpy(_wkv_decays(rng, (b, h, t, k), "moderate")).to(card)
    u = _randn(rng, (h, k), torch.float32, card)
    fwd, worst, launched = _grads_vs_plain(wk.wkv6, wk.wkv6_plain,
                                           (r, kk, vv, w, u), {},
                                           torch.float32)
    assert launched == 1
    assert fwd <= TOL["float32"] and worst <= GRAD_TOL


def test_unsupported_inputs_raise(card):
    q = torch.zeros((1, 2, 4, 8), device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 4, 300), device=card)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    r = torch.zeros((1, 2, 4, 128), device=card)
    with pytest.raises(ValueError, match="key dim"):
        wk.wkv6(r, r, r, r, torch.zeros((2, 128), device=card))
    r = torch.zeros((1, 2, 4, 8), device=card)
    with pytest.raises(ValueError, match="bfloat16"):
        wk.wkv6(r, r, r.bfloat16(), r, torch.zeros((2, 8), device=card))


def _propose_inputs(rng, m, s, dev):
    """A (65, m*s) table, (13, m*s) replies (a third idle) and a (4, m)
    block of mixed quorum parameters, in ranges that reach every
    decision."""
    n = m * s
    tab = rng.integers(-1, 5, (pp.N_TAB, n), dtype=np.int32)
    tab[0] = rng.integers(0, 5, n)                            # phase
    rep = rng.integers(-1, 6, (pp.N_IREP, n), dtype=np.int32)
    rep[0] = rng.choice(np.array([-1, -1, -1, 3, 4, 5, 7, 9, 11]), n)
    rep[1] = rng.integers(0, 12, n)                           # opcode
    rep[2] = rng.integers(-1, 9, n)                           # src
    rep[3] = rng.integers(0, 2, n)                            # lid
    n_machines = rng.choice(np.array([3, 5, 7]), m)
    majority = n_machines // 2 + 1
    params = np.stack([n_machines, majority,
                       np.where(rng.random(m) < 0.5, 1, majority - 1),
                       rng.integers(1, 5, m)]).astype(np.int32)
    return (torch.from_numpy(t).to(dev) for t in (tab, rep, params))


@pytest.mark.parametrize("m,s,n_staged", [
    (5, 800, 1), (5, 800, 19), (5, 800, 4000),    # the serve stack
    (3, 1667, 777), (12289, 1, 4099),             # ragged counts
])
def test_propose_staged_matches_plain(card, m, s, n_staged):
    rng = np.random.default_rng(n_staged)
    tab, rep, params = _propose_inputs(rng, m, s, card)
    idx = rng.permutation(m * s)[:n_staged]
    coords = np.stack([idx // s, idx % s]).astype(np.int32)
    staged = torch.cat([torch.from_numpy(coords).to(card),
                        rep[:, torch.from_numpy(idx).to(card)]]).contiguous()
    got_tab, want_tab = tab.clone(), tab.clone()
    before = pp.paxos_propose.launches
    got = pp.paxos_propose_staged(got_tab, staged, params, s, coords=coords)
    want = pp.paxos_propose_staged_plain(want_tab, staged, params, s)
    assert pp.paxos_propose.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got_tab, want_tab)            # the whole table
    if n_staged == m * s:
        whole_tab, whole_act = pp.paxos_propose(tab, rep, params, s)
        assert torch.equal(got_tab, whole_tab)
        assert torch.equal(got[:pp.N_ACT], whole_act[:, idx])


def test_propose_staged_refuses_without_host_coords(card):
    rng = np.random.default_rng(0)
    tab, rep, params = _propose_inputs(rng, 2, 4, card)
    staged = torch.cat([torch.zeros((2, 1), dtype=torch.int32, device=card),
                        rep[:, :1]]).contiguous()
    with pytest.raises(ValueError, match="coords"):
        pp.paxos_propose_staged(tab, staged, params, 4)
    with pytest.raises(ValueError, match="twice"):
        pp.paxos_propose_staged(
            tab, torch.cat([staged, staged], 1).contiguous(), params, 4,
            coords=np.zeros((2, 2), np.int32))
