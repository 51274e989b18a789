"""The port's AdamW against the JAX reference's, on the CPU.

Parameters and gradients are numpy draws from a seed, handed to both
packages.  Tolerance 1e-6 (absolute and relative, float32 state): the two
compute the same float32 operations, in orders that differ by at most
fused multiply-adds and the order of the global norm's sum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import store
from repro_torch.optim import adamw
from repro_torch.tree import leaves, unflatten
from torch_threads import one_thread  # noqa: F401 (autouse)

TOL = 1e-6
SHAPES = {"w": (6, 5), "units": ({"a": (4,), "b": (3, 2, 7)}, {"c": (9,)}),
          "norm": {"scale": (5,)}}


def _draw(seed, scale=1.0):
    """A numpy tree of SHAPES' structure from ``seed``."""
    rng = np.random.default_rng(seed)
    return _shape_map(lambda shape: (scale * rng.standard_normal(shape))
                      .astype(np.float32), SHAPES)


def _shape_map(fn, tree):
    """``fn`` on every shape tuple of a tree of shapes."""
    if isinstance(tree, tuple) and all(isinstance(i, int) for i in tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _shape_map(fn, v) for k, v in tree.items()}
    return tuple(_shape_map(fn, v) for v in tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, tol=TOL):
    got_l = [np.asarray(t.detach().float() if isinstance(t, torch.Tensor)
                        else t, np.float32) for t in leaves(got)]
    want_l = [np.asarray(t, np.float32) for t in jax.tree.leaves(want)]
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


CFG = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
REF_CFG = ref_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)


def test_schedule_matches_ref():
    for kw in (dict(), dict(lr=1e-2, warmup_steps=2, total_steps=10),
               dict(warmup_steps=0, total_steps=1)):
        cfg, rcfg = adamw.AdamWConfig(**kw), ref_adamw.AdamWConfig(**kw)
        steps = np.arange(0, 400, 7, dtype=np.int32)
        got = adamw.schedule(cfg, torch.from_numpy(steps))
        want = ref_adamw.schedule(rcfg, jnp.asarray(steps))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("compress", [False, True])
def test_init_matches_ref(compress):
    p = _draw(0)
    cfg = adamw.AdamWConfig(compress_grads=compress)
    state = adamw.init(cfg, _torch(p))
    want = ref_adamw.init(ref_adamw.AdamWConfig(compress_grads=compress),
                          _jnp(p))
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    assert (state.err is None) == (not compress)
    _close(state.m, want.m)
    _close(state.v, want.v)
    if compress:
        _close(state.err, want.err)
    # the same checkpoint keys, field for field (``.step``, ``.m/...``)
    assert sorted(store._flatten((_torch(p), state))) == \
        sorted(ref_store._flatten((_jnp(p), want)))


@pytest.mark.parametrize("compress", [False, True])
def test_apply_matches_ref_over_steps(compress):
    cfg = dataclasses.replace(CFG, compress_grads=compress)
    rcfg = dataclasses.replace(REF_CFG, compress_grads=compress)
    p0 = _draw(1)
    params, rparams = _torch(p0), _jnp(p0)
    state, rstate = adamw.init(cfg, params), ref_adamw.init(rcfg, rparams)
    moved = 0.0
    for i in range(4):
        # grads large enough that step 3 clips (the global norm above 1)
        g = _draw(10 + i, scale=0.05 if i < 2 else 0.5)
        ids = [id(t) for t in leaves(params)]
        params, state, m = adamw.apply(cfg, params, _torch(g), state)
        rparams, rstate, rm = ref_adamw.apply(rcfg, rparams, _jnp(g), rstate)
        assert [id(t) for t in leaves(params)] == ids       # in place
        assert int(state.step) == int(rstate.step) == i + 1
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=TOL)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]),
                                   rtol=TOL)
        _close(params, rparams)
        _close(state.m, rstate.m)
        _close(state.v, rstate.v)
        if compress:
            _close(state.err, rstate.err)
        moved = max(moved, max(float((a - torch.from_numpy(b)).abs().max())
                               for a, b in zip(leaves(params),
                                               jax.tree.leaves(p0))))
    assert moved > 100 * TOL           # the updates are visible at TOL


def test_bf16_state_matches_ref():
    """bfloat16 moments: stored rounded to bfloat16 by both packages; the
    float32 value before the rounding may differ by an ulp, so a moment
    may land one bfloat16 ulp (2^-8 relative) apart."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            state_dtype=torch.bfloat16)
    rcfg = ref_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                                 state_dtype=jnp.bfloat16)
    p0 = _draw(2)
    params, rparams = _torch(p0), _jnp(p0)
    state, rstate = adamw.init(cfg, params), ref_adamw.init(rcfg, rparams)
    for i in range(3):
        g = _draw(20 + i, scale=0.05)
        params, state, _ = adamw.apply(cfg, params, _torch(g), state)
        rparams, rstate, _ = ref_adamw.apply(rcfg, rparams, _jnp(g), rstate)
    assert all(t.dtype == torch.bfloat16 for t in leaves(state.m))
    _close(state.m, rstate.m, tol=2 ** -8)
    _close(state.v, rstate.v, tol=2 ** -8)
    _close(params, rparams, tol=1e-4)


def test_compress_decompress_and_global_norm_match_ref():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    err = (0.01 * rng.standard_normal((64, 33))).astype(np.float32)
    deq, res = adamw.compress_decompress(torch.from_numpy(g),
                                         torch.from_numpy(err))
    rdeq, rres = ref_adamw.compress_decompress(jnp.asarray(g),
                                               jnp.asarray(err))
    np.testing.assert_allclose(deq.numpy(), np.asarray(rdeq), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(res.numpy(), np.asarray(rres), atol=TOL,
                               rtol=TOL)
    # the residual is what the int8 grid lost: deq + res == g + err
    np.testing.assert_allclose(deq.numpy() + res.numpy(), g + err,
                               atol=TOL, rtol=TOL)
    # exact ties: max |g| = 127 makes the scale 1, and k + 0.5 rounds to
    # the even neighbour in both packages
    g = np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5], np.float32)
    deq, _ = adamw.compress_decompress(torch.from_numpy(g),
                                       torch.zeros(6))
    rdeq, _ = ref_adamw.compress_decompress(jnp.asarray(g), jnp.zeros(6))
    assert deq.tolist() == [127.0, 0.0, 2.0, 2.0, -2.0, -0.0]
    assert deq.tolist() == np.asarray(rdeq).tolist()
    tree = _draw(4)
    np.testing.assert_allclose(float(adamw._global_norm(_torch(tree))),
                               float(ref_adamw._global_norm(_jnp(tree))),
                               rtol=TOL)


def test_tree_helpers_follow_jax_order():
    tree = _torch(_draw(5))
    assert [tuple(t.shape) for t in leaves(tree)] == \
        [tuple(np.shape(t)) for t in jax.tree.leaves(_draw(5))]
    back = unflatten(tree, iter(leaves(tree)))
    assert list(back) == list(tree)
    assert all(a is b for a, b in zip(leaves(back), leaves(tree)))
