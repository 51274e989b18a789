"""The port's MoE layers (mixtral-8x7b, kimi-k2) against the JAX reference,
on the CPU.

Weights are drawn by the reference, perturbed with numpy noise and carried
over with ``params_from_reference`` (as ``tests/test_torch_lm.py`` does);
inputs are numpy draws from a seed.  The reference runs its jnp paths
(``impl="xla"``) with no mesh, so its ``apply_moe`` takes
``apply_moe_spmd`` for both ``moe_impl``s, as the port always does.  The
expert indices compare exactly; outputs within ``BLOCK_TOL`` (2e-5) for a
block and ``LOGIT_TOL`` (1e-4) for logits, losses and gradients (the
latter relative to their largest magnitude).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.coord.registry import PaxosRegistry as RefRegistry
from repro.models import blocks as ref_blocks
from repro.serve.engine import DecodeEngine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.coord.registry import PaxosRegistry
from repro_torch.models import blocks
from repro_torch.models.convert import params_from_reference
from repro_torch.serve.engine import DecodeEngine, ServeConfig
from repro_torch.tree import leaves
from test_torch_lm import (
    BLOCK_TOL, LOGIT_TOL, _cfg, _close, _jnp, _models, _ref_init, _tokens,
    _torch, _x,
)
from torch_threads import one_thread  # noqa: F401 (autouse)

MOE = ["mixtral-8x7b", "kimi-k2-1t-a32b"]


def _ref_route(rcfg, p, x):
    """The reference's routing of ``x``, in its own words
    (``apply_moe_spmd``'s first lines): expert ids [T, k] and the capacity
    slots' overflow count."""
    b, s, d = x.shape
    t, e, k = b * s, rcfg.n_experts, rcfg.top_k
    h = ref_blocks.norm_apply(rcfg, p["norm"], jnp.asarray(x)).reshape(t, d)
    probs = jax.nn.softmax((h @ p["router"]).astype(jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, k)
    capacity = int(t * k // e * rcfg.capacity_factor) + 1
    counts = np.bincount(np.asarray(idx).reshape(-1), minlength=e)
    return np.asarray(idx), int(np.maximum(counts - capacity, 0).sum())


def _route(cfg, p, x):
    b, s, d = x.shape
    h = blocks.norm_apply(cfg, p["norm"], torch.from_numpy(x))
    return blocks.moe_route(cfg, p["router"], h.reshape(b * s, d))


def _same_experts(got, want):
    """Expert ids equal, naming the first token whose choice differs."""
    got = got.numpy()
    bad = np.nonzero((got != want).any(-1))[0]
    assert bad.size == 0, (f"token {bad[0]}: port experts {got[bad[0]]}, "
                           f"reference {want[bad[0]]} ({bad.size} tokens "
                           f"differ)")


@pytest.mark.parametrize("impl", ["spmd", "shardmap"])
@pytest.mark.parametrize("name", MOE)
def test_moe_block_matches_ref(name, impl):
    cfg, rcfg = _cfg(name, moe_impl=impl)
    p = _ref_init(ref_blocks.init_moe, rcfg, 21)
    x = _x(22, 2, 9, cfg.d_model)
    tp = _torch(p)
    want_idx, want_drop = _ref_route(rcfg, _jnp(p), x)
    route = _route(cfg, tp, x)
    _same_experts(route.idx, want_idx)
    assert route.dropped() == want_drop
    ry, raux = ref_blocks.apply_moe(rcfg, _jnp(p), jnp.asarray(x))
    ty, taux = blocks.apply_moe(cfg, tp, torch.from_numpy(x))
    _close(ty, ry, BLOCK_TOL)
    _close(taux, raux, BLOCK_TOL)
    assert float(taux) > 0.5           # E * sum(frac * mean prob), ~1


@pytest.mark.parametrize("name", MOE)
def test_moe_overflow_drops_match_ref(name):
    # 40 tokens at capacity factor 0.5: each expert keeps t*k//e*0.5 + 1
    # slots, well under its share, so assignments overflow in both packages
    cfg, rcfg = _cfg(name, capacity_factor=0.5)
    p = _ref_init(ref_blocks.init_moe, rcfg, 23)
    x = _x(24, 2, 20, cfg.d_model)
    tp = _torch(p)
    want_idx, want_drop = _ref_route(rcfg, _jnp(p), x)
    route = _route(cfg, tp, x)
    _same_experts(route.idx, want_idx)
    assert want_drop > 0
    assert route.dropped() == want_drop
    ry, raux = ref_blocks.apply_moe(rcfg, _jnp(p), jnp.asarray(x))
    ty, taux = blocks.apply_moe(cfg, tp, torch.from_numpy(x))
    _close(ty, ry, BLOCK_TOL)
    _close(taux, raux, BLOCK_TOL)


def test_top_k_ties_go_to_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.2, 0.3, 0.2, 0.3]], np.float32)
    for k in (1, 2, 3):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = blocks._top_k(torch.from_numpy(probs), k)
        assert np.array_equal(got_i.numpy(), np.asarray(want_i))
        assert np.array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("name", MOE)
def test_prefill_and_decode_match_ref(name):
    cfg, ref, rp, port, tp = _models(name)
    b, s = 2, 10
    toks = _tokens(cfg, b, s + 2)
    want = jax.jit(ref.prefill)(rp, jnp.asarray(toks[:, :s]))
    got = port.prefill(tp, torch.from_numpy(toks[:, :s]))
    _close(got, want, LOGIT_TOL)
    # the prompt, then two more steps, each held to the reference's
    step = jax.jit(ref.decode_step)
    rc = ref.init_cache(b, 16, dtype=jnp.float32)
    tc = port.init_cache(b, 16, dtype=torch.float32, device="cpu")
    for t in range(s + 2):
        rl, rc = step(rp, rc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = port.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]))
        _close(tl, rl, LOGIT_TOL)
    for r_, t_ in zip(jax.tree.leaves(rc), leaves(tc)):
        assert np.shape(r_) == tuple(t_.shape)
        _close(t_, r_, LOGIT_TOL)


def test_mixtral_window_ring_wraps_in_decode():
    # 80 tokens through the smoke window of 64: the ring buffer wraps
    cfg, ref, rp, port, tp = _models("mixtral-8x7b", seed=2)
    toks = _tokens(cfg, 1, 80, seed=3)
    step = jax.jit(ref.decode_step)
    rc = ref.init_cache(1, 128, dtype=jnp.float32)
    tc = port.init_cache(1, 128, dtype=torch.float32, device="cpu")
    assert tuple(tc["units"][0]["k"].shape) == (3, 1, 2, 64, 32)
    for t in range(80):
        rl, rc = step(rp, rc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = port.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]))
    _close(tl, rl, LOGIT_TOL)
    # at B = 1 top-2 picks two distinct experts, so nothing drops in the
    # decode; with no drops in the prefill either it equals the decode
    big = dataclasses.replace(cfg, capacity_factor=100.0)
    port_big = type(port)(big)
    _close(port_big.prefill(tp, torch.from_numpy(toks)), tl, LOGIT_TOL)


@pytest.mark.parametrize("name", MOE)
def test_train_loss_with_aux_matches_ref(name):
    cfg, ref, rp, port, tp = _models(name)
    toks = _tokens(cfg, 2, 24, seed=4)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, t: ref.train_loss(p, {"tokens": t})))(rp, jnp.asarray(toks))
    ps = leaves(tp)
    for p in ps:
        p.requires_grad_(True)
    loss = port.train_loss(tp, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, ps)
    for p in ps:
        p.requires_grad_(False)
    _close(loss.detach(), want_loss, LOGIT_TOL)
    # the loss carries 0.01 aux, summed over the layers
    with torch.no_grad():
        x = port._embed(tp, torch.from_numpy(toks))
        pos = torch.arange(24, dtype=torch.int32).expand(2, 24)
        _, aux = port._backbone(tp, x, pos)
    assert float(aux) > cfg.n_layers * 0.5
    want = leaves(params_from_reference(
        cfg, jax.tree.map(np.asarray, want_grads), device="cpu"))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= LOGIT_TOL * float(
            w.abs().max())


def test_generate_and_route_match_ref():
    cfg, ref, rp, port, tp = _models("mixtral-8x7b", seed=5)
    rng = np.random.default_rng(6)
    prompts = [list(rng.integers(1, cfg.vocab, int(rng.integers(3, 8))))
               for _ in range(3)]
    rreg = RefRegistry(n_machines=3, all_aboard=True)
    treg = PaxosRegistry(n_machines=3, all_aboard=True)
    reng = RefEngine(ref, rp, RefServeConfig(max_seq=32), rreg, replica_id=1)
    teng = DecodeEngine(port, tp, ServeConfig(max_seq=32), treg,
                        replica_id=1, device="cpu")
    for s in (5, 6, 7):
        assert teng.route(s) == reng.route(s) == 1
    want = reng.generate(prompts, steps=6)
    got = teng.generate(prompts, steps=6)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", MOE)
def test_params_from_reference_checks_moe_trees(name):
    cfg, ref, rp, port, tp = _models(name)
    tree = jax.tree.map(np.asarray, rp)
    layer = tree["units"][0]["moe"]
    assert set(layer) == {"router", "w_gate", "w_up", "w_down", "norm"}
    assert tuple(tp["units"][0]["moe"]["w_down"].shape) == \
        layer["w_down"].shape
    good = layer["w_up"]
    layer["w_up"] = good[:, :, :-1]
    with pytest.raises(ValueError, match="w_up"):
        params_from_reference(cfg, tree, device="cpu")
    layer["w_up"] = good
    del layer["router"]
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(cfg, tree, device="cpu")
