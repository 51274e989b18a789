"""The port's encoder-decoder (whisper-large-v3's smoke config) against
the JAX reference, on the CPU.

Weights come from the reference (perturbed, carried over with
``params_from_reference``); frames and tokens from numpy with a seed,
shaped by ``input_specs``.  The decode steps run with the cross caches
filled from ``_enc_kv`` of the encoder's output, as a served request
would.  Tolerances: ``BLOCK_TOL`` (2e-5) for blocks and the encoder,
``LOGIT_TOL`` (1e-4) for logits and losses.

The reference's decode rotates the decoder's self-attention by RoPE and
its prefill does not (ROADMAP, Queue 3); the port keeps that, and
``test_prefill_differs_from_decode_as_the_reference_does`` pins it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as ref_blocks
from repro.serve.engine import DecodeEngine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.configs.shapes import Shape
from repro_torch.launch import steps
from repro_torch.models import blocks
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import input_specs
from repro_torch.models.whisper import EncDec
from repro_torch.serve.engine import DecodeEngine, ServeConfig
from repro_torch.tree import leaves
from test_torch_lm import (
    BLOCK_TOL, LOGIT_TOL, _cfg, _close, _jnp, _models, _ref_init, _tokens,
    _torch, _x,
)
from torch_threads import one_thread  # noqa: F401 (autouse)

WHISPER = "whisper-large-v3"


def _inputs(cfg, b, s, seed):
    spec = input_specs(cfg, Shape("smoke", s, b, "prefill"), torch.float32)
    assert spec["frames"] == ((b, cfg.enc_seq, cfg.d_model), torch.float32)
    assert spec["tokens"] == ((b, s), torch.int32)
    return _x(seed, *spec["frames"][0]), _tokens(cfg, b, s, seed + 1)


def _ref_caches(ref, rp, rcfg, enc_out, b, s):
    """The reference's caches with ``cross`` from ``_enc_kv``."""
    caches = ref.init_cache(b, s, dtype=jnp.float32)
    ks, vs = [], []
    for i in range(rcfg.n_layers):
        layer = jax.tree.map(lambda a: a[i], rp["dec"])
        k, v = ref._enc_kv(rcfg, layer, enc_out)
        ks.append(k)
        vs.append(v)
    caches["cross"] = {"k": jnp.stack(ks), "v": jnp.stack(vs)}
    return caches


def _port_caches(port, tp, enc_out, b, s):
    caches = port.init_cache(b, s, dtype=torch.float32, device="cpu")
    for i in range(port.cfg.n_layers):
        layer = jax.tree.map(lambda a: a[i], tp["dec"])
        k, v = port._enc_kv(port.cfg, layer, enc_out)
        caches["cross"]["k"][i] = k
        caches["cross"]["v"][i] = v
    return caches


def test_layout_and_cache_specs_match_ref():
    cfg, ref, rp, port, tp = _models(WHISPER)
    assert isinstance(port, EncDec)
    assert set(tp) == {"embed", "pos_dec", "pos_enc", "enc", "dec",
                       "enc_norm", "final_norm"}
    assert set(tp["dec"]) == {"self_attn", "cross_attn", "mlp"}
    got = port.cache_specs(2, 24, torch.float32)
    want = ref.cache_specs(2, 24, jnp.float32)
    assert set(got) == set(want) == {"self", "cross"}
    for part in ("self", "cross"):
        assert {k: v[0] for k, v in got[part].items()} == \
            {k: v.shape for k, v in want[part].items()}


def test_encoder_matches_ref():
    cfg, ref, rp, port, tp = _models(WHISPER)
    frames, _ = _inputs(cfg, 2, 8, 40)
    _close(port.encode(tp, torch.from_numpy(frames)),
           jax.jit(ref.encode)(rp, jnp.asarray(frames)), BLOCK_TOL)


@pytest.mark.parametrize("sq", [1, 12])
def test_cross_attention_matches_ref(sq):
    cfg, rcfg = _cfg(WHISPER)
    p = _ref_init(ref_blocks.init_attention, rcfg, 41)
    x = _x(42, 2, sq, cfg.d_model)
    k, v = _x(43, 2, cfg.n_kv_heads, cfg.enc_seq, cfg.hd), \
        _x(44, 2, cfg.n_kv_heads, cfg.enc_seq, cfg.hd)
    want = ref_blocks.apply_attention(
        rcfg, _jnp(p), jnp.asarray(x), positions=None, causal=False,
        kv=(jnp.asarray(k), jnp.asarray(v)))
    got = blocks.apply_attention(
        cfg, _torch(p), torch.from_numpy(x), positions=None, causal=False,
        kv=(torch.from_numpy(k), torch.from_numpy(v)))
    _close(got, want, BLOCK_TOL)


def test_prefill_and_decode_match_ref():
    cfg, ref, rp, port, tp = _models(WHISPER)
    rcfg = ref.cfg
    b, s = 2, 12
    frames, toks = _inputs(cfg, b, s, 45)
    want = jax.jit(ref.prefill)(rp, jnp.asarray(frames), jnp.asarray(toks))
    got = steps.make_prefill(port)(tp, {"frames": torch.from_numpy(frames),
                                        "tokens": torch.from_numpy(toks)})
    _close(got, want, LOGIT_TOL)
    renc = jax.jit(ref.encode)(rp, jnp.asarray(frames))
    tenc = port.encode(tp, torch.from_numpy(frames))
    rc = _ref_caches(ref, rp, rcfg, renc, b, 16)
    tc = _port_caches(port, tp, tenc, b, 16)
    step = jax.jit(ref.decode_step)
    decode = steps.make_decode_step(port)
    for t in range(2):
        rl, rc = step(rp, rc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = decode(tp, tc, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        _close(tl, rl, LOGIT_TOL)
    for r_, t_ in zip(jax.tree.leaves(rc), leaves(tc)):
        assert np.shape(r_) == tuple(t_.shape)
        _close(t_, r_, LOGIT_TOL)


def test_train_loss_matches_ref():
    cfg, ref, rp, port, tp = _models(WHISPER)
    frames, toks = _inputs(cfg, 2, 10, 46)
    want = jax.jit(ref.train_loss)(rp, {"frames": jnp.asarray(frames),
                                        "tokens": jnp.asarray(toks)})
    for remat in (True, False):
        got = port.train_loss(tp, {"frames": torch.from_numpy(frames),
                                   "tokens": torch.from_numpy(toks)},
                              remat=remat)
        _close(got, want, LOGIT_TOL)


def _prefill_vs_decode(ref_side, model, params, frames, toks, caches_fn):
    """max |prefill - teacher-forced decode| over max |prefill|, at the
    last position."""
    b, s = toks.shape
    if ref_side:
        want = model.prefill(params, jnp.asarray(frames), jnp.asarray(toks))
        caches = caches_fn(model.encode(params, jnp.asarray(frames)))
        for t in range(s):
            last, caches = model.decode_step(params, caches,
                                             jnp.asarray(toks[:, t:t + 1]))
    else:
        want = model.prefill(params, torch.from_numpy(frames),
                             torch.from_numpy(toks))
        caches = caches_fn(model.encode(params, torch.from_numpy(frames)))
        for t in range(s):
            last, caches = model.decode_step(params, caches,
                                             torch.from_numpy(toks[:, t:t + 1]))
    want, last = np.asarray(want), np.asarray(last)
    return float(np.abs(last - want).max() / np.abs(want).max())


def test_prefill_differs_from_decode_as_the_reference_does(monkeypatch):
    cfg, ref, rp, port, tp = _models(WHISPER)
    b, s = 2, 12
    frames, toks = _inputs(cfg, b, s, 47)

    def both():
        r = _prefill_vs_decode(True, ref, rp, frames, toks,
                               lambda e: _ref_caches(ref, rp, ref.cfg, e,
                                                     b, 16))
        t = _prefill_vs_decode(False, port, tp, frames, toks,
                               lambda e: _port_caches(port, tp, e, b, 16))
        return r, t

    # the decode's RoPE makes them differ, in both packages alike
    r, t = both()
    assert r > 1e-3 and t > 1e-3
    assert abs(t / r - 1) < 1e-2
    # with the rotation skipped in both decodes they agree
    monkeypatch.setattr(ref_blocks, "_rope_qk",
                        lambda cfg, q, k, *a, **kw: (q, k))
    monkeypatch.setattr(blocks, "_rope_qk",
                        lambda cfg, q, k, *a, **kw: (q, k))
    r, t = both()
    assert r <= 1e-5 and t <= 1e-5


def test_generate_matches_ref():
    cfg, ref, rp, port, tp = _models(WHISPER, seed=7)
    rng = np.random.default_rng(8)
    prompts = [list(rng.integers(1, cfg.vocab, int(rng.integers(3, 8))))
               for _ in range(3)]
    want = RefEngine(ref, rp, RefServeConfig(max_seq=32)).generate(
        prompts, steps=6)
    got = DecodeEngine(port, tp, ServeConfig(max_seq=32),
                       device="cpu").generate(prompts, steps=6)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    assert np.array_equal(got, want)


def test_params_from_reference_checks_encdec_trees():
    cfg, ref, rp, port, tp = _models(WHISPER)
    tree = jax.tree.map(np.asarray, rp)
    good = tree["pos_enc"]
    tree["pos_enc"] = good[:-1]
    with pytest.raises(ValueError, match="pos_enc"):
        params_from_reference(cfg, tree, device="cpu")
    tree["pos_enc"] = good
    del tree["dec"]["cross_attn"]
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(cfg, tree, device="cpu")
