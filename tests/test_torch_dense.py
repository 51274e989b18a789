"""The dense family (gemma3-12b, phi3-mini-3.8b, qwen1.5-4b, qwen2.5-32b)
against the JAX reference, on the CPU.

Each ``SMOKE`` config takes the reference's weights (perturbed with numpy
noise, carried over with ``params_from_reference``, as
``tests/test_torch_lm.py`` does).  A prefill of 2 x 80 tokens and every
step of the teacher-forced decode over the same tokens are held to the
reference's ``prefill``/``decode_step`` (its jnp paths) within
``LOGIT_TOL`` (1e-4) of the logits, and the final caches leaf for leaf.
The caches hold 80 positions, so gemma3's local layers keep a ring of
their window's 64 slots, which wraps 16 times, beside global layers that
hold all 80.  The full-width layouts are checked on ``meta`` tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.models.lm import LM
from repro_torch.tree import leaves
from test_torch_lm import LOGIT_TOL, _close, _models, _tokens
from torch_threads import one_thread  # noqa: F401 (autouse)

DENSE = ["gemma3-12b", "phi3-mini-3.8b", "qwen1.5-4b", "qwen2.5-32b"]
BATCH, SEQ = 2, 80


@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_every_decode_step_match_ref(name):
    cfg, ref, rp, port, tp = _models(name)
    toks = _tokens(cfg, BATCH, SEQ, seed=7)
    want = jax.jit(ref.prefill)(rp, jnp.asarray(toks))
    got = port.prefill(tp, torch.from_numpy(toks))
    _close(got, want, LOGIT_TOL)

    step = jax.jit(ref.decode_step)
    rc = ref.init_cache(BATCH, SEQ, dtype=jnp.float32)
    tc = port.init_cache(BATCH, SEQ, dtype=torch.float32, device="cpu")
    for t in range(SEQ):
        rl, rc = step(rp, rc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = port.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]))
        _close(tl, rl, LOGIT_TOL)
    _close(tl, got, LOGIT_TOL)
    ref_leaves, port_leaves = jax.tree.leaves(rc), list(leaves(tc))
    assert len(ref_leaves) == len(port_leaves)
    for r_, t_ in zip(ref_leaves, port_leaves):
        assert np.shape(r_) == tuple(t_.shape)
        _close(t_, r_, LOGIT_TOL)
    if cfg.local_ratio:                  # the local rings wrapped
        assert cfg.window < SEQ
        smax = [u["k"].shape[3] for u in tc["units"]]
        assert smax == [cfg.window] * cfg.local_ratio + [SEQ]


# (name, unit, repeats, parameters, head dim)
LAYOUTS = [
    ("gemma3-12b", ["local"] * 5 + ["global"], 8, 12_772_028_160, 256),
    ("phi3-mini-3.8b", ["attn"], 32, 3_821_079_552, 96),
    ("qwen1.5-4b", ["attn"], 40, 3_950_369_280, 128),
    ("qwen2.5-32b", ["attn"], 64, 32_763_876_352, 128),
]


@pytest.mark.parametrize("name,unit,repeats,n_params,hd", LAYOUTS)
def test_dense_layout_at_full_width(name, unit, repeats, n_params, hd):
    cfg = ARCHS[name]
    model = LM(cfg)
    assert (model.unit, model.repeats, model.tail) == (unit, repeats, [])
    shapes = model.param_shapes()
    assert sum(t.numel() for t in leaves(shapes)) == n_params
    assert cfg.hd == hd
    wq = shapes["units"][0]["attn"]["wq"]
    assert tuple(wq.shape) == (repeats, cfg.d_model, cfg.n_heads, hd)
    s = 4096
    specs = model.cache_specs(1, s, torch.float32)
    for kind, spec in zip(unit, specs["units"]):
        smax = cfg.window if kind == "local" else s
        assert spec["k"][0] == (repeats, 1, cfg.n_kv_heads, smax, hd)
        assert spec["v"][0] == spec["k"][0]
