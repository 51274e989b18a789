"""The port's M-RoPE and VLM inputs (qwen2-vl-72b) against the JAX
reference, on the CPU.

Weights come from the reference (perturbed, carried over with
``params_from_reference``), inputs from numpy with a seed, shaped by
``input_specs`` (256 vision embeddings in front of the text).  The M-RoPE
streams follow Qwen2-VL's rule for one image: its tokens as a 16 x 16 grid
(temporal 0, height the row, width the column), then the text from 16 on
with all three streams equal, so the three streams differ.  Tolerances:
``BLOCK_TOL`` (2e-5) for blocks, ``LOGIT_TOL`` (1e-4) for logits and
losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as REF_ARCHS
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.models import blocks as ref_blocks
from repro.models import common as ref_common
from repro.models import registry as ref_registry
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.shapes import SHAPES, Shape
from repro_torch.models import blocks, common
from repro_torch.models.registry import VISION_TOKENS, input_specs
from repro_torch.tree import leaves
from test_torch_lm import (
    BLOCK_TOL, LOGIT_TOL, _cfg, _close, _jnp, _models, _ref_init, _tokens,
    _torch, _x,
)
from torch_threads import one_thread  # noqa: F401 (autouse)

VLM = "qwen2-vl-72b"


def mrope_positions(b, n_text, grid=16):
    """[3, b, grid * grid + n_text] int32: the image as a grid (t = 0,
    h = row, w = column), then the text at grid + i on all three."""
    rows, cols = np.divmod(np.arange(grid * grid), grid)
    vis = np.stack([np.zeros_like(rows), rows, cols])
    text = np.tile(grid + np.arange(n_text), (3, 1))
    pos = np.concatenate([vis, text], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, b, pos.shape[1])))


def _vlm_inputs(cfg, b, s, seed):
    spec = input_specs(cfg, Shape("smoke", s, b, "prefill"), torch.float32)
    vshape, vdtype = spec["vision_embeds"]
    assert vshape == (b, VISION_TOKENS, cfg.d_model)
    assert vdtype == torch.float32
    assert spec["mrope_positions"] == ((3, b, s + VISION_TOKENS),
                                       torch.int32)
    vis = 0.5 * _x(seed, *vshape)
    pos = mrope_positions(b, s)
    assert pos.shape == spec["mrope_positions"][0]
    assert not np.array_equal(pos[1], pos[2])
    assert not np.array_equal(pos[0], pos[1])
    return _tokens(cfg, b, s, seed + 1), vis, pos


def test_apply_mrope_matches_ref():
    x = _x(30, 2, 4, 10, 32)
    pos = np.stack([np.arange(10) // 3, np.arange(10) % 4,
                    np.arange(10)[::-1]]).astype(np.int32)
    pos = np.stack([pos, pos + 5], axis=1)                   # [3, 2, 10]
    for sections, theta in (((4, 6, 6), 1e6), ((8, 4, 4), 1e4)):
        _close(common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                                  sections, theta),
               ref_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                      sections, theta), BLOCK_TOL)
    # equal streams are plain RoPE
    same = np.ascontiguousarray(np.broadcast_to(pos[2:3], pos.shape))
    _close(common.apply_mrope(torch.from_numpy(x), torch.from_numpy(same),
                              (4, 6, 6), 1e6),
           common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[2]),
                             1e6), BLOCK_TOL)


def test_attention_block_with_mrope_matches_ref():
    cfg, rcfg = _cfg(VLM)
    p = _ref_init(ref_blocks.init_attention, rcfg, 31)
    b, s = 2, 20
    x = _x(32, b, s, cfg.d_model)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    mpos = mrope_positions(b, s - 16, grid=4)
    for mp in (None, mpos):
        want = ref_blocks.apply_attention(
            rcfg, _jnp(p), jnp.asarray(x), positions=jnp.asarray(pos),
            mrope_positions=None if mp is None else jnp.asarray(mp))
        got = blocks.apply_attention(
            cfg, _torch(p), torch.from_numpy(x),
            positions=torch.from_numpy(pos),
            mrope_positions=None if mp is None else torch.from_numpy(mp))
        _close(got, want, BLOCK_TOL)


def test_prefill_and_decode_match_ref():
    cfg, ref, rp, port, tp = _models(VLM)
    b, s = 2, 12
    toks, vis, pos = _vlm_inputs(cfg, b, s, 33)
    want = jax.jit(ref.prefill)(rp, jnp.asarray(toks), jnp.asarray(vis),
                                jnp.asarray(pos))
    got = port.prefill(tp, torch.from_numpy(toks), torch.from_numpy(vis),
                       torch.from_numpy(pos))
    _close(got, want, LOGIT_TOL)
    # M-RoPE moves the logits: the same inputs with plain RoPE differ
    plain = port.prefill(tp, torch.from_numpy(toks), torch.from_numpy(vis))
    assert float((plain - got).abs().max()) > 1e-3
    # text-only: prefill, the teacher-forced decode and two more steps
    want = jax.jit(ref.prefill)(rp, jnp.asarray(toks[:, :s - 2]))
    got = port.prefill(tp, torch.from_numpy(toks[:, :s - 2]))
    _close(got, want, LOGIT_TOL)
    step = jax.jit(ref.decode_step)
    rc = ref.init_cache(b, 16, dtype=jnp.float32)
    tc = port.init_cache(b, 16, dtype=torch.float32, device="cpu")
    for t in range(s):
        rl, rc = step(rp, rc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = port.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]))
        _close(tl, rl, LOGIT_TOL)
        if t == s - 3:
            _close(tl, got, LOGIT_TOL)
    for r_, t_ in zip(jax.tree.leaves(rc), leaves(tc)):
        _close(t_, r_, LOGIT_TOL)


def test_train_loss_with_vision_matches_ref():
    cfg, ref, rp, port, tp = _models(VLM)
    toks, vis, pos = _vlm_inputs(cfg, 2, 10, 34)
    batch = {"tokens": toks, "vision_embeds": vis, "mrope_positions": pos}
    want = jax.jit(ref.train_loss)(rp, jax.tree.map(jnp.asarray, batch))
    got = port.train_loss(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_input_specs_match_ref(name, shape):
    got = input_specs(ARCHS[name], SHAPES[shape])
    want = ref_registry.input_specs(REF_ARCHS[name], REF_SHAPES[shape])
    assert set(got) == set(want)
    for k, (shp, dt) in got.items():
        assert shp == want[k].shape
        assert str(dt).split(".")[-1] == str(want[k].dtype)
