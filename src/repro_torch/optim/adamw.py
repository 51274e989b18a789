"""AdamW with gradient clipping, a warmup-cosine schedule and an optional
int8 gradient-compression hook.

Port of ``repro.optim.adamw``, with its arithmetic: float32 moments
updates and bias corrections, the clip factor
``min(1, clip / max(norm, 1e-12))``, and ``round`` half to even for the
int8 error feedback.  ``OptState`` keeps the reference's fields, so a
checkpoint of ``(params, opt_state)`` has the same keys in both packages
(``.step``, ``.m/...``, ``.v/...``, ``.err/...``).

:func:`apply` updates the parameters and moments **in place** under
``torch.no_grad()`` and returns the same trees: at zamba2-7b's width a
functional copy would double the state at every step.  On parameters
placed as DTensors (``launch/steps.py`` ``place_cell``) the moments are
ZeRO-1: each takes its parameter's placements, so a rank holds the block
``repro_torch.launch.steps.opt_state_specs`` gives it, and the step
counter, the schedule and the global norm are replicated; the update runs
the same operations in the same order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.parallel.sharding import replicate_like
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: torch.dtype = torch.float32
    # int8 gradient compression with error feedback
    compress_grads: bool = False


class OptState(NamedTuple):
    step: torch.Tensor                  # int32, shape ()
    m: Any
    v: Any
    err: Optional[Any]                  # error-feedback residual (or None)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine decay to a tenth of it
    (float32)."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init(cfg: AdamWConfig, params) -> OptState:
    """Zero moments (and residuals) in ``cfg.state_dtype`` beside each
    parameter, with its layout; the step counter on the first parameter's
    device (replicated over its mesh)."""
    first = leaves(params)
    dev = first[0].device if first else torch.device("cpu")
    zeros = lambda p: torch.zeros_like(p, dtype=cfg.state_dtype)
    err = tree_map(zeros, params) if cfg.compress_grads else None
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if first:
        step = replicate_like(step, first[0])
    return OptState(step, tree_map(zeros, params), tree_map(zeros, params),
                    err)


def _global_norm(tree) -> torch.Tensor:
    sq = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.float()))
        sq = s if sq is None else sq + s
    if sq is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sq)


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """int8 quantize with error feedback: returns the dequantized gradient
    (in g's dtype) and the new residual (in err's dtype)."""
    gf = g.float() + err.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq.to(g.dtype), (gf - deq).to(err.dtype)


def apply(cfg: AdamWConfig, params, grads, state: OptState):
    """One AdamW update of ``params`` and ``state``'s moments in place.
    Returns ``(params, new_state, metrics)``: the same parameter and
    moment trees, a new step counter, and ``grad_norm`` and ``lr`` as
    float32 tensors."""
    with torch.no_grad():
        step = state.step + 1
        g_leaves = leaves(grads)
        if cfg.compress_grads:
            pairs = [compress_decompress(g, e) for g, e in
                     zip(g_leaves, leaves(state.err))]
            g_leaves = [p[0] for p in pairs]
            for e, (_, residual) in zip(leaves(state.err), pairs):
                e.copy_(residual)
        gnorm = _global_norm(g_leaves)
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                           max=1.0)
        lr = schedule(cfg, step)
        b1c = 1.0 - cfg.b1 ** step.float()
        b2c = 1.0 - cfg.b2 ** step.float()
        for p, g, m, v in zip(leaves(params), g_leaves, leaves(state.m),
                              leaves(state.v)):
            g = g.float() * clip
            m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
            v_new = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
            delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps) \
                + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m_new)
            v.copy_(v_new)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step, state.m, state.v, state.err), metrics
