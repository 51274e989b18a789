"""Step functions: train, prefill and decode.

Port of the step builders of ``repro.launch.steps`` (``make_train_step``,
``make_prefill``, ``make_decode_step``).  PyTorch runs eagerly, so there
is nothing to jit or lower: each builder returns a plain callable.  The
reference's sharding helpers (``abstract_init``, ``param_shardings``,
``batch_shardings``, ``cache_shardings``, ``opt_state_specs``,
``build_cell``) belong to the mesh work and wait for ROADMAP Queue 1 item
5.
"""

from __future__ import annotations

import torch

from repro_torch.optim import adamw
from repro_torch.tree import leaves, unflatten


def _value_and_grad(model, params, batch, remat: bool):
    """(loss, gradient leaves) of ``model.train_loss`` at ``params``."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    try:
        loss = model.train_loss(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, ps, materialize_grads=True)
    finally:
        for p in ps:
            p.requires_grad_(False)
    return loss.detach(), grads


def make_train_step(model, opt_cfg: adamw.AdamWConfig, *,
                    microbatches: int = 1, remat: bool = True):
    """(params, opt_state, batch) -> (params', opt_state', metrics).

    The update is :func:`repro_torch.optim.adamw.apply`'s, in place: the
    returned trees are the ones passed in.  ``microbatches > 1`` splits the
    batch's leading axis and accumulates float32 gradients over the parts,
    then divides by their count, as the reference's ``lax.scan`` does.
    """

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, g = _value_and_grad(model, params, batch, remat)
        else:
            def split(x):
                return x.reshape((microbatches,
                                  x.shape[0] // microbatches) + x.shape[1:])
            parts = {k: split(v) for k, v in batch.items()}
            ps = leaves(params)
            loss = torch.zeros((), dtype=torch.float32, device=ps[0].device)
            g = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in ps]
            for i in range(microbatches):
                l_i, g_i = _value_and_grad(
                    model, params, {k: v[i] for k, v in parts.items()}, remat)
                loss = loss + l_i
                g = [a + b for a, b in zip(g, g_i)]
            loss = loss / microbatches
            g = [a / microbatches for a in g]
        grads = unflatten(params, g)
        params, opt_state, metrics = adamw.apply(opt_cfg, params, grads,
                                                 opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def make_prefill(model):
    """(params, batch) -> last-position logits: ``frames`` and ``tokens``
    for the encoder-decoder family, ``tokens`` and the VLM inputs if any
    for an LM."""
    def prefill(params, batch):
        if model.cfg.family == "encdec":
            return model.prefill(params, batch["frames"], batch["tokens"])
        return model.prefill(params, batch["tokens"],
                             batch.get("vision_embeds"),
                             batch.get("mrope_positions"))
    return prefill


def make_decode_step(model):
    """(params, caches, batch) -> (logits, caches); one signature for both
    families (an ``EncDec``'s caches carry the encoder's keys and values)."""
    def decode(params, caches, batch):
        return model.decode_step(params, caches, batch["tokens"])
    return decode
