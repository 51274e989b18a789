"""Shared model primitives: norms, RoPE and M-RoPE, positions and
parameter init.

Port of ``repro.models.common``.  Parameters are plain nested dicts of
tensors with the reference's keys and layouts; their sharding specs come
from each block's ``<block>_specs`` (``LM.param_specs``), not from here.
The init helpers draw from an explicit ``torch.Generator`` (normal with
std 0.02, zeros, ones).

On DTensors (a model placed on a ``DeviceMesh``) the rotations build their
cos and sin whole on every rank, as replicated DTensors on x's mesh;
positions stay plain tensors that every rank holds whole
(:func:`default_positions`), and M-RoPE's streams, a batch input, are
gathered whole first.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.parallel.sharding import replicate_like

Params = Dict[str, Any]


class Init:
    """Draws parameters of one dtype on one device from ``generator``.

    On the ``meta`` device nothing is drawn: the helpers return tensors
    that carry only shapes and dtypes (used to check converted weights).
    ``place``, if given, is applied to each tensor as it is made, in the
    order made, and its result takes the tensor's place in the tree
    (``launch/steps.init_placed`` puts each leaf on a mesh, so the whole
    tree is never held at once).
    """

    def __init__(self, generator: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device,
                 place: Optional[Callable[[torch.Tensor], Any]] = None):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)
        self.place = place

    def _made(self, t: torch.Tensor):
        return t if self.place is None else self.place(t)

    def normal(self, shape: Sequence[int], *, std: float = 0.02
               ) -> torch.Tensor:
        if self.device.type == "meta":
            return self._made(torch.empty(tuple(shape), dtype=self.dtype,
                                          device=self.device))
        t = torch.randn(tuple(shape), generator=self.generator,
                        device=self.device, dtype=torch.float32)
        return self._made(t.mul_(std).to(self.dtype))

    def zeros(self, shape: Sequence[int]) -> torch.Tensor:
        return self._made(torch.zeros(tuple(shape), dtype=self.dtype,
                                      device=self.device))

    def ones(self, shape: Sequence[int]) -> torch.Tensor:
        return self._made(torch.ones(tuple(shape), dtype=self.dtype,
                                     device=self.device))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: the variance reduction in float32, the multiply in x's
    dtype (``inv`` is cast to x's dtype first, as the reference does).  On
    a DTensor whose last dim a mesh dim splits (RWKV6's ``ln_x`` and
    Mamba2's gate norm over heads) the variance's partial sums are
    all-reduced at [..., 1]; DTensor alone reduce-scatters them over
    another dim and gathers them back."""
    xf = x.float()
    if isinstance(x, DTensor) and any(p.is_shard(x.dim() - 1)
                                      for p in x.placements):
        # the partial sums' gradient comes back a partial sum: a sum here,
        # not a mean, whose partial average the way back cannot take
        var = (xf * xf).sum(-1, keepdim=True)
        var = var.redistribute(var.device_mesh, [
            Replicate() if p.is_partial() else p for p in var.placements])
        var = var / x.shape[-1]
    else:
        var = (xf * xf).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax`` over the last dim: x less its max (held
    constant), less the log of the sum of the exps.  Written out, it runs
    on a DTensor over "vocab" as reductions over the sharded dim, which
    DTensor all-reduces at [..., 1]; ``torch.log_softmax`` gathers the
    logits first."""
    shifted = x - x.amax(-1, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(-1, keepdim=True))


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [B, H, S, D]; positions: [B, S] int.  Angles in float32, cast to
    x's dtype before the rotation."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                      # [D/2]
    ang = positions[:, None, :, None].float() * freqs           # [B,1,S,D/2]
    cos = replicate_like(torch.cos(ang).to(x.dtype), x)
    sin = replicate_like(torch.sin(ang).to(x.dtype), x)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Sequence[int],
                theta: float = 1000000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: [B, H, S, D]; positions3: [3, B, S]
    int, the (temporal, height, width) streams.  The head dim's D/2
    frequency slots are split into ``sections`` (summing to D/2), each
    rotated by its own stream.  Angles in float32, cast to x's dtype
    before the rotation, as :func:`apply_rope`."""
    d = x.shape[-1]
    half = d // 2
    assert sum(sections) == half, (sections, d)
    freqs = rope_freqs(d, theta, x.device)                      # [half]
    if isinstance(positions3, DTensor):
        positions3 = positions3.full_tensor()
    sec_id = torch.cat([torch.full((s,), i, dtype=torch.long,
                                   device=x.device)
                        for i, s in enumerate(sections)])
    pos = positions3[sec_id]                                    # [half,B,S]
    ang = pos.permute(1, 2, 0).float() * freqs                  # [B,S,half]
    # [B, 1, S, half]
    cos = replicate_like(torch.cos(ang)[:, None].to(x.dtype), x)
    sin = replicate_like(torch.sin(ang)[:, None].to(x.dtype), x)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def default_positions(b: int, s: int, offset=0,
                      device: Optional[torch.device] = None) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :] + \
        offset + torch.zeros((b, 1), dtype=torch.int32, device=device)
