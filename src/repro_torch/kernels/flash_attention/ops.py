"""The flash-attention CUDA kernel's wrapper and its plain versions.

Port of ``repro.kernels.flash_attention.{kernel,ops,ref}``.
:func:`flash_attention` is the attention of every full-sequence forward
(prefill, and the attention layers of the model zoo).  It dispatches on
the device of its inputs: CPU tensors take :func:`attention_plain`
(``attention_ref``'s semantics and cast order), CUDA tensors launch the
kernel of ``csrc/flash_attention.cu`` or raise.  The kernel takes any
``Sq`` and ``Sk`` (the TPU launcher's ``% 128`` tiling contract does not
apply), head dims up to 256, float32 and bfloat16, and accumulates in
float32, both on the tensor cores (``mma.sync``): bfloat16 rounding the
probabilities to bfloat16 before the value product as
:func:`attention_plain` does; float32 as 3xTF32, each operand split into
a TF32 high part and a TF32 remainder and each product taken as three
TF32 products, which keeps float32's accuracy.

Its gradient is the reference's ``custom_vjp`` backward
(``repro/kernels/flash_attention/ops.py:25-43``): ``flash_attention`` is a
``torch.autograd.Function`` whose forward is the dispatch above and whose
backward recomputes :func:`attention_plain` from the saved inputs
(:func:`repro_torch.kernels._grad.plain_vjp`); there is no backward kernel.

:func:`decode_attention` (one query token against a padded cache) stays
plain PyTorch on every device, as the reference computes it outside any
Pallas kernel, also over a cache whose slots are split across ranks.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import plain_vjp

MAX_HEAD_DIM = 256


def _scale(d: int, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / (d ** 0.5)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention, ``attention_ref``'s cast order.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D] with Hq % Hkv == 0 (GQA).
    Queries sit at the end of the key timeline; ``window`` W lets query t
    see keys in (t - W, t].  Logits and sums are float32; the probabilities
    are cast to q's dtype before the value product, as the reference does.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    qf = q * torch.tensor(_scale(d, scale), dtype=q.dtype)
    kf, vf = k, v
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf.float(), kf.float())
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs.masked_fill(~mask, 0.0)
    denom = probs.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype).float(),
                       vf.float()) / denom
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     scale: Optional[float] = None,
                     all_reduce: Optional[Callable[[torch.Tensor, str],
                                                   torch.Tensor]] = None
                     ) -> torch.Tensor:
    """Single-token decode against a padded KV cache, in float32.

    q: [B, Hq, D]; k, v: [B, Hkv, S, D]; lengths: [B] valid cache lengths.

    A cache whose slots are split in blocks across ranks (sequence
    parallelism) gives each rank its block, ``lengths`` less the block's
    first slot, and ``all_reduce(t, op)``, which combines ``t`` with the
    other blocks' ranks by ``op`` ("max" or "sum"): the logits take the
    max over all blocks (an all-reduce of [B, Hq, 1]), then the weighted
    values and their weights add over the blocks (one all-reduce of
    [B, Hq, D + 1]), the flash-decoding combine.  A block with no valid
    slot adds zeros.  The weights are those of the whole cache; only the
    sums' order differs.
    """
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    qf = q.float() * _scale(d, scale)
    kf, vf = k.float(), v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhd,bhkd->bhk", qf, kf)
    mask = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    logits = logits.masked_fill(~mask[:, None, :], float("-inf"))
    reduce = all_reduce or (lambda t, op: t)
    top = reduce(logits.amax(-1, keepdim=True), "max")
    probs = torch.exp(logits - top)
    probs = probs.masked_fill(~mask[:, None, :], 0.0)
    part = reduce(torch.cat([torch.einsum("bhk,bhkd->bhd", probs, vf),
                             probs.sum(-1, keepdim=True)], -1), "sum")
    return (part[..., :d] / part[..., d:]).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be a 4-D tensor")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, q is "
                             f"{q.dtype}")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"match as [B,Hq,Sq,D] / [B,Hkv,Sk,D]")
    if k.shape[1] == 0 or hq % k.shape[1] != 0:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={k.shape[1]}")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: Optional[int],
             scale: Optional[float]) -> torch.Tensor:
    """CPU: :func:`attention_plain`; CUDA: the kernel or raise."""
    dev = q.device
    if dev.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    code = _build.dtype_code(q.dtype)
    if code is None:
        raise ValueError(f"flash_attention: the kernel takes float32 or "
                         f"bfloat16, got {q.dtype}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} outside the "
                         f"kernel's 1..{MAX_HEAD_DIM}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.build().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, sk, d, int(bool(causal)),
            -1 if window is None else int(window), _scale(d, scale), code,
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, scale=scale)
        return _forward(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, grad_out):
        return plain_vjp(attention_plain, ctx.saved_tensors,
                         ctx.needs_input_grad[:3], grad_out,
                         **ctx.kw) + (None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention forward, q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D] -> [B,Hq,Sq,D]
    in q's dtype.  CPU: :func:`attention_plain`; CUDA: the kernel.  The
    gradient recomputes :func:`attention_plain` (k and v's come back as
    [B,Hkv,Sk,D] under GQA)."""
    _check(q, k, v)
    return _FlashAttention.apply(q, k, v, causal, window, scale)


flash_attention.launches = 0
