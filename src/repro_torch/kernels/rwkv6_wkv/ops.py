"""The RWKV6 WKV CUDA kernel's wrapper and its plain versions.

Port of ``repro.kernels.rwkv6_wkv.{kernel,ops,ref}``.  Per (batch, head)
with a ``[K, V]`` float32 state S (K = key dim, V = value dim)::

    y_t = (S + diag(u) k_t v_t^T)^T r_t
    S  <- diag(w_t) S + k_t v_t^T

with a data-dependent decay ``w_t`` in [0, 1] and the head's bonus ``u``.
:func:`wkv6` dispatches on the device of its inputs: CPU tensors take
:func:`wkv6_plain` (the sequential scan of ``wkv6_ref``), CUDA tensors
launch a kernel of ``csrc/rwkv6_wkv.cu`` or raise (fake tensors, the dry
run's, which hold no data, give the output's shape and dtype and run no
scan).  Both dtypes take the chunked form on the tensor cores, every pair
of steps factored at a reference step between them, so that each decay
factor is a product of w in [0, 1]: bfloat16 in 64-step chunks, float32
in 32-step chunks with every product in 3xTF32 (each operand split into
two tf32 parts, three ``mma.sync`` a product) and the pairs closer than 8
steps taken elementwise in float32.  The kernels take any T (the TPU
launcher's ``t % chunk`` contract does not apply).
:func:`wkv6_decode` is one step of the recurrence, plain PyTorch on every
device, as the reference's ``wkv6_decode_ref``.

Its gradient is the reference's ``custom_vjp`` backward
(``repro/kernels/rwkv6_wkv/ops.py:14-29``): ``wkv6`` is a
``torch.autograd.Function`` whose backward recomputes :func:`wkv6_plain`
from the saved inputs (:func:`repro_torch.kernels._grad.plain_vjp`); there
is no backward kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import plain_vjp, shapes_only

MAX_KEY = 64             # K the kernels take


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r, k, w: [B,H,T,K]; v: [B,H,T,V]; u: [H,K] -> y [B,H,T,V] in r's
    dtype, computed in float32 by a sequential scan over T."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None, :, :, None]                       # [1,H,K,1]
    S = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    ys = []
    for i in range(t):
        kv = kf[:, :, i, :, None] * vf[:, :, i, None, :]   # [B,H,K,V]
        ys.append(((S + uf * kv) * rf[:, :, i, :, None]).sum(-2))
        S = wf[:, :, i, :, None] * S + kv
    if not ys:
        return torch.empty((b, h, 0, dv), dtype=r.dtype, device=r.device)
    return torch.stack(ys, dim=2).to(r.dtype)


def wkv6_decode(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  r, k, w: [B,H,K]; v: [B,H,V]; u: [H,K];
    state: [B,H,K,V] -> (y [B,H,V] in r's dtype, new state in the
    state's dtype)."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    sf = state.float()
    kv = kf[..., :, None] * vf[..., None, :]               # [B,H,K,V]
    y = ((sf + u.float()[None, :, :, None] * kv) * rf[..., :, None]).sum(-2)
    new_s = wf[..., :, None] * sf + kv
    return y.to(r.dtype), new_s.to(state.dtype)


def _check(r, k, v, w, u) -> None:
    if r.dim() != 4 or v.dim() != 4 or u.dim() != 2:
        raise ValueError("wkv6: expected r, k, w [B,H,T,K], v [B,H,T,V], "
                         "u [H,K]")
    b, h, t, dk = r.shape
    if k.shape != r.shape or w.shape != r.shape or \
            tuple(v.shape[:3]) != (b, h, t) or tuple(u.shape) != (h, dk):
        raise ValueError(f"wkv6: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)} do not match")
    for name, tn in (("k", k), ("v", v), ("w", w), ("u", u)):
        if tn.device != r.device:
            raise ValueError(f"wkv6: {name} is on {tn.device}, r on "
                             f"{r.device}")


def _forward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """CPU: :func:`wkv6_plain`; CUDA: the kernel or raise; fake
    tensors: the output's shape and dtype."""
    dev = r.device
    if shapes_only(r):
        return r.new_empty(tuple(r.shape[:3]) + (v.shape[-1],))
    if dev.type == "cpu":
        return wkv6_plain(r, k, v, w, u)
    if dev.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {dev}")
    code = _build.dtype_code(r.dtype)
    if code is None:
        raise ValueError(f"wkv6: the kernel takes float32 or bfloat16, got "
                         f"{r.dtype}")
    for name, tn in (("k", k), ("v", v), ("w", w)):
        if tn.dtype != r.dtype:
            raise ValueError(f"wkv6: {name} is {tn.dtype}, r is {r.dtype}")
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if not 1 <= dk <= MAX_KEY:
        raise ValueError(f"wkv6: key dim {dk} outside the kernel's "
                         f"1..{MAX_KEY}")
    r, k, v, w = (a.contiguous() for a in (r, k, v, w))
    u32 = u.float().contiguous()
    y = torch.empty((b, h, t, dv), dtype=r.dtype, device=dev)
    if y.numel() == 0:
        return y
    lib = _build.build().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rwkv6_wkv_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u32.data_ptr(), y.data_ptr(), b, h, t, dk, dv, code, stream)
    if err != 0:
        raise RuntimeError(f"wkv6: kernel launch failed with CUDA error "
                           f"{err}")
    wkv6.launches += 1
    return y


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return _forward(r, k, v, w, u)

    @staticmethod
    def backward(ctx, grad_out):
        return plain_vjp(wkv6_plain, ctx.saved_tensors, ctx.needs_input_grad,
                         grad_out)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> torch.Tensor:
    """RWKV6 token mixing -> y [B,H,T,V] in r's dtype.  CPU:
    :func:`wkv6_plain`; CUDA: the kernel (r, k, v, w of one dtype, float32
    or bfloat16, K <= MAX_KEY; u is read as float32).  The gradient
    recomputes :func:`wkv6_plain` (u's sums over the batch)."""
    _check(r, k, v, w, u)
    return _WKV6.apply(r, k, v, w, u)


wkv6.launches = 0
