"""The Mamba2 SSD CUDA kernel's wrapper and its plain versions.

Port of ``repro.kernels.mamba2_ssd.{kernel,ops,ref}``.  Per head h with an
``[N, P]`` float32 state S (N = state size, P = head dim)::

    a_t = exp(dt_t * A_h)
    S_t = a_t * S_{t-1} + B_t (dt_t x_t)^T
    y_t = C_t^T S_t

B and C are shared across head groups: head h reads group ``h // (H/G)``.
:func:`ssd` dispatches on the device of its inputs: CPU tensors take
:func:`ssd_plain` (the sequential scan of ``ssd_ref``), CUDA tensors launch
the kernel of ``csrc/mamba2_ssd.cu`` or raise; fake tensors (the dry
run's, which hold no data) give the output's shape and dtype and run no
scan.  The kernel takes any T (the TPU launcher's ``t % chunk`` contract
does not apply): bfloat16 inputs run
the chunked dual form on the tensor cores (chunks of 64 steps, the state
in float32), float32 inputs the sequential scan on the CUDA cores.  :func:`ssd_decode`
is one step of the recurrence, plain PyTorch on every device, as the
reference's ``ssd_decode_ref``.

Its gradient follows the reference's ``custom_vjp`` backward
(``repro/kernels/mamba2_ssd/ops.py:14-29``), which recomputes the plain
function from the saved inputs: ``ssd`` is a ``torch.autograd.Function``
whose backward recomputes it (:func:`repro_torch.kernels._grad.plain_vjp`);
there is no backward kernel.  It recomputes :func:`ssd_chunked`, the same
function by the chunked dual form, rather than the scan: the scan's graph
is seven small operations a step (about 25,000 launches a call at a
1024-step train shape, a second of host time, and one ``[B, H, N, P]``
state a step kept), the chunked form's a few dozen a chunk; their
gradients agree within 2e-5 of their max (``tests/test_torch_ssd.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import plain_vjp, shapes_only

MAX_STATE = 128          # N the kernel takes (its mma tiles and registers)


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """x: [B,T,H,P]; dt: [B,T,H]; A: [H]; Bm, Cm: [B,T,G,N] -> y [B,T,H,P]
    in x's dtype, computed in float32 by a sequential scan over T."""
    b, t, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf = Bm.float().repeat_interleave(rep, dim=2)          # [B,T,H,N]
    Cf = Cm.float().repeat_interleave(rep, dim=2)
    S = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(t):
        decay = torch.exp(dtf[:, i] * Af)                   # [B,H]
        S = decay[..., None, None] * S + Bf[:, i, :, :, None] * \
            (dtf[:, i, :, None] * xf[:, i])[:, :, None, :]
        ys.append((Cf[:, i, :, :, None] * S).sum(-2))       # [B,H,P]
    if not ys:
        return torch.empty_like(x)
    return torch.stack(ys, dim=1).to(x.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., L] -> s [..., L, L] with s[..., t, u] = a[u+1] + ... + a[t]
    for u <= t (each sum over its own terms, so no difference of two long
    running sums loses digits) and -inf above the diagonal."""
    n = a.shape[-1]
    below = torch.ones((n, n), dtype=torch.bool, device=a.device).tril(-1)
    s = a[..., :, None].expand(*a.shape, n).masked_fill(~below, 0.0)
    s = s.cumsum(-2)
    return s.masked_fill(~below.logical_or(
        torch.eye(n, dtype=torch.bool, device=a.device)), float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor,
                chunk: int = 64) -> torch.Tensor:
    """:func:`ssd_plain`'s function by the chunked dual form, in float32
    (the kernel's bfloat16 algebra): within each chunk of ``chunk`` steps
    y_t = sum over u <= t of exp(a_u+1 + ... + a_t) (C_t . B_u) dt_u x_u
    plus C_t^T decayed from the state entering the chunk, and the state
    carried from chunk to chunk.  Its graph has a few dozen operations a
    chunk where the scan's has seven a step, so the kernels' backward
    recomputes it (:class:`_SSD`)."""
    b, t, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    nc = -(-t // chunk)
    pad = nc * chunk - t             # steps with dt = 0: no decay, no input

    def chunks(v):
        v = torch.nn.functional.pad(v, (0, 0) * (v.dim() - 2) + (0, pad))
        return v.reshape(b, nc, chunk, *v.shape[2:])

    xf, dtf = chunks(x.float()), chunks(dt.float())       # [b,c,l,h,(p)]
    Bf = chunks(Bm.float().repeat_interleave(rep, dim=2))  # [b,c,l,h,n]
    Cf = chunks(Cm.float().repeat_interleave(rep, dim=2))
    a = (dtf * A.float()).permute(0, 1, 3, 2)              # [b,c,h,l]
    seg = torch.exp(_segsum(a))                            # [b,c,h,t,u]
    w = torch.einsum("bcthn,bcuhn->bchtu", Cf, Bf) * seg
    xd = xf * dtf[..., None]                               # dt_u x_u
    y = torch.einsum("bchtu,bcuhp->bcthp", w, xd)
    # each chunk's state from zero, and the state entering each chunk
    to_end = seg[:, :, :, -1, :]                           # [b,c,h,u]
    S = torch.einsum("bcuhn,bcuhp->bchnp",
                     Bf * to_end.permute(0, 1, 3, 2)[..., None], xd)
    whole = to_end[..., 0] * torch.exp(a[..., 0])          # [b,c,h]
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = whole[:, c, :, None, None] * state + S[:, c]
    from_start = torch.exp(a.cumsum(-1))                   # [b,c,h,t]
    y = y + torch.einsum("bcthn,bcht,bchnp->bcthp", Cf, from_start,
                         torch.stack(entering, 1))
    return y.reshape(b, nc * chunk, h, p)[:, :t].to(x.dtype)


def ssd_decode(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  x: [B,H,P]; dt: [B,H]; Bm, Cm: [B,G,N];
    state: [B,H,N,P] -> (y [B,H,P] in x's dtype, new state in the
    state's dtype)."""
    b, h, p = x.shape
    g = Bm.shape[1]
    rep = h // g
    xf, dtf = x.float(), dt.float()
    Bf = Bm.float().repeat_interleave(rep, dim=1)
    Cf = Cm.float().repeat_interleave(rep, dim=1)
    sf = state.float()
    decay = torch.exp(dtf * A.float()[None, :])            # [B,H]
    new_s = decay[..., None, None] * sf \
        + Bf[..., :, None] * (dtf[..., None] * xf)[..., None, :]
    y = (Cf[..., :, None] * new_s).sum(-2)
    return y.to(x.dtype), new_s.to(state.dtype)


def _check(x, dt, A, Bm, Cm) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4:
        raise ValueError("ssd: expected x [B,T,H,P], dt [B,T,H], A [H], "
                         "Bm/Cm [B,T,G,N]")
    b, t, h, _ = x.shape
    g = Bm.shape[2]
    if tuple(dt.shape) != (b, t, h) or tuple(A.shape) != (h,) or \
            Bm.shape != Cm.shape or tuple(Bm.shape[:2]) != (b, t) or \
            g == 0 or h % g != 0:
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} do not "
                         f"match")
    for name, tn in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if tn.device != x.device:
            raise ValueError(f"ssd: {name} is on {tn.device}, x on "
                             f"{x.device}")


def _forward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """CPU: :func:`ssd_plain`; CUDA: the kernel or raise; fake
    tensors: the output's shape and dtype."""
    dev = x.device
    if shapes_only(x):
        return torch.empty_like(x)
    if dev.type == "cpu":
        return ssd_plain(x, dt, A, Bm, Cm)
    if dev.type != "cuda":
        raise ValueError(f"ssd: unsupported device {dev}")
    code = _build.dtype_code(x.dtype)
    if code is None:
        raise ValueError(f"ssd: the kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    for name, tn in (("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if tn.dtype != x.dtype:
            raise ValueError(f"ssd: {name} is {tn.dtype}, x is {x.dtype}")
    b, t, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd: state size {n} outside the kernel's "
                         f"1..{MAX_STATE}")
    x, dt, Bm, Cm = (a.contiguous() for a in (x, dt, Bm, Cm))
    A32 = A.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = _build.build().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mamba2_ssd_launch(
            x.data_ptr(), dt.data_ptr(), A32.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), b, t, h, p, g, n, code, stream)
    if err != 0:
        raise RuntimeError(f"ssd: kernel launch failed with CUDA error "
                           f"{err}")
    ssd.launches += 1
    return y


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return _forward(x, dt, A, Bm, Cm)

    @staticmethod
    def backward(ctx, grad_out):
        return plain_vjp(ssd_chunked, ctx.saved_tensors,
                         ctx.needs_input_grad, grad_out)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """Mamba2 SSD token mixing -> y [B,T,H,P] in x's dtype.  CPU:
    :func:`ssd_plain`; CUDA: the kernel (x, dt, Bm, Cm of one dtype,
    float32 or bfloat16; A is read as float32).  The gradient recomputes
    :func:`ssd_chunked` (A's sums over the batch)."""
    _check(x, dt, A, Bm, Cm)
    return _SSD.apply(x, dt, A, Bm, Cm)


ssd.launches = 0
