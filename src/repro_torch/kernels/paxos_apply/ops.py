"""The ``paxos_apply`` CUDA kernel's wrapper, its plain version, and the
replica step around it.

Port of ``repro.kernels.paxos_apply.{kernel,ops,ref}``.  The kernel
(``csrc/paxos_apply.cu``) reads the packed ``(18, n)`` KV stack and the
``(12, n)`` message+``is_registered`` staging stack in place and writes
``(18, n)`` new KV planes, ``(11, n)`` reply planes and an ``(n,)``
register mask; it masks the ragged end itself, so there is no padding
contract and no ``block_rows``.  :func:`paxos_apply` dispatches on the
device of its inputs: CPU tensors take :func:`paxos_apply_plain`
(``repro_torch.core.vector.apply_batch``), CUDA tensors launch the kernel
or raise.

:func:`replica_step` is the reference's full receiver step over 1-D
planes: the registered-rmw-id gather, the kernel, and the segment-max
registration scatter into a one-past-the-end dead slot.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.vector import KVTable, MsgBatch, ReplyBatch, apply_batch
from repro_torch.kernels import _build

N_KV = len(KVTable._fields)          # 18 state planes
N_MSG = len(MsgBatch._fields)        # 11 message planes
N_REP = len(ReplyBatch._fields)      # 11 reply planes
N_MSGREG = N_MSG + 1                 # message planes + is_registered

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(name: str, t: torch.Tensor, shape, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"paxos_apply: {name} must be a tensor, got "
                        f"{type(t).__name__}")
    if t.dtype != torch.int32:
        raise ValueError(f"paxos_apply: {name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"paxos_apply: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"paxos_apply: {name} is on {t.device}, the "
                         f"KV stack on {device}")
    if not t.is_contiguous():
        raise ValueError(f"paxos_apply: {name} must be contiguous")


def paxos_apply_plain(kv: torch.Tensor, msgreg: torch.Tensor) -> Outputs:
    """The plain PyTorch version: :func:`apply_batch` over the packed
    stacks, on whatever device they live."""
    new_kv, replies, mask = apply_batch(
        KVTable(*kv.unbind(0)), MsgBatch(*msgreg[:N_MSG].unbind(0)),
        msgreg[N_MSG] != 0)
    return (torch.stack(new_kv), torch.stack(replies),
            mask.to(torch.int32))


def paxos_apply(kv: torch.Tensor, msgreg: torch.Tensor,
                out: Optional[Outputs] = None) -> Outputs:
    """One receiver step over packed lanes: ``kv (18, n)``, ``msgreg
    (12, n)`` -> ``(kv_out (18, n), rep_out (11, n), mask_out (n,))``, all
    contiguous int32.  ``out`` optionally names preallocated output
    buffers (distinct from the inputs); otherwise they are allocated."""
    if not isinstance(kv, torch.Tensor) or kv.dim() != 2:
        raise ValueError("paxos_apply: kv must be a 2-D (18, n) tensor")
    n = kv.shape[1]
    dev = kv.device
    _check("kv", kv, (N_KV, n), dev)
    _check("msgreg", msgreg, (N_MSGREG, n), dev)
    if out is not None:
        for name, t, shape in zip(("kv_out", "rep_out", "mask_out"), out,
                                  ((N_KV, n), (N_REP, n), (n,))):
            _check(name, t, shape, dev)
            if t.data_ptr() in (kv.data_ptr(), msgreg.data_ptr()):
                raise ValueError(f"paxos_apply: {name} aliases an input; "
                                 f"the kernel does not update in place")
    if dev.type == "cpu":
        res = paxos_apply_plain(kv, msgreg)
        if out is None:
            return res
        for dst, src in zip(out, res):
            dst.copy_(src)
        return out
    if dev.type != "cuda":
        raise ValueError(f"paxos_apply: unsupported device {dev}")
    if out is None:
        out = (torch.empty((N_KV, n), dtype=torch.int32, device=dev),
               torch.empty((N_REP, n), dtype=torch.int32, device=dev),
               torch.empty((n,), dtype=torch.int32, device=dev))
    lib = _build.build().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paxos_apply_launch(
            kv.data_ptr(), msgreg.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"paxos_apply: kernel launch failed with CUDA "
                           f"error {err}")
    paxos_apply.launches += 1
    return out


paxos_apply.launches = 0


# ---------------------------------------------------------------------------
# the replica step (registry gather -> kernel -> registry scatter)
# ---------------------------------------------------------------------------

def gather_is_registered(registered: torch.Tensor,
                         msg: MsgBatch) -> torch.Tensor:
    """registered[gsess] >= counter, guarding gsess < 0 (fresh lanes)."""
    sess = msg.rmw_sess.clamp(0, registered.shape[0] - 1).long()
    got = registered[sess]
    return (msg.rmw_sess >= 0) & (got >= msg.rmw_cnt)


def scatter_register(registered: torch.Tensor, msg: MsgBatch,
                     mask: torch.Tensor) -> torch.Tensor:
    """Segment-max registration of committed rmw-ids (§3.1.1).

    Masked-out lanes (and any session outside the table) must not alias a
    live global session: they go to a dead slot one past the end, which is
    sliced off after the ``amax`` scatter (the reference's out-of-bounds
    ``mode="drop"``).
    """
    n = registered.shape[0]
    live = mask & (msg.rmw_sess >= 0) & (msg.rmw_sess < n)
    sess = torch.where(live, msg.rmw_sess, n).long()
    slots = torch.cat([registered, registered.new_zeros(1)])
    slots.scatter_reduce_(0, sess, msg.rmw_cnt.to(registered.dtype),
                          reduce="amax", include_self=True)
    return slots[:n]


def validate_batch(kv: KVTable, msg: MsgBatch,
                   registered: torch.Tensor) -> None:
    """The reference's lane contract, checked before any launch."""
    n = kv.state.shape[0]
    for name, plane in list(zip(KVTable._fields, kv)) \
            + list(zip(MsgBatch._fields, msg)):
        shape = tuple(plane.shape)
        if len(shape) != 1 or shape[0] != n:
            raise ValueError(
                f"replica_step: plane {name!r} has shape {shape}; the "
                f"padding contract requires 1-D planes of one shared lane "
                f"count (here {n}), one lane per key, at most one non-NOOP "
                f"message per key.")
    if registered.dim() != 1:
        raise ValueError(
            f"replica_step: registered table must be 1-D (one committed "
            f"counter per global session), got shape "
            f"{tuple(registered.shape)}")


def replica_step(kv: KVTable, msg: MsgBatch, registered: torch.Tensor
                 ) -> Tuple[KVTable, ReplyBatch, torch.Tensor]:
    """One receiver step of a replica over a conflict-free message batch.

    ``registered`` is the bounded per-global-session table of committed
    rmw-id counters.  Returns ``(new_table, replies, new_registered)``.
    """
    validate_batch(kv, msg, registered)
    is_reg = gather_is_registered(registered, msg)
    msgreg = torch.cat([torch.stack(msg), is_reg.to(torch.int32)[None]])
    new_kv, replies, mask = paxos_apply(torch.stack(kv), msgreg)
    return (KVTable(*new_kv.unbind(0)), ReplyBatch(*replies.unbind(0)),
            scatter_register(registered, msg, mask != 0))
