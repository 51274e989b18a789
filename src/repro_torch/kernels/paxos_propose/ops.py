"""The ``paxos_propose`` CUDA kernel's wrapper, its plain version, and the
issuer step around it.

Port of ``repro.kernels.paxos_propose.{kernel,ops,ref}``.  The kernel
(``csrc/paxos_propose.cu``) reads the packed ``(65, n)`` ProposerTable
stack, the ``(13, n)`` steered-reply stack and a ``(4, M)`` block of
quorum parameters (``n_machines``, ``majority``, ``commit_need``,
``log_too_high_threshold``) with ``n = M * S``: lane ``i`` reads column
``i // S``, so the fused engine's per-machine parameters are never
broadcast to per-lane planes.  It writes ``(65, n)`` new table planes and
``(14, n)`` action planes.  :func:`paxos_propose` dispatches on the device
of its inputs: CPU tensors take :func:`paxos_propose_plain`
(``repro_torch.core.proposer_vector.proposer_core`` over ``(F, M, S)``
views with ``(4, M, 1)`` parameters, as the reference's fused jnp path),
CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.proposer_vector import (
    ActionBatch, IssuerReplyBatch, ProposerTable, proposer_core,
)
from repro_torch.kernels import _build

N_TAB = len(ProposerTable._fields)       # 65 session-state planes
N_IREP = len(IssuerReplyBatch._fields)   # 13 steered-reply planes
N_ACT = len(ActionBatch._fields)         # 14 decision/emission planes
N_PAR = 4                                # quorum parameter rows

Outputs = Tuple[torch.Tensor, torch.Tensor]


def _check(name: str, t: torch.Tensor, shape, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"paxos_propose: {name} must be a tensor, got "
                        f"{type(t).__name__}")
    if t.dtype != torch.int32:
        raise ValueError(f"paxos_propose: {name} must be int32, got "
                         f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"paxos_propose: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"paxos_propose: {name} is on {t.device}, the "
                         f"table on {device}")
    if not t.is_contiguous():
        raise ValueError(f"paxos_propose: {name} must be contiguous")


def paxos_propose_plain(tab: torch.Tensor, rep: torch.Tensor,
                        params: torch.Tensor, lanes_per_row: int
                        ) -> Outputs:
    """The plain PyTorch version: :func:`proposer_core` over ``(F, M, S)``
    views with per-row ``(4, M, 1)`` parameters, on whatever device the
    stacks live."""
    n = tab.shape[1]
    m, s = n // lanes_per_row, lanes_per_row
    t = ProposerTable(*tab.view(N_TAB, m, s).unbind(0))
    r = IssuerReplyBatch(*rep.view(N_IREP, m, s).unbind(0))
    p = params.view(N_PAR, m, 1)
    new_t, act = proposer_core(t, r, p[0], p[1], p[2], p[3])
    return (torch.stack(new_t).reshape(N_TAB, n),
            torch.stack(act).reshape(N_ACT, n))


def paxos_propose(tab: torch.Tensor, rep: torch.Tensor,
                  params: torch.Tensor, lanes_per_row: int,
                  out: Optional[Outputs] = None) -> Outputs:
    """One issuer step over packed session lanes: ``tab (65, n)``, ``rep
    (13, n)``, ``params (4, n // lanes_per_row)`` -> ``(tab_out (65, n),
    act_out (14, n))``, all contiguous int32.  ``out`` optionally names
    preallocated output buffers (distinct from the inputs)."""
    if not isinstance(tab, torch.Tensor) or tab.dim() != 2:
        raise ValueError("paxos_propose: tab must be a 2-D (65, n) tensor")
    n = tab.shape[1]
    s = int(lanes_per_row)
    if s < 1 or n % s:
        raise ValueError(f"paxos_propose: lanes_per_row={lanes_per_row} "
                         f"does not divide the lane axis ({n})")
    dev = tab.device
    _check("tab", tab, (N_TAB, n), dev)
    _check("rep", rep, (N_IREP, n), dev)
    _check("params", params, (N_PAR, n // s), dev)
    if out is not None:
        for name, t, shape in zip(("tab_out", "act_out"), out,
                                  ((N_TAB, n), (N_ACT, n))):
            _check(name, t, shape, dev)
            if t.data_ptr() in (tab.data_ptr(), rep.data_ptr()):
                raise ValueError(f"paxos_propose: {name} aliases an input; "
                                 f"the kernel does not update in place")
    if dev.type == "cpu":
        res = paxos_propose_plain(tab, rep, params, s)
        if out is None:
            return res
        for dst, src in zip(out, res):
            dst.copy_(src)
        return out
    if dev.type != "cuda":
        raise ValueError(f"paxos_propose: unsupported device {dev}")
    if out is None:
        out = (torch.empty((N_TAB, n), dtype=torch.int32, device=dev),
               torch.empty((N_ACT, n), dtype=torch.int32, device=dev))
    lib = _build.build().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paxos_propose_launch(
            tab.data_ptr(), rep.data_ptr(), params.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), n, s, stream)
    if err != 0:
        raise RuntimeError(f"paxos_propose: kernel launch failed with CUDA "
                           f"error {err}")
    paxos_propose.launches += 1
    return out


paxos_propose.launches = 0


def validate_lanes(t: ProposerTable, rep: IssuerReplyBatch) -> None:
    """The reference's lane contract, checked before any launch."""
    n = t.phase.shape[0]
    for name, plane in list(zip(ProposerTable._fields, t)) \
            + list(zip(IssuerReplyBatch._fields, rep)):
        shape = tuple(plane.shape)
        if len(shape) != 1 or shape[0] != n:
            raise ValueError(
                f"issuer_step: plane {name!r} has shape {shape}; the lane "
                f"contract requires 1-D planes of one shared lane count "
                f"(here {n}), one session per lane, at most one steered "
                f"reply per lane.")


def issuer_step(t: ProposerTable, rep: IssuerReplyBatch, *,
                n_machines, majority, commit_need, log_too_high_threshold
                ) -> Tuple[ProposerTable, ActionBatch]:
    """One issuer step of a replica over steered-reply session lanes.

    The quorum parameters may each be an int or a length-``n`` int32
    tensor; they travel as a per-lane ``(4, n)`` block (one lane per
    parameter column).  Returns ``(new_table, actions)``.
    """
    validate_lanes(t, rep)
    n = t.phase.shape[0]
    dev = t.phase.device
    params = torch.stack([
        torch.as_tensor(p, dtype=torch.int32, device=dev).broadcast_to((n,))
        for p in (n_machines, majority, commit_need,
                  log_too_high_threshold)])
    new_t, act = paxos_propose(torch.stack(t), torch.stack(rep), params, 1)
    return ProposerTable(*new_t.unbind(0)), ActionBatch(*act.unbind(0))
