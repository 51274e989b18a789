"""The ``paxos_propose`` CUDA kernel's wrappers, their plain versions, and
the issuer step around them.

Port of ``repro.kernels.paxos_propose.{kernel,ops,ref}``.  The kernel
source (``csrc/paxos_propose.cu``) holds one select network and two
entries:

* :func:`paxos_propose`, the whole-stack step the TPU kernel is: the packed
  ``(65, n)`` ProposerTable stack, the ``(13, n)`` steered-reply stack and
  a ``(4, M)`` block of quorum parameters (``n_machines``, ``majority``,
  ``commit_need``, ``log_too_high_threshold``) with ``n = M * S`` (lane
  ``i`` reads column ``i // S``) -> ``(65, n)`` new table planes and
  ``(14, n)`` action planes, out of place.
* :func:`paxos_propose_staged`, the serve path's step: only a wave's
  staged lanes, in place on the resident table.  ``staged`` packs
  ``(2 + 13, L)`` rows (machine row, session lane, the 13 reply planes);
  the output is a compact ``(14 + 44, L)`` block (the actions, then the
  :data:`CHANGED_FIELDS` planes).  It computes what the whole-stack step
  computes: ``proposer_core`` gates every update on ``rep.kind >= 0``, so
  a lane with an idle reply keeps its table and decides WAIT.

Each wrapper dispatches on the device of its inputs: CPU tensors take the
plain version (:func:`paxos_propose_plain`, :func:`paxos_propose_staged_plain`:
``repro_torch.core.proposer_vector.proposer_core``), CUDA tensors launch
the kernel or raise.  Both count their launches in
``paxos_propose.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.proposer_vector import (
    ActionBatch, IssuerReplyBatch, ProposerTable, proposer_core,
)
from repro_torch.kernels import _build

N_TAB = len(ProposerTable._fields)       # 65 session-state planes
N_IREP = len(IssuerReplyBatch._fields)   # 13 steered-reply planes
N_ACT = len(ActionBatch._fields)         # 14 decision/emission planes
N_PAR = 4                                # quorum parameter rows

# The planes proposer_core never changes (kPassThrough in the .cu), and the
# 44 it may change, in ProposerTable order (the .cu's ChangedPlane).
PASS_THROUGH_FIELDS = (
    "lid", "aboard", "helping", "lth_counter", "key", "ts_v", "ts_m",
    "log_no", "rmw_cnt", "rmw_sess", "value", "has_value", "base_v",
    "base_m", "val_log", "abd_lid", "abd_key", "abd_value",
    "abd_sent_base_v", "abd_sent_base_m", "abd_sent_vlog")
CHANGED_FIELDS = tuple(f for f in ProposerTable._fields
                       if f not in PASS_THROUGH_FIELDS)
CHANGED_ROWS = np.array([ProposerTable._fields.index(f)
                         for f in CHANGED_FIELDS])
N_CHG = len(CHANGED_FIELDS)              # 44 changed planes
N_STAGED = 2 + N_IREP                    # staged rows: mi, lane, replies
N_OUT = N_ACT + N_CHG                    # compact output rows

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


# ---------------------------------------------------------------------------
# the staged entry: a wave's lanes only, in place
# ---------------------------------------------------------------------------

def check_coords(coords, n_rows: int, lanes_per_row: int) -> None:
    """The staged entry's lane contract on the host copy of the staged
    coordinates ``coords (2, L)`` (machine rows, session lanes): each in
    range, and at most one entry per ``(row, lane)``: two threads writing
    one table column would race."""
    n = len(coords[0])
    if n == 0:
        return
    if n <= 64:        # a serve wave: a few lanes, cheapest in Python
        mi, lane = coords[0].tolist(), coords[1].tolist()
        in_range = (min(mi) >= 0 and max(mi) < n_rows
                    and min(lane) >= 0 and max(lane) < lanes_per_row)
        unique = len(set(zip(mi, lane))) == n
    else:
        mi = np.asarray(coords[0], np.int64)
        lane = np.asarray(coords[1], np.int64)
        in_range = bool(mi.min() >= 0 and mi.max() < n_rows
                        and lane.min() >= 0 and lane.max() < lanes_per_row)
        key = np.sort(mi * lanes_per_row + lane)
        unique = not bool((key[1:] == key[:-1]).any())
    if not in_range:
        raise ValueError(f"paxos_propose_staged: a staged coordinate lies "
                         f"outside {n_rows} rows x {lanes_per_row} lanes")
    if not unique:
        raise ValueError("paxos_propose_staged: a (row, lane) is staged "
                         "twice; the lane contract allows one entry a lane")


def dense_replies(staged: torch.Tensor, n_rows: int,
                  lanes_per_row: int) -> torch.Tensor:
    """The whole-stack ``(13, n_rows * lanes_per_row)`` reply stack a staged
    buffer stands for: idle (kind -1, zeros) except at the staged lanes.
    For holding the staged entry against :func:`paxos_propose_plain`."""
    rep = torch.zeros((N_IREP, n_rows * lanes_per_row), dtype=torch.int32,
                      device=staged.device)
    rep[0] = -1
    rep[:, staged[0].long() * lanes_per_row + staged[1].long()] = staged[2:]
    return rep


def paxos_propose_staged_plain(tab: torch.Tensor, staged: torch.Tensor,
                               params: torch.Tensor, lanes_per_row: int,
                               out: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The plain PyTorch version of the staged entry, on whatever device
    the tensors live: gather the staged columns of ``tab``, run
    :func:`proposer_core` on them with per-lane parameters ``params[:,
    mi]``, scatter the changed planes back into ``tab`` in place, and
    return the compact ``(14 + 44, L)`` output."""
    mi = staged[0].long()
    idx = mi * lanes_per_row + staged[1].long()
    p = params[:, mi]
    new_t, act = proposer_core(ProposerTable(*tab[:, idx].unbind(0)),
                               IssuerReplyBatch(*staged[2:].unbind(0)),
                               p[0], p[1], p[2], p[3])
    chg = torch.stack([new_t[k] for k in CHANGED_ROWS])
    rows = torch.from_numpy(CHANGED_ROWS).to(tab.device)
    tab[rows[:, None], idx[None, :]] = chg
    res = torch.cat([torch.stack(act), chg])
    if out is None:
        return res
    out.copy_(res)
    return out


_staged_launch = None     # the library's entry, resolved at first launch


def paxos_propose_staged(tab: torch.Tensor, staged: torch.Tensor,
                         params: torch.Tensor, lanes_per_row: int,
                         out: Optional[torch.Tensor] = None,
                         coords=None) -> torch.Tensor:
    """One issuer step over a wave's staged lanes, in place: ``tab (65,
    M * lanes_per_row)`` is updated at the staged columns; ``staged (2 + 13,
    L)`` holds each lane's machine row, session lane and reply; ``params
    (4, M)``.  Returns the compact ``(14 + 44, L)`` output (into ``out``
    when given).  All contiguous int32 on one device.

    ``coords`` is the host copy of ``staged[:2]`` (a numpy ``(2, L)``
    array), which the lane contract is checked on before the launch; a CUDA
    call needs it, a CPU call reads ``staged`` itself."""
    global _staged_launch
    n_staged = staged.shape[1] if staged.dim() == 2 else -1
    s = int(lanes_per_row)
    m = params.shape[1] if params.dim() == 2 else -1
    dev = tab.device
    if out is None:
        out = torch.empty((N_OUT, max(n_staged, 0)), dtype=torch.int32,
                          device=dev)
    if not (s >= 1 and m >= 1 and _fits(tab, (N_TAB, m * s), dev)
            and _fits(staged, (N_STAGED, n_staged), dev)
            and _fits(params, (N_PAR, m), dev)
            and _fits(out, (N_OUT, n_staged), dev)):
        if s < 1 or m < 1 or n_staged < 0:
            raise ValueError(f"paxos_propose_staged: lanes_per_row={s}, "
                             f"params {tuple(params.shape)} and staged "
                             f"{tuple(staged.shape)} name no (4, M) block "
                             f"and (15, L) buffer")
        _check("tab", tab, (N_TAB, m * s), dev)
        _check("staged", staged, (N_STAGED, n_staged), dev)
        _check("params", params, (N_PAR, m), dev)
        _check("out", out, (N_OUT, n_staged), dev)
    if n_staged and out.data_ptr() in (tab.data_ptr(), staged.data_ptr()):
        raise ValueError("paxos_propose_staged: out aliases an input")
    if coords is None and dev.type == "cpu":
        coords = staged[:2].numpy()
    elif coords is None:
        raise ValueError("paxos_propose_staged: pass coords, the host copy "
                         "of staged[:2], to check the lane contract")
    elif len(coords) != 2 or len(coords[0]) != n_staged:
        raise ValueError(f"paxos_propose_staged: coords must be the (2, "
                         f"{n_staged}) host copy of staged[:2]")
    check_coords(coords, m, s)
    if dev.type == "cpu":
        return paxos_propose_staged_plain(tab, staged, params, s, out=out)
    if dev.type != "cuda":
        raise ValueError(f"paxos_propose_staged: unsupported device {dev}")
    if n_staged == 0:
        return out
    if _staged_launch is None:
        _staged_launch = _build.build().lib.paxos_propose_staged_launch
    args = (tab.data_ptr(), staged.data_ptr(), params.data_ptr(),
            out.data_ptr(), m, s, n_staged,
            # the raw handle: torch.cuda.current_stream() builds a Stream
            # object, several microseconds of a call that does little else
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = _staged_launch(*args)
    else:
        with torch.cuda.device(dev):
            err = _staged_launch(*args)
    if err != 0:
        raise RuntimeError(f"paxos_propose_staged: kernel launch failed "
                           f"with CUDA error {err}")
    paxos_propose.launches += 1
    return out


def _fits(t, shape, device: torch.device) -> bool:
    """The wrapper's fast check: an int32 contiguous tensor of ``shape`` on
    ``device`` (:func:`_check` says what is wrong when it is not).  dtypes
    are singletons, and ``is`` costs a fraction of ``==`` on them."""
    return (isinstance(t, torch.Tensor) and t.dtype is torch.int32
            and t.shape == shape and t.device == device
            and t.is_contiguous())


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
