"""Batched proposer/issuer engine in PyTorch — the plain version of the
``paxos_propose`` CUDA kernel.

Port of ``repro.core.proposer_vector``: one **session** per lane, the
per-round reply bookkeeping of :class:`~repro_torch.core.types.Tally` and
the ABD session entries recast as struct-of-arrays int32 planes, and the
pure decision functions of :mod:`repro_torch.core.proposer` recast as a
branch-free first-match-wins priority select.  The plane map, the
host/engine split and the ``PAUSED`` parking rule are those of the
reference module; :func:`proposer_core` is the same network line for
line in ``torch`` ops, so both packages give bit-equal planes
(``tests/test_torch_proposer_vector.py``).  It is the plain version the
CUDA kernel (``csrc/paxos_propose.cu``) is held against on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..device import DeviceLike, int32_planes, resolve_device
from .proposer import ABD_PAUSED, AbdPhase, Decision, Phase
from .types import MsgKind, Rep
from .vector import I32, _where, cs_gt, popcount8, ts_gt


# ---------------------------------------------------------------------------
# Struct-of-arrays state: one lane per session
# ---------------------------------------------------------------------------

# (field, fresh-value) pairs: -1 mirrors TS_ZERO.mid / RMW_ID_NONE.gsess so a
# fresh table equals the scalar shadow of an idle machine plane-for-plane.
_TABLE_FIELDS = (
    # RMW round identity (reloaded from round events)
    ("phase", 0), ("lid", 0), ("aboard", 0), ("helping", 0),
    ("lth_counter", 0),
    ("key", 0), ("ts_v", 0), ("ts_m", -1), ("log_no", 0),
    ("rmw_cnt", 0), ("rmw_sess", -1), ("value", 0), ("has_value", 0),
    ("base_v", 0), ("base_m", -1), ("val_log", 0),
    # §4.3/§4.6 tally planes (Tally, vectorized)
    ("rep_bits", 0), ("ack_bits", 0),
    ("rmw_flag", 0), ("rmw_nb_flag", 0), ("lth_flag", 0),
    ("sh_has", 0), ("sh_v", 0), ("sh_m", -1),
    ("ltl_has", 0), ("ltl_log", 0), ("ltl_cnt", 0), ("ltl_sess", -1),
    ("ltl_val", 0), ("ltl_base_v", 0), ("ltl_base_m", -1), ("ltl_vlog", 0),
    ("la_has", 0), ("la_ts_v", 0), ("la_ts_m", -1), ("la_cnt", 0),
    ("la_sess", -1), ("la_val", 0), ("la_base_v", 0), ("la_base_m", -1),
    ("la_vlog", 0),
    ("fr_has", 0), ("fr_val", 0), ("fr_base_v", 0), ("fr_base_m", -1),
    ("fr_log", 0),
    # ABD session planes (§10–§11)
    ("abd_phase", 0), ("abd_lid", 0), ("abd_key", 0), ("abd_value", 0),
    ("abd_rep_bits", 0), ("abd_ack_bits", 0), ("abd_store_bits", 0),
    ("abd_maxb_v", 0), ("abd_maxb_m", -1),
    ("abd_sent_base_v", 0), ("abd_sent_base_m", -1), ("abd_sent_vlog", 0),
    ("best_base_v", 0), ("best_base_m", -1), ("best_vlog", 0),
    ("best_val", 0), ("best_log", 0), ("best_cnt", 0), ("best_sess", -1),
)

TABLE_DEFAULTS = dict(_TABLE_FIELDS)


def _from_numpy(cls, planes, device: DeviceLike):
    return cls(*int32_planes(planes, len(cls._fields), device).unbind(0))


class ProposerTable(NamedTuple("ProposerTable",
                               [(f, torch.Tensor) for f, _ in _TABLE_FIELDS])):
    """One issuer lane per session: round identity + tally + ABD planes."""

    @staticmethod
    def fresh(n_lanes: int, device: DeviceLike = None) -> "ProposerTable":
        dev = resolve_device(device)
        return ProposerTable(*[torch.full((n_lanes,), v, dtype=I32,
                                          device=dev)
                               for _, v in _TABLE_FIELDS])

    @classmethod
    def from_numpy(cls, planes, device: DeviceLike = None
                   ) -> "ProposerTable":
        """Planes from numpy: a stacked ``(65, ...)`` array or the
        reference's NamedTuple of arrays (copied to ``device``)."""
        return _from_numpy(cls, planes, device)


class IssuerReplyBatch(NamedTuple):
    """One steered reply per session lane (``kind = -1`` for idle lanes);
    ``src`` feeds the per-source bitmaps, ``lid`` the stale-round gate."""

    kind: torch.Tensor
    opcode: torch.Tensor
    src: torch.Tensor
    lid: torch.Tensor
    ts_v: torch.Tensor
    ts_m: torch.Tensor
    log_no: torch.Tensor
    rmw_cnt: torch.Tensor
    rmw_sess: torch.Tensor
    value: torch.Tensor
    base_v: torch.Tensor
    base_m: torch.Tensor
    val_log: torch.Tensor

    @staticmethod
    def idle(n_lanes: int, device: DeviceLike = None) -> "IssuerReplyBatch":
        dev = resolve_device(device)
        z = torch.zeros((n_lanes,), dtype=I32, device=dev)
        return IssuerReplyBatch(
            torch.full((n_lanes,), -1, dtype=I32, device=dev), *([z] * 12))

    @classmethod
    def from_numpy(cls, planes, device: DeviceLike = None
                   ) -> "IssuerReplyBatch":
        return _from_numpy(cls, planes, device)


class ActionBatch(NamedTuple):
    """Per-lane decision + the outbound-message/payload planes it pins
    (``bcast_kind`` is a wire MsgKind for engine-owned emissions, ``-1``
    for host actions)."""

    decision: torch.Tensor
    bcast_kind: torch.Tensor
    key: torch.Tensor
    sh_has: torch.Tensor
    ts_v: torch.Tensor
    ts_m: torch.Tensor
    log_no: torch.Tensor
    rmw_cnt: torch.Tensor
    rmw_sess: torch.Tensor
    value: torch.Tensor
    has_value: torch.Tensor
    base_v: torch.Tensor
    base_m: torch.Tensor
    val_log: torch.Tensor

    @classmethod
    def from_numpy(cls, planes, device: DeviceLike = None) -> "ActionBatch":
        return _from_numpy(cls, planes, device)


def _prio(out, cases):
    """First-match-wins priority select: ``cases`` = [(mask, value), ...]."""
    claimed = torch.zeros_like(out, dtype=torch.bool)
    for mask, val in cases:
        out = _where(mask & ~claimed, val, out)
        claimed = claimed | mask
    return out


# ---------------------------------------------------------------------------
# The fused issuer step
# ---------------------------------------------------------------------------

def proposer_core(t: ProposerTable, rep: IssuerReplyBatch,
                  n_machines, majority, commit_need,
                  log_too_high_threshold
                  ) -> Tuple[ProposerTable, ActionBatch]:
    """The issuer select network, shape- and parameter-polymorphic.

    Pure and fully elementwise: planes may be 1-D ``(lanes,)`` or stacked
    ``(machines, lanes)``, and the quorum parameters may be Python ints or
    broadcastable int32 tensors (the fused cluster engine's per-machine
    ``(machines, 1)`` columns, or per-lane planes).
    """
    active = rep.kind >= 0

    # ---- steering (§3.1.2): lid + phase gates, COMMIT_ACK disambiguation --
    is_prop_rep = rep.kind == int(MsgKind.PROP_REPLY)
    is_acc_rep = rep.kind == int(MsgKind.ACC_REPLY)
    is_cack = rep.kind == int(MsgKind.COMMIT_ACK)
    rmw_lid_ok = rep.lid == t.lid
    to_prop = active & is_prop_rep & (t.phase == int(Phase.PROPOSED)) \
        & rmw_lid_ok
    to_acc = active & is_acc_rep & (t.phase == int(Phase.ACCEPTED)) \
        & rmw_lid_ok
    to_cmt = active & is_cack & (t.phase == int(Phase.COMMITTED)) & rmw_lid_ok
    abd_lid_ok = rep.lid == t.abd_lid
    to_wq = active & (rep.kind == int(MsgKind.WRITE_QUERY_REPLY)) \
        & (t.abd_phase == int(AbdPhase.W_QUERY)) & abd_lid_ok
    to_w = active & (rep.kind == int(MsgKind.WRITE_ACK)) \
        & (t.abd_phase == int(AbdPhase.W_WRITE)) & abd_lid_ok
    to_rq = active & (rep.kind == int(MsgKind.READ_QUERY_REPLY)) \
        & (t.abd_phase == int(AbdPhase.R_QUERY)) & abd_lid_ok
    # commit acks may belong to an RMW commit or a §11 read write-back
    to_rc = active & is_cack & ~to_cmt \
        & (t.abd_phase == int(AbdPhase.R_COMMIT)) & abd_lid_ok
    to_rmw = to_prop | to_acc | to_cmt

    bit = torch.ones_like(rep.src) << rep.src.clamp(0, 7)

    # ---- RMW tally fold (Tally.note, vectorized) --------------------------
    is_ack_op = ((rep.opcode == int(Rep.ACK))
                 | (rep.opcode == int(Rep.ACK_BASE_TS_STALE)))
    rep_bits = _where(to_rmw, t.rep_bits | bit, t.rep_bits)
    ack_bits = _where(to_rmw & is_ack_op, t.ack_bits | bit, t.ack_bits)

    fr_upd = (to_rmw & (rep.opcode == int(Rep.ACK_BASE_TS_STALE))
              & cs_gt(rep.base_v, rep.base_m, rep.val_log,
                      t.fr_base_v, t.fr_base_m, t.fr_log))
    fr_has = _where(fr_upd, 1, t.fr_has)
    fr_val = _where(fr_upd, rep.value, t.fr_val)
    fr_base_v = _where(fr_upd, rep.base_v, t.fr_base_v)
    fr_base_m = _where(fr_upd, rep.base_m, t.fr_base_m)
    fr_log = _where(fr_upd, rep.val_log, t.fr_log)

    is_rmw_c = rep.opcode == int(Rep.RMW_ID_COMMITTED)
    is_rmw_nb = rep.opcode == int(Rep.RMW_ID_COMMITTED_NO_BCAST)
    rmw_flag = _where(to_rmw & (is_rmw_c | is_rmw_nb), 1, t.rmw_flag)
    rmw_nb_flag = _where(to_rmw & is_rmw_nb, 1, t.rmw_nb_flag)
    lth_flag = _where(to_rmw & (rep.opcode == int(Rep.LOG_TOO_HIGH)), 1,
                      t.lth_flag)

    ltl_upd = (to_rmw & (rep.opcode == int(Rep.LOG_TOO_LOW))
               & ((t.ltl_has == 0) | (rep.log_no > t.ltl_log)))
    ltl_has = _where(ltl_upd, 1, t.ltl_has)
    ltl_log = _where(ltl_upd, rep.log_no, t.ltl_log)
    ltl_cnt = _where(ltl_upd, rep.rmw_cnt, t.ltl_cnt)
    ltl_sess = _where(ltl_upd, rep.rmw_sess, t.ltl_sess)
    ltl_val = _where(ltl_upd, rep.value, t.ltl_val)
    ltl_base_v = _where(ltl_upd, rep.base_v, t.ltl_base_v)
    ltl_base_m = _where(ltl_upd, rep.base_m, t.ltl_base_m)
    ltl_vlog = _where(ltl_upd, rep.val_log, t.ltl_vlog)

    sh_upd = (to_rmw & ((rep.opcode == int(Rep.SEEN_HIGHER_PROP))
                        | (rep.opcode == int(Rep.SEEN_HIGHER_ACC)))
              & ((t.sh_has == 0) | ts_gt(rep.ts_v, rep.ts_m, t.sh_v, t.sh_m)))
    sh_has = _where(sh_upd, 1, t.sh_has)
    sh_v = _where(sh_upd, rep.ts_v, t.sh_v)
    sh_m = _where(sh_upd, rep.ts_m, t.sh_m)

    la_upd = (to_rmw & (rep.opcode == int(Rep.SEEN_LOWER_ACC))
              & ((t.la_has == 0)
                 | ts_gt(rep.ts_v, rep.ts_m, t.la_ts_v, t.la_ts_m)))
    la_has = _where(la_upd, 1, t.la_has)
    la_ts_v = _where(la_upd, rep.ts_v, t.la_ts_v)
    la_ts_m = _where(la_upd, rep.ts_m, t.la_ts_m)
    la_cnt = _where(la_upd, rep.rmw_cnt, t.la_cnt)
    la_sess = _where(la_upd, rep.rmw_sess, t.la_sess)
    la_val = _where(la_upd, rep.value, t.la_val)
    la_base_v = _where(la_upd, rep.base_v, t.la_base_v)
    la_base_m = _where(la_upd, rep.base_m, t.la_base_m)
    la_vlog = _where(la_upd, rep.val_log, t.la_vlog)

    # ---- ABD fold (abd_fold, vectorized; §10–§11) -------------------------
    abd_rep_bits = _where(to_wq | to_rq, t.abd_rep_bits | bit,
                          t.abd_rep_bits)
    abd_ack_bits = _where(to_w | to_rc, t.abd_ack_bits | bit, t.abd_ack_bits)
    maxb_upd = to_wq & ts_gt(rep.base_v, rep.base_m,
                             t.abd_maxb_v, t.abd_maxb_m)
    abd_maxb_v = _where(maxb_upd, rep.base_v, t.abd_maxb_v)
    abd_maxb_m = _where(maxb_upd, rep.base_m, t.abd_maxb_m)

    # §11 three-way carstamp fold
    rq_low = to_rq & (rep.opcode == int(Rep.CARSTAMP_TOO_LOW))
    cs_better = cs_gt(rep.base_v, rep.base_m, rep.val_log,
                      t.best_base_v, t.best_base_m, t.best_vlog)
    cs_equal = ((rep.base_v == t.best_base_v) & (rep.base_m == t.best_base_m)
                & (rep.val_log == t.best_vlog))
    new_best = rq_low & cs_better
    add_store = rq_low & ~cs_better & cs_equal
    best_is_sent = ((t.best_base_v == t.abd_sent_base_v)
                    & (t.best_base_m == t.abd_sent_base_m)
                    & (t.best_vlog == t.abd_sent_vlog))
    eq_store = (to_rq & (rep.opcode == int(Rep.CARSTAMP_EQUAL))
                & best_is_sent)
    best_base_v = _where(new_best, rep.base_v, t.best_base_v)
    best_base_m = _where(new_best, rep.base_m, t.best_base_m)
    best_vlog = _where(new_best, rep.val_log, t.best_vlog)
    best_val = _where(new_best, rep.value, t.best_val)
    best_log = _where(new_best, rep.log_no, t.best_log)
    best_cnt = _where(new_best, rep.rmw_cnt, t.best_cnt)
    best_sess = _where(new_best, rep.rmw_sess, t.best_sess)
    abd_store_bits = _where(new_best, bit,
                            _where(add_store | eq_store,
                                   t.abd_store_bits | bit, t.abd_store_bits))

    # ---- decisions (decide_propose / decide_accept / decide_commit) -------
    acks = popcount8(ack_bits)
    total = popcount8(rep_bits)
    any_rmw = rmw_flag == 1
    any_ltl = ltl_has == 1
    any_sh = sh_has == 1
    any_lth = lth_flag == 1
    learned = _where(rmw_nb_flag == 1, int(Decision.LEARNED_NO_BCAST),
                     int(Decision.LEARNED))

    def full(v):
        return torch.full_like(t.phase, int(v))

    p_trig = to_prop & (any_rmw | any_ltl | any_sh | (total >= majority))
    help_self = (la_cnt == t.rmw_cnt) & (la_sess == t.rmw_sess)
    help_d = _where(help_self, int(Decision.HELP_SELF), int(Decision.HELP))
    lth_d = _where(t.lth_counter + 1 >= log_too_high_threshold,
                   int(Decision.RECOMMIT), int(Decision.RETRY_LOG_TOO_HIGH))
    p_decision = _prio(full(Decision.WAIT), [
        (p_trig & any_rmw, learned),
        (p_trig & any_ltl, full(Decision.LOG_TOO_LOW)),
        (p_trig & any_sh, full(Decision.RETRY)),
        (p_trig & (acks >= majority), full(Decision.LOCAL_ACCEPT)),
        (p_trig & (la_has == 1), help_d),
        (p_trig & any_lth, lth_d),
    ])

    helping = t.helping == 1
    aboard = t.aboard == 1
    any_nack = any_rmw | any_ltl | any_sh | any_lth
    a_trig = to_acc & (any_rmw | any_ltl | (total >= majority)
                       | ((helping | aboard) & any_nack))
    need = _where(aboard, n_machines, majority)
    a_learned = _where(helping, int(Decision.STOP_HELP), learned)
    a_nack_d = _where(helping, int(Decision.STOP_HELP), int(Decision.RETRY))
    a_decision = _prio(full(Decision.WAIT), [
        (a_trig & any_rmw, a_learned),
        (a_trig & any_ltl, full(Decision.LOG_TOO_LOW)),
        (a_trig & (acks >= need), full(Decision.COMMIT_BCAST)),
        (a_trig & any_nack, a_nack_d),
    ])

    c_done = to_cmt & (acks >= commit_need)

    abd_reps = popcount8(abd_rep_bits)
    abd_acks = popcount8(abd_ack_bits)
    stores = popcount8(abd_store_bits)
    w2 = to_wq & (abd_reps >= majority)
    w_done = to_w & (abd_acks + 1 >= majority)      # +1 = local apply (§10)
    r_maj = to_rq & (abd_reps >= majority)
    r_done = r_maj & (stores >= majority)
    r_wb = r_maj & ~r_done
    rc_done = to_rc & (abd_acks + 1 >= majority)

    decision = _prio(full(Decision.WAIT), [
        (to_prop, p_decision),
        (to_acc, a_decision),
        (c_done, full(Decision.COMMIT_DONE)),
        (w2, full(Decision.ABD_W2)),
        (w_done, full(Decision.ABD_W_DONE)),
        (r_done, full(Decision.ABD_R_DONE)),
        (r_wb, full(Decision.ABD_R_WB)),
        (rc_done, full(Decision.ABD_RC_DONE)),
    ])
    rmw_decided = (to_prop | to_acc | to_cmt) \
        & (decision != int(Decision.WAIT))
    abd_decided = (to_wq | to_w | to_rq | to_rc) \
        & (decision != int(Decision.WAIT))

    # ---- actions ----------------------------------------------------------
    is_retry = decision == int(Decision.RETRY)
    is_ltl_d = decision == int(Decision.LOG_TOO_LOW)
    is_help = ((decision == int(Decision.HELP))
               | (decision == int(Decision.HELP_SELF)))
    is_cb = decision == int(Decision.COMMIT_BCAST)
    is_w2 = decision == int(Decision.ABD_W2)
    is_rwb = decision == int(Decision.ABD_R_WB)
    thin = is_cb & (acks >= n_machines)              # §8.6 thin commit

    z = torch.zeros_like(t.phase)
    bcast_kind = _prio(full(-1), [
        (is_cb, full(MsgKind.COMMIT)),
        (is_w2, full(MsgKind.WRITE)),
        (is_rwb, full(MsgKind.READ_COMMIT)),
    ])
    act_key = _prio(z, [(is_cb, t.key),
                        (is_w2 | is_rwb, t.abd_key)])
    act_sh_has = _where(is_retry, sh_has, 0)
    act_ts_v = _prio(z, [(is_retry & (sh_has == 1), sh_v),
                         (is_help, la_ts_v)])
    act_ts_m = _prio(z, [(is_retry, _where(sh_has == 1, sh_m, -1)),
                         (is_help, la_ts_m)])
    act_log = _prio(z, [(is_ltl_d, ltl_log), (is_cb, t.log_no),
                        (is_rwb, best_log)])
    act_rmw_cnt = _prio(z, [(is_ltl_d, ltl_cnt), (is_help, la_cnt),
                            (is_cb, t.rmw_cnt), (is_rwb, best_cnt)])
    act_rmw_sess = _prio(z, [(is_ltl_d, ltl_sess), (is_help, la_sess),
                             (is_cb, t.rmw_sess), (is_rwb, best_sess)])
    act_value = _prio(z, [(is_ltl_d, ltl_val), (is_help, la_val),
                          (is_cb, _where(thin, 0, t.value)),
                          (is_w2, t.abd_value), (is_rwb, best_val)])
    act_has_value = _where(is_cb, _where(thin, 0, 1), z)
    act_base_v = _prio(z, [(is_ltl_d, ltl_base_v), (is_help, la_base_v),
                           (is_cb, t.base_v), (is_w2, abd_maxb_v),
                           (is_rwb, best_base_v)])
    act_base_m = _prio(z, [(is_ltl_d, ltl_base_m), (is_help, la_base_m),
                           (is_cb, t.base_m), (is_w2, abd_maxb_m),
                           (is_rwb, best_base_m)])
    act_val_log = _prio(z, [(is_ltl_d, ltl_vlog), (is_help, la_vlog),
                            (is_cb, t.val_log), (is_rwb, best_vlog)])

    actions = ActionBatch(
        decision=decision, bcast_kind=bcast_kind, key=act_key,
        sh_has=act_sh_has, ts_v=act_ts_v, ts_m=act_ts_m, log_no=act_log,
        rmw_cnt=act_rmw_cnt, rmw_sess=act_rmw_sess, value=act_value,
        has_value=act_has_value, base_v=act_base_v, base_m=act_base_m,
        val_log=act_val_log)

    # ---- park decided lanes until the host starts their next round --------
    new_phase = _where(rmw_decided, int(Phase.PAUSED), t.phase)
    new_abd_phase = _where(abd_decided, ABD_PAUSED, t.abd_phase)

    new_t = t._replace(
        phase=new_phase, abd_phase=new_abd_phase,
        rep_bits=rep_bits, ack_bits=ack_bits,
        rmw_flag=rmw_flag, rmw_nb_flag=rmw_nb_flag, lth_flag=lth_flag,
        sh_has=sh_has, sh_v=sh_v, sh_m=sh_m,
        ltl_has=ltl_has, ltl_log=ltl_log, ltl_cnt=ltl_cnt,
        ltl_sess=ltl_sess, ltl_val=ltl_val, ltl_base_v=ltl_base_v,
        ltl_base_m=ltl_base_m, ltl_vlog=ltl_vlog,
        la_has=la_has, la_ts_v=la_ts_v, la_ts_m=la_ts_m, la_cnt=la_cnt,
        la_sess=la_sess, la_val=la_val, la_base_v=la_base_v,
        la_base_m=la_base_m, la_vlog=la_vlog,
        fr_has=fr_has, fr_val=fr_val, fr_base_v=fr_base_v,
        fr_base_m=fr_base_m, fr_log=fr_log,
        abd_rep_bits=abd_rep_bits, abd_ack_bits=abd_ack_bits,
        abd_store_bits=abd_store_bits,
        abd_maxb_v=abd_maxb_v, abd_maxb_m=abd_maxb_m,
        best_base_v=best_base_v, best_base_m=best_base_m,
        best_vlog=best_vlog, best_val=best_val, best_log=best_log,
        best_cnt=best_cnt, best_sess=best_sess)
    return new_t, actions


def proposer_step(t: ProposerTable, rep: IssuerReplyBatch, *,
                  n_machines: int, majority: int, commit_need: int,
                  log_too_high_threshold: int
                  ) -> Tuple[ProposerTable, ActionBatch]:
    """Ingest one conflict-free reply batch (at most one reply per session
    lane), fold the tallies, decide, and emit the next outbound wave —
    :func:`proposer_core` with deployment-wide int quorums."""
    return proposer_core(t, rep, n_machines, majority, commit_need,
                         log_too_high_threshold)
