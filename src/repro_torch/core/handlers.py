"""Receiver-side protocol handlers (paper §4.2, §4.5, §4.7, §10.3, §11).

Each handler takes the local replica state (the per-key :class:`KVPair` and
the registered-rmw-id table), applies the state transition the paper
specifies, and returns the :class:`Reply` to unicast back — or ``None`` when
no reply is due. They are deliberately side-effect-contained (mutate only the
passed ``kv`` / ``registry``) so they can be unit-tested cell-by-cell against
Table 1 and oracled against the vectorized engine.
"""

from __future__ import annotations

from typing import Dict, Optional

from .types import (
    ALL_ABOARD_VERSION, Carstamp, KVPair, KVState, Msg, MsgKind, Rep, Reply,
    RmwId, TS,
)


class Registry:
    """Bounded registered-rmw-id storage (§3.1.1): one counter per global
    session. ``committed[gsess] = c`` means every rmw-id ``(c' <= c, gsess)``
    has been committed."""

    def __init__(self, num_gsess: int):
        self.committed = [0] * num_gsess

    def is_registered(self, rid: RmwId) -> bool:
        if rid.gsess < 0:
            return False
        return self.committed[rid.gsess] >= rid.counter

    def register(self, rid: RmwId) -> None:
        if rid.gsess < 0:
            return
        if rid.counter > self.committed[rid.gsess]:
            self.committed[rid.gsess] = rid.counter


def _log_checks(kv: KVPair, msg: Msg, registry: Registry,
                reply_kind: MsgKind) -> Optional[Reply]:
    """Common prefix of propose/accept handling: rmw-id + log-no checks.

    Order matters and mirrors §4.2: a registered rmw-id dominates, then the
    log-no window test (inv-2/inv-3 enforcement via Log-too-low/high, §7.1).
    """
    if registry.is_registered(msg.rmw_id):
        # §8.1: second opcode tells the issuer it may skip commit broadcast
        # because a later log-no is already committed here (hence the RMW is
        # majority-committed by inv-1).
        if kv.last_committed_log_no >= msg.log_no:
            return Reply(reply_kind, -1, Rep.RMW_ID_COMMITTED_NO_BCAST,
                         msg.lid, key=msg.key)
        return Reply(reply_kind, -1, Rep.RMW_ID_COMMITTED, msg.lid,
                     key=msg.key)
    if msg.log_no <= kv.last_committed_log_no:
        # §4.2 Log-too-low: sender is behind; ship it the last committed RMW.
        return Reply(reply_kind, -1, Rep.LOG_TOO_LOW, msg.lid, key=msg.key,
                     log_no=kv.last_committed_log_no,
                     rmw_id=kv.last_committed_rmw_id, value=kv.value,
                     base_ts=kv.base_ts, val_log=kv.val_log)
    if msg.log_no > kv.last_committed_log_no + 1:
        # §4.2 Log-too-high: we don't know the previous slot's commit yet
        # (this nack is what enforces inv-2/inv-3; see §7.1.2-7.1.3).
        return Reply(reply_kind, -1, Rep.LOG_TOO_HIGH, msg.lid, key=msg.key)
    return None


def on_propose(kv: KVPair, msg: Msg, registry: Registry) -> Reply:
    """§4.2 — propose reception; §10.3 adds the base-TS freshness ack."""
    nack = _log_checks(kv, msg, registry, MsgKind.PROP_REPLY)
    if nack is not None:
        return nack

    # msg.log_no == last_committed + 1 == the working slot from here on.
    if kv.state == KVState.PROPOSED and kv.proposed_ts >= msg.ts:
        return Reply(MsgKind.PROP_REPLY, -1, Rep.SEEN_HIGHER_PROP, msg.lid,
                     key=msg.key, ts=kv.proposed_ts)
    if kv.state == KVState.ACCEPTED:
        # §8.3 optimization: same rmw-id already accepted with lower TSes on
        # both counts tells the proposer exactly what Seen-lower-acc would:
        # "broadcast accepts with your TS" — so just Ack.
        same_rmw_fastpath = (kv.rmw_id == msg.rmw_id
                             and kv.proposed_ts < msg.ts
                             and kv.accepted_ts < msg.ts)
        if kv.proposed_ts >= msg.ts:
            return Reply(MsgKind.PROP_REPLY, -1, Rep.SEEN_HIGHER_ACC, msg.lid,
                         key=msg.key, ts=kv.proposed_ts)
        # Seen-lower-acc (§4.2): stay ACCEPTED, advance proposed-TS, and give
        # the proposer everything needed to help (§6): accepted TS/value/rmw
        # plus the base-TS the accepted RMW chose (§10.3).
        kv.proposed_ts = msg.ts
        if same_rmw_fastpath:
            return _ack_with_base_check(kv, msg)
        return Reply(MsgKind.PROP_REPLY, -1, Rep.SEEN_LOWER_ACC, msg.lid,
                     key=msg.key, ts=kv.accepted_ts, rmw_id=kv.rmw_id,
                     value=kv.accepted_value, base_ts=kv.acc_base_ts,
                     val_log=msg.log_no)

    # Ack: KV-pair INVALID, or PROPOSED with a lower proposed-TS.
    kv.state = KVState.PROPOSED
    kv.log_no = msg.log_no
    kv.proposed_ts = msg.ts
    kv.rmw_id = msg.rmw_id
    return _ack_with_base_check(kv, msg)


def _ack_with_base_check(kv: KVPair, msg: Msg) -> Reply:
    """§10.3: an ack-able propose carrying a stale base-TS gets the fresher
    locally-stored value so the RMW serializes after completed ABD writes."""
    if Carstamp(kv.base_ts, kv.val_log) > Carstamp(msg.base_ts, msg.val_log):
        return Reply(MsgKind.PROP_REPLY, -1, Rep.ACK_BASE_TS_STALE, msg.lid,
                     key=msg.key, value=kv.value, base_ts=kv.base_ts,
                     val_log=kv.val_log)
    return Reply(MsgKind.PROP_REPLY, -1, Rep.ACK, msg.lid, key=msg.key)


def on_accept(kv: KVPair, msg: Msg, registry: Registry) -> Reply:
    """§4.5 — accept reception. Note the strict (not >=) TS comparisons: an
    accept with a TS *equal* to the proposed-TS is the green-cell case of
    Table 1 and must be acked."""
    nack = _log_checks(kv, msg, registry, MsgKind.ACC_REPLY)
    if nack is not None:
        return nack

    if kv.state == KVState.PROPOSED and kv.proposed_ts > msg.ts:
        return Reply(MsgKind.ACC_REPLY, -1, Rep.SEEN_HIGHER_PROP, msg.lid,
                     key=msg.key, ts=kv.proposed_ts)
    if kv.state == KVState.ACCEPTED and kv.proposed_ts > msg.ts:
        return Reply(MsgKind.ACC_REPLY, -1, Rep.SEEN_HIGHER_ACC, msg.lid,
                     key=msg.key, ts=kv.proposed_ts)
    # All-aboard epoch conflict (NOT in the paper's spec — see DESIGN.md):
    # two propose-less accepts in the same slot, (2, m1) < (2, m2), must not
    # displace one another.  Plain Table-1 rules would ack the higher one,
    # and then BOTH can gather all-acks (the earlier finished before the
    # later arrived) — a double decide.  FPaxos: an empty phase-1 quorum
    # must intersect phase-2 of every lower epoch, so within the all-aboard
    # epoch the acceptor is first-accept-wins; the loser falls back to CP
    # (version >= 3) and discovers the winner via Seen-lower-acc.
    if (msg.ts.version == ALL_ABOARD_VERSION
            and kv.state == KVState.ACCEPTED
            and kv.accepted_ts.version == ALL_ABOARD_VERSION
            and kv.rmw_id != msg.rmw_id):
        return Reply(MsgKind.ACC_REPLY, -1, Rep.SEEN_HIGHER_ACC, msg.lid,
                     key=msg.key, ts=kv.proposed_ts)

    # Ack: INVALID, or PROPOSED/ACCEPTED with proposed-TS <= accept's TS.
    kv.state = KVState.ACCEPTED
    kv.log_no = msg.log_no
    kv.proposed_ts = msg.ts
    kv.accepted_ts = msg.ts
    kv.accepted_value = msg.value
    kv.acc_base_ts = msg.base_ts
    kv.rmw_id = msg.rmw_id
    return Reply(MsgKind.ACC_REPLY, -1, Rep.ACK, msg.lid, key=msg.key)


def commit_to_kv(kv: KVPair, registry: Registry, *, log_no: int,
                 rmw_id: RmwId, value: Optional[int], base_ts: TS,
                 val_log: int) -> bool:
    """§4.7 — unconditional commit application (also used for Log-too-low
    payloads, §8.7 re-commits, and ABD read write-backs).

    Returns False only for the §8.6 no-value pitfall: a thin commit whose
    value we cannot reconstruct because the KV-pair progressed — in which
    case the commit is already reflected here and is safely ignored.
    """
    resolved_value, resolved_base = value, base_ts
    if value is None:
        # §8.6 thin commit: only legal when every machine acked the accept,
        # i.e. we hold the accepted value ourselves.
        if (kv.state == KVState.ACCEPTED and kv.rmw_id == rmw_id
                and kv.log_no == log_no):
            resolved_value = kv.accepted_value
            resolved_base = kv.acc_base_ts    # §10.3 pitfall guard
        else:
            # We acked the accept (§8.6 precondition) but progressed since —
            # either this commit already reached us (registered) or a
            # higher-log commit leapfrogged us. The value is unrecoverable
            # here, but registration and log bookkeeping are still safe and
            # useful (value installation below is carstamp-gated regardless).
            registry.register(rmw_id)
            if log_no > kv.last_committed_log_no:
                kv.last_committed_log_no = log_no
                kv.last_committed_rmw_id = rmw_id
            if kv.state != KVState.INVALID and kv.log_no <= log_no:
                kv.state = KVState.INVALID
            return False

    registry.register(rmw_id)
    if log_no > kv.last_committed_log_no:
        kv.last_committed_log_no = log_no
        kv.last_committed_rmw_id = rmw_id
    # Value visibility is carstamp-ordered (§10): an RMW's value must not
    # clobber a later ABD write that already landed here.
    if Carstamp(resolved_base, val_log) > kv.carstamp:
        kv.value = resolved_value
        kv.base_ts = resolved_base
        kv.val_log = val_log
    # Release the working slot if the commit covers it (§4.7).
    if kv.state != KVState.INVALID and kv.log_no <= log_no:
        kv.state = KVState.INVALID
        kv.proposed_ts = TS(0, -1)
        kv.accepted_ts = TS(0, -1)
    return True


def on_commit(kv: KVPair, msg: Msg, registry: Registry) -> Reply:
    commit_to_kv(kv, registry, log_no=msg.log_no, rmw_id=msg.rmw_id,
                 value=msg.value, base_ts=msg.base_ts, val_log=msg.val_log)
    return Reply(MsgKind.COMMIT_ACK, -1, Rep.ACK, msg.lid, key=msg.key)


# ---------------------------------------------------------------------------
# ABD writes (§10) and reads (§11)
# ---------------------------------------------------------------------------

def on_write_query(kv: KVPair, msg: Msg) -> Reply:
    """ABD write round 1: report the highest base-TS stored locally."""
    return Reply(MsgKind.WRITE_QUERY_REPLY, -1, Rep.ACK, msg.lid, key=msg.key,
                 base_ts=kv.base_ts)


def on_write(kv: KVPair, msg: Msg) -> Reply:
    """ABD write round 2: install iff carstamp ``(base, 0)`` is newer."""
    if Carstamp(msg.base_ts, 0) > kv.carstamp:
        kv.value = msg.value
        kv.base_ts = msg.base_ts
        kv.val_log = 0
    return Reply(MsgKind.WRITE_ACK, -1, Rep.ACK, msg.lid, key=msg.key)


def on_read_query(kv: KVPair, msg: Msg) -> Reply:
    """§11: three-way carstamp comparison against the reader's carstamp."""
    mine = kv.carstamp
    theirs = Carstamp(msg.base_ts, msg.val_log)
    if theirs < mine:
        return Reply(MsgKind.READ_QUERY_REPLY, -1, Rep.CARSTAMP_TOO_LOW,
                     msg.lid, key=msg.key, value=kv.value, base_ts=kv.base_ts,
                     val_log=kv.val_log, rmw_id=kv.last_committed_rmw_id,
                     log_no=kv.last_committed_log_no)
    if theirs == mine:
        return Reply(MsgKind.READ_QUERY_REPLY, -1, Rep.CARSTAMP_EQUAL,
                     msg.lid, key=msg.key)
    return Reply(MsgKind.READ_QUERY_REPLY, -1, Rep.CARSTAMP_TOO_HIGH,
                 msg.lid, key=msg.key)


def apply_msg(kv: KVPair, msg: Msg, registry: Registry) -> Reply:
    """Single scalar entry point for every receiver-side message kind.

    This is the equivalence hook for the vectorized engine: one scalar
    message application == one lane of :func:`repro_torch.core.vector.apply_batch`
    (the differential trace-replay harness in :mod:`repro_torch.core.replay`
    drives both through this correspondence).  ``READ_COMMIT`` (§11 read
    write-back) has full commit semantics on the receiver and shares
    :func:`on_commit`, ``COMMIT_ACK`` reply included — the issuer routes
    that ack by lid, as for any commit; the distinct wire kind only keeps
    write-backs distinguishable in traces and stats.
    """
    if msg.kind == MsgKind.PROPOSE:
        return on_propose(kv, msg, registry)
    if msg.kind == MsgKind.ACCEPT:
        return on_accept(kv, msg, registry)
    if msg.kind in (MsgKind.COMMIT, MsgKind.READ_COMMIT):
        return on_commit(kv, msg, registry)
    if msg.kind == MsgKind.WRITE_QUERY:
        return on_write_query(kv, msg)
    if msg.kind == MsgKind.WRITE:
        return on_write(kv, msg)
    if msg.kind == MsgKind.READ_QUERY:
        return on_read_query(kv, msg)
    if msg.kind in (MsgKind.VIEW, MsgKind.JOIN_REQ, MsgKind.SYNC):
        # reconfiguration control plane: host-intercepted by Machine._admit
        # (epoch fencing) before dispatch ever reaches the KV handlers or
        # the receiver engine — reaching here is a routing bug.
        raise ValueError(f"control-plane kind {msg.kind!r} must be admitted "
                         f"by Machine._admit, not applied to a KVPair")
    raise ValueError(f"not a receiver-side message kind: {msg.kind!r}")


def get_kv(kvs: Dict[int, KVPair], key: int) -> KVPair:
    kv = kvs.get(key)
    if kv is None:
        kv = kvs[key] = KVPair(key=key)
    return kv
