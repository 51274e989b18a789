"""Issuer-side pure transition layer (paper §4–§6, §8–§11, proposer half).

The proposer/issuer state machine in :mod:`repro_torch.core.node` interleaves two
kinds of logic:

* **pure tally transitions** — folding one reply into the per-round
  bookkeeping (:class:`repro_torch.core.types.Tally`, :class:`AbdEntry`) and
  deciding what the round does next (§4.3 propose replies, §4.6/§9.2 accept
  replies, §8.7 commit acks, §10–§11 ABD quorums); and
* **KV-coupled actions** — grabbing the local pair, computing accept values
  (§8.5/§10.1), committing locally — which read and write the *shared*
  per-key store.

This module is the single source of truth for the first kind, in the same
way :func:`repro_torch.core.handlers.apply_msg` is for the receiver side: the
scalar :class:`~repro_torch.core.node.Machine` dispatches on these functions, and
the batched engine in :mod:`repro_torch.core.proposer_vector` mirrors them
lane-for-lane (differentially replayed by :mod:`repro_torch.core.replay`).

It also defines the **issuer trace** event records: a machine with
``issuer_trace`` enabled logs every round start, every reply it steers into
a tally, every non-WAIT decision (with the payload the decision acted on),
and every out-of-band round abandonment ("pause": retries/stop-helping from
inspection timeouts).  That stream is exactly the input+oracle of the
differential proposer replay.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple

from .types import (
    CS_ZERO, Carstamp, MsgKind, Rep, Reply, RmwId, TS, TS_ZERO, Tally,
)


# ---------------------------------------------------------------------------
# ABD per-session entries (§10–§11) — issuer-side pure state
# ---------------------------------------------------------------------------

class AbdPhase(enum.IntEnum):
    IDLE = 0
    W_QUERY = 1
    W_WRITE = 2
    R_QUERY = 3
    R_COMMIT = 4


@dataclasses.dataclass
class AbdEntry:
    sess: int
    phase: AbdPhase = AbdPhase.IDLE
    key: int = 0
    value: int = 0
    lid: int = 0
    # per-source reply sets: duplicated replies must not fake quorums
    repliers: set = dataclasses.field(default_factory=set)
    ackers: set = dataclasses.field(default_factory=set)
    max_base: TS = TS_ZERO
    # read state
    sent_cs: Carstamp = CS_ZERO          # carstamp the READ_QUERY carried
    best_cs: Carstamp = CS_ZERO
    best_value: int = 0
    best_log_no: int = 0
    best_rmw_id: RmwId = dataclasses.field(default_factory=lambda: RmwId(0, -1))
    storers: set = dataclasses.field(default_factory=set)  # who stores best_cs
    round_age: int = 0
    tag: int = 0


# ---------------------------------------------------------------------------
# Decisions — the shared issuer vocabulary (stable ints: they live in int32
# planes on the batched side and in trace events)
# ---------------------------------------------------------------------------

class Decision(enum.IntEnum):
    WAIT = 0                     # keep gathering replies
    # propose/accept round outcomes (§4.3, §4.6)
    LEARNED = 1                  # Rmw-id-committed: bcast commits (§8.1)
    LEARNED_NO_BCAST = 2         # ... later log committed too: just finish
    LOG_TOO_LOW = 3              # commit the payload locally, start over (§8.2)
    RETRY = 4                    # seen-higher / nacked accept: higher TS (§8.4)
    LOCAL_ACCEPT = 5             # majority propose acks (§8.5 'not helping')
    HELP = 6                     # Seen-lower-acc with a foreign rmw-id (§6)
    HELP_SELF = 7                # Seen-lower-acc with our own rmw-id (§8.4)
    RETRY_LOG_TOO_HIGH = 8       # log-too-high below the §8.7 threshold
    RECOMMIT = 9                 # §8.7: re-broadcast the previous slot's commit
    COMMIT_BCAST = 10            # accept quorum reached: broadcast commits
    STOP_HELP = 11               # any nack (or h-RMW committed) cancels help
    COMMIT_DONE = 12             # commit-ack quorum reached (§8.7)
    # ABD round outcomes (§10–§11)
    ABD_W2 = 13                  # write round-1 majority: send phase-2 WRITE
    ABD_W_DONE = 14              # write round-2 majority: completed
    ABD_R_DONE = 15              # read: majority stores best -> done
    ABD_R_WB = 16                # read: write-back commit round needed (§11)
    ABD_RC_DONE = 17             # write-back acked by majority: read done


# ---------------------------------------------------------------------------
# RMW round decisions (pure: Tally + deployment knobs in, Decision out)
# ---------------------------------------------------------------------------

def decide_propose(t: Tally, *, majority: int, own_rmw_id: RmwId,
                   log_too_high_counter: int, log_too_high_threshold: int
                   ) -> Tuple[Decision, Optional[Reply]]:
    """§4.3 propose-reply arbitration, in the paper's priority order.

    Returns the decision plus the reply payload it acted on (the max-log
    Log-too-low reply, or the max-accepted-TS Seen-lower-acc reply).
    """
    triggered = (t.rmw_committed or t.log_too_low is not None
                 or t.seen_higher is not None or t.total >= majority)
    if not triggered:
        return Decision.WAIT, None
    if t.rmw_committed:
        return (Decision.LEARNED_NO_BCAST if t.rmw_committed_no_bcast
                else Decision.LEARNED), None
    if t.log_too_low is not None:
        return Decision.LOG_TOO_LOW, t.log_too_low
    if t.seen_higher is not None:
        return Decision.RETRY, None
    if t.acks >= majority:
        return Decision.LOCAL_ACCEPT, None
    if t.lower_acc is not None:
        if t.lower_acc.rmw_id == own_rmw_id:
            return Decision.HELP_SELF, t.lower_acc
        return Decision.HELP, t.lower_acc
    if t.log_too_high:
        if log_too_high_counter + 1 >= log_too_high_threshold:
            return Decision.RECOMMIT, None
        return Decision.RETRY_LOG_TOO_HIGH, None
    # Majority of replies but no decision (e.g. mixed acks below quorum):
    # wait for stragglers; the retransmit timer resolves true losses.
    return Decision.WAIT, None


def decide_accept(t: Tally, *, n_machines: int, majority: int,
                  helping: bool, all_aboard: bool
                  ) -> Tuple[Decision, Optional[Reply]]:
    """§4.6 accept-reply arbitration (+ §9.2 all-aboard full-quorum rule)."""
    any_nack = (t.rmw_committed or t.log_too_low is not None
                or t.seen_higher is not None or t.log_too_high)
    triggered = (t.rmw_committed or t.log_too_low is not None
                 or t.total >= majority
                 or ((helping or all_aboard) and any_nack))
    if not triggered:
        return Decision.WAIT, None
    if t.rmw_committed:
        if helping:
            return Decision.STOP_HELP, None      # h-RMW already committed
        return (Decision.LEARNED_NO_BCAST if t.rmw_committed_no_bcast
                else Decision.LEARNED), None
    if t.log_too_low is not None:
        return Decision.LOG_TOO_LOW, t.log_too_low
    need = n_machines if all_aboard else majority
    if t.acks >= need:
        return Decision.COMMIT_BCAST, None
    if any_nack:
        return (Decision.STOP_HELP if helping else Decision.RETRY), None
    # majority replied, only acks but below the required quorum
    # (all-aboard waiting for everyone): handled by inspection timeouts.
    return Decision.WAIT, None


def decide_commit(t: Tally, *, majority: int,
                  quorum_is_majority: bool) -> Decision:
    """§8.7: apply the commit locally only after (a majority of) acks."""
    need = majority - 1 if quorum_is_majority else 1
    return Decision.COMMIT_DONE if t.acks >= need else Decision.WAIT


# ---------------------------------------------------------------------------
# ABD transitions (§10–§11): fold one reply, then decide
# ---------------------------------------------------------------------------

def abd_fold(ab: AbdEntry, rep: Reply) -> bool:
    """Fold one steered reply into an ABD entry (§10 rounds, §11 compare).

    Gating (phase/kind/lid mismatch -> dropped) mirrors
    ``Machine._abd_reply`` exactly; returns whether the reply was consumed.
    """
    if ab.phase == AbdPhase.IDLE or rep.lid != ab.lid:
        return False
    if rep.kind == MsgKind.WRITE_QUERY_REPLY and ab.phase == AbdPhase.W_QUERY:
        ab.repliers.add(rep.src)
        if rep.base_ts > ab.max_base:
            ab.max_base = rep.base_ts
        return True
    if rep.kind == MsgKind.WRITE_ACK and ab.phase == AbdPhase.W_WRITE:
        ab.ackers.add(rep.src)
        return True
    if rep.kind == MsgKind.READ_QUERY_REPLY and ab.phase == AbdPhase.R_QUERY:
        ab.repliers.add(rep.src)
        if rep.opcode == Rep.CARSTAMP_TOO_LOW:
            cs = Carstamp(rep.base_ts, rep.val_log)
            if cs > ab.best_cs:
                ab.best_cs, ab.best_value = cs, rep.value
                ab.best_log_no, ab.best_rmw_id = rep.log_no, rep.rmw_id
                ab.storers = {rep.src}
            elif cs == ab.best_cs:
                ab.storers.add(rep.src)
        elif rep.opcode == Rep.CARSTAMP_EQUAL:
            # replier stores exactly the carstamp the query carried
            if ab.best_cs == ab.sent_cs:
                ab.storers.add(rep.src)
        return True
    if rep.kind == MsgKind.COMMIT_ACK and ab.phase == AbdPhase.R_COMMIT:
        ab.ackers.add(rep.src)
        return True
    return False


def decide_abd(ab: AbdEntry, *, majority: int) -> Decision:
    """Quorum checks per ABD phase. The ``+1`` on ack quorums is the local
    apply (§10: the issuer installs/commits locally at broadcast time)."""
    if ab.phase == AbdPhase.W_QUERY and len(ab.repliers) >= majority:
        return Decision.ABD_W2
    if ab.phase == AbdPhase.W_WRITE and len(ab.ackers) + 1 >= majority:
        return Decision.ABD_W_DONE
    if ab.phase == AbdPhase.R_QUERY and len(ab.repliers) >= majority:
        if len(ab.storers) >= majority:
            return Decision.ABD_R_DONE
        return Decision.ABD_R_WB               # §11 commit round
    if ab.phase == AbdPhase.R_COMMIT and len(ab.ackers) + 1 >= majority:
        return Decision.ABD_RC_DONE
    return Decision.WAIT


# ---------------------------------------------------------------------------
# Decision payloads: the planes a decision acted on, as flat int dicts.
# Recorded on the issuer trace by the live Machine and reproduced by the
# batched engine's ActionBatch — the emission half of the differential
# proposer replay.
# ---------------------------------------------------------------------------

# Which ActionBatch planes a decision's payload pins down (mirrors the
# payload dicts built below and in Machine._commit_bcast_payload /
# Machine._abd_reply).  Shared by the differential replay (oracle side) and
# the batched serve machine (live side, repro_torch.serve.paxos.bridge).
ACTION_PAYLOAD_KEYS = {
    Decision.RETRY: ("sh_has", "ts_v", "ts_m"),
    Decision.LOG_TOO_LOW: ("log_no", "rmw_cnt", "rmw_sess", "value",
                           "base_v", "base_m", "val_log"),
    Decision.HELP: ("ts_v", "ts_m", "rmw_cnt", "rmw_sess", "value",
                    "base_v", "base_m", "val_log"),
    Decision.HELP_SELF: ("ts_v", "ts_m", "rmw_cnt", "rmw_sess", "value",
                         "base_v", "base_m", "val_log"),
    Decision.COMMIT_BCAST: ("log_no", "rmw_cnt", "rmw_sess", "value",
                            "has_value", "base_v", "base_m", "val_log"),
    Decision.ABD_W2: ("key", "value", "base_v", "base_m"),
    Decision.ABD_R_WB: ("key", "log_no", "rmw_cnt", "rmw_sess", "value",
                        "base_v", "base_m", "val_log"),
}

# Wire MsgKind of the broadcast an engine-owned emission carries (the
# ActionBatch ``bcast_kind`` plane).
BCAST_KINDS = {
    Decision.COMMIT_BCAST: int(MsgKind.COMMIT),
    Decision.ABD_W2: int(MsgKind.WRITE),
    Decision.ABD_R_WB: int(MsgKind.READ_COMMIT),
}


def retry_payload(t: Tally) -> Dict[str, int]:
    """RETRY: the max blocking proposed-TS observed (drives §8.4 TS bump)."""
    sh = t.seen_higher
    return {"sh_has": int(sh is not None),
            "ts_v": sh.version if sh is not None else 0,
            "ts_m": sh.mid if sh is not None else -1}


def log_too_low_payload(rep: Reply) -> Dict[str, int]:
    """LOG_TOO_LOW: the max-log payload to commit locally (§8.2)."""
    return {"log_no": rep.log_no, "rmw_cnt": rep.rmw_id.counter,
            "rmw_sess": rep.rmw_id.gsess, "value": rep.value,
            "base_v": rep.base_ts.version, "base_m": rep.base_ts.mid,
            "val_log": rep.val_log}


def lower_acc_payload(rep: Reply) -> Dict[str, int]:
    """HELP/HELP_SELF: the max-accepted-TS Seen-lower-acc payload (§6)."""
    return {"ts_v": rep.ts.version, "ts_m": rep.ts.mid,
            "rmw_cnt": rep.rmw_id.counter, "rmw_sess": rep.rmw_id.gsess,
            "value": rep.value, "base_v": rep.base_ts.version,
            "base_m": rep.base_ts.mid, "val_log": rep.val_log}


# ---------------------------------------------------------------------------
# Issuer trace events (input + oracle of the differential proposer replay)
# ---------------------------------------------------------------------------

# RMW lane phases as they appear in trace round events and ProposerTable
# planes.  PAUSED marks a lane whose round ended (decision fired, or the
# machine abandoned the round from an inspection timeout) and that waits
# for its next round event to be reloaded.
class Phase(enum.IntEnum):
    IDLE = 0
    PROPOSED = 1
    ACCEPTED = 2
    COMMITTED = 3
    PAUSED = 4


ABD_PAUSED = 9          # AbdPhase plane sentinel, disjoint from AbdPhase codes


@dataclasses.dataclass
class RmwRound:
    """A propose/accept/commit broadcast: reloads the session's RMW lane."""

    sess: int
    phase: Phase                 # PROPOSED / ACCEPTED / COMMITTED
    lid: int
    key: int
    ts: TS                       # round TS (propose/accept); TS_ZERO commits
    log_no: int
    rmw_id: RmwId                # round rmw-id (helped one on help accepts)
    value: int                   # accept value / commit value (0 if thin)
    has_value: int               # 0 only for §8.6 thin commit rounds
    base_ts: TS
    val_log: int
    aboard: int                  # §9 all-aboard accept round
    helping: int                 # §6 helping accept round
    lth_counter: int             # le.log_too_high_counter at round start


@dataclasses.dataclass
class AbdRound:
    """An ABD phase start: reloads the session's ABD lane (§10–§11)."""

    sess: int
    phase: AbdPhase
    lid: int
    key: int
    value: int                   # write value / read best value
    base_ts: TS                  # W_QUERY/W_WRITE: max_base; R_*: best base
    val_log: int                 # R_*: best carstamp log part
    sent_base_ts: TS             # R_QUERY: carstamp the query carried
    sent_val_log: int
    log_no: int                  # R_*: best last-committed log-no
    rmw_id: RmwId                # R_*: best last-committed rmw-id
    rep_bits: int                # initial replier bitmap (local reply)
    store_bits: int              # initial storer bitmap (local store)


@dataclasses.dataclass
class ReplyEvent:
    """One reply steered into the issuer (remote, or a local synthetic
    note such as the §5/§8.4 Seen-lower-acc self-note)."""

    sess: int
    reply: Reply


@dataclasses.dataclass
class DecisionEvent:
    """A non-WAIT decision the live machine took, with the payload planes
    the batched engine must reproduce for it (see replay)."""

    sess: int
    decision: Decision
    payload: Optional[Dict[str, int]] = None


@dataclasses.dataclass
class PauseEvent:
    """The machine left a reply-gathering state outside the decision path
    (inspection-timeout retry, stop-helping, failed local accept): the
    lane must stop tallying until its next round event."""

    sess: int
    abd: int = 0                 # 1: pause the ABD lane instead of the RMW one
