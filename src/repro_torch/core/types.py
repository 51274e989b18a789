"""Core protocol types for the extended Classic Paxos RMW register (paper §3).

Everything here mirrors the paper's data structures:

* logical timestamps ``TS = (version, machine-id)`` (§3.1, Lamport clocks),
* carstamps ``(base-TS, log-no)`` serializing ABD writes against RMWs (§10),
* the per-key ``KVPair`` metadata block (§3.1.1),
* the per-session ``LocalEntry`` (§3.1.2),
* message / reply opcodes (§4).

The scalar (host) protocol implementation in :mod:`repro_torch.core.handlers` and
the vectorized engine in :mod:`repro_torch.core.vector` both derive from these
definitions; enum values are stable integers so they can live in int32 planes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional, Tuple


# ---------------------------------------------------------------------------
# Timestamps (§3.1) and carstamps (§10)
# ---------------------------------------------------------------------------

class TS(NamedTuple):
    """Logical timestamp: compare by version, machine-id breaks ties."""

    version: int
    mid: int

    def bump(self, new_version: int, mid: Optional[int] = None) -> "TS":
        return TS(new_version, self.mid if mid is None else mid)


TS_ZERO = TS(0, -1)

# All-aboard accepts use version 2, first Classic-Paxos propose uses 3 (§9.2):
# any CP propose is thereby guaranteed to exceed any All-aboard accept.
ALL_ABOARD_VERSION = 2
FIRST_PROPOSE_VERSION = 3


class Carstamp(NamedTuple):
    """``(base-TS, log-no)`` — lexicographic order (§10).

    Writes commit with ``log_no == 0`` at a fresh, higher ``base`` TS; an RMW
    adopts the base TS of the value it overwrites and a per-key log-no >= 1,
    so ``(b, 0) < (b, l_rmw)`` and any later write beats earlier RMWs.
    """

    base: TS
    log_no: int


CS_ZERO = Carstamp(TS_ZERO, 0)


class RmwId(NamedTuple):
    """Unique RMW identifier: per-session counter + global session id (§3.1.1)."""

    counter: int
    gsess: int


RMW_ID_NONE = RmwId(0, -1)


# ---------------------------------------------------------------------------
# RMW operations
# ---------------------------------------------------------------------------

class RmwOp(enum.IntEnum):
    """Kinds of read-modify-write supported by the register."""

    FAA = 0         # fetch-and-add: v' = v + arg1
    CAS = 1         # compare-and-swap: v' = arg2 if v == arg1 else v
    SWAP = 2        # unconditional exchange: v' = arg1
    FETCH = 3       # consensus read (identity RMW): v' = v


def apply_rmw(op: RmwOp, value: int, arg1: int, arg2: int) -> int:
    """The deterministic modify function. Must match vector.apply_rmw_vec."""
    if op == RmwOp.FAA:
        return value + arg1
    if op == RmwOp.CAS:
        return arg2 if value == arg1 else value
    if op == RmwOp.SWAP:
        return arg1
    if op == RmwOp.FETCH:
        return value
    raise ValueError(f"unknown RmwOp {op!r}")


# ---------------------------------------------------------------------------
# KV-pair / Local-entry states (§3.1.1, §3.1.2)
# ---------------------------------------------------------------------------

class KVState(enum.IntEnum):
    INVALID = 0
    PROPOSED = 1
    ACCEPTED = 2


class LEState(enum.IntEnum):
    INVALID = 0                 # session idle: no RMW in flight
    NEEDS_KV = 1                # back-off: waiting to grab the local KV-pair
    PROPOSED = 2                # proposes broadcast, gathering replies
    ACCEPTED = 3                # accepts broadcast, gathering replies
    RETRY_WITH_HIGHER_TS = 4
    BCAST_COMMITS = 5
    BCAST_COMMITS_FROM_HELP = 6
    COMMITTED = 7               # commits broadcast, gathering commit acks


class HelpFlag(enum.IntEnum):
    NOT_HELPING = 0
    HELPING = 1                   # helping a remote h-RMW (§6)
    PROPOSE_LOCALLY_ACCEPTED = 2  # "helping myself" candidacy (§8.4)


# ---------------------------------------------------------------------------
# Membership views (live reconfiguration)
# ---------------------------------------------------------------------------

# The issuer engine folds replies into per-source bitmaps
# (``proposer_vector``: ``1 << clip(src, 0, 7)``), so machine ids must fit
# one byte's worth of bitmap lanes.  The paper deploys 3–7 machines (§2);
# 8 leaves join-before-leave headroom without widening the engines.
MAX_MEMBERS = 8

# The reserved config register: the active View lives in this key and is
# changed only via normal CP RMWs (CAS) through the ordinary proposer path.
# Client workloads that coexist with reconfiguration must keep their keys
# above it (see ``sim.workload(key_base=...)``).
CONFIG_KEY = 0


class View(NamedTuple):
    """A membership view: epoch + the member set, decided in the config
    register.  Encoded into one int32 register value as
    ``epoch << MAX_MEMBERS | member-bitmap``, so a view change is just a
    CAS on :data:`CONFIG_KEY`.

    This is THE home of quorum arithmetic: classic majority quorums come
    from :meth:`quorum`, the all-aboard superquorum from
    :meth:`all_aboard_quorum`.  Single-member deltas (enforced by
    ``repro_torch.reconfig.views.validate_transition``) keep consecutive views'
    majority quorums intersecting, which is what makes deciding the next
    view in the *old* view's quorums safe.
    """

    epoch: int
    members: Tuple[int, ...]

    @property
    def n(self) -> int:
        return len(self.members)

    def quorum(self) -> int:
        """Classic-Paxos majority quorum size for this view."""
        return View.quorum_of(len(self.members))

    def all_aboard_quorum(self) -> int:
        """§9 all-aboard superquorum: every member must ack."""
        return len(self.members)

    @staticmethod
    def quorum_of(n: int) -> int:
        """The single definition of a majority over ``n`` machines."""
        return n // 2 + 1

    @staticmethod
    def initial(n_machines: int) -> "View":
        return View(0, tuple(range(n_machines)))

    def encode(self) -> int:
        bits = 0
        for m in self.members:
            bits |= 1 << m
        return (self.epoch << MAX_MEMBERS) | bits

    @staticmethod
    def decode(value: int) -> Optional["View"]:
        """Decode a config-register value; ``None`` for the unset register
        (value 0 → the deployment's initial view applies)."""
        if value is None or value <= 0:
            return None
        bits = value & ((1 << MAX_MEMBERS) - 1)
        members = tuple(m for m in range(MAX_MEMBERS) if (bits >> m) & 1)
        if not members:
            return None
        return View(value >> MAX_MEMBERS, members)


# ---------------------------------------------------------------------------
# Wire messages (§3.1 "Message Types", §10.3, §11)
# ---------------------------------------------------------------------------
#
# Epoch fencing rule (live reconfiguration):
#   every protocol Msg/Reply carries the sender's view ``epoch``.  A machine
#   in view E drops any protocol payload whose epoch != E — stale traffic
#   (epoch < E) additionally triggers a VIEW notice back to the sender so it
#   can catch up; ahead-of-us traffic (epoch > E) is dropped until the
#   commit/VIEW announcement installs the newer view here.  Three kinds are
#   exempt because they ARE the catch-up plane and never count toward
#   quorums: VIEW (announce a committed view; delivered even to removed
#   machines), JOIN_REQ (a syncing joiner asking a member for a snapshot)
#   and SYNC (the snapshot answer; carries committed state only).  Together
#   with every in-flight round restarting its tally on view install, this
#   guarantees no quorum ever mixes replies from two different views.

class MsgKind(enum.IntEnum):
    PROPOSE = 0
    ACCEPT = 1
    COMMIT = 2
    PROP_REPLY = 3
    ACC_REPLY = 4
    COMMIT_ACK = 5
    # ABD (§10, §11)
    WRITE_QUERY = 6        # ABD write round 1: ask for base-TS
    WRITE_QUERY_REPLY = 7
    WRITE = 8              # ABD write round 2: install value at base-TS
    WRITE_ACK = 9
    READ_QUERY = 10        # ABD read round 1: carstamp compare
    READ_QUERY_REPLY = 11
    READ_COMMIT = 12       # §11 read write-back: commit semantics, ABD issuer
    # reconfiguration control plane (host-intercepted; never reach the
    # receiver engine and never count toward protocol quorums)
    VIEW = 13              # committed-view announcement (encoded in `value`)
    JOIN_REQ = 14          # syncing joiner -> member: send me a snapshot
    SYNC = 15              # member -> joiner: snapshot blob + donor view


class Rep(enum.IntEnum):
    """Reply opcodes for propose/accept replies (§4.2, §4.5, §10.3)."""

    ACK = 0
    ACK_BASE_TS_STALE = 1      # ack, but here is a fresher base-TS/value (§10.3)
    RMW_ID_COMMITTED = 2       # your rmw-id is registered; bcast commits (§8.1)
    RMW_ID_COMMITTED_NO_BCAST = 3   # ... and a later log-no committed: skip bcast
    LOG_TOO_LOW = 4
    LOG_TOO_HIGH = 5
    SEEN_HIGHER_PROP = 6
    SEEN_HIGHER_ACC = 7
    SEEN_LOWER_ACC = 8
    # ABD read replies (§11)
    CARSTAMP_TOO_LOW = 9       # reader's carstamp older than mine: payload value+cs
    CARSTAMP_EQUAL = 10
    CARSTAMP_TOO_HIGH = 11     # reader is ahead of me


NACKS = frozenset({
    Rep.RMW_ID_COMMITTED, Rep.RMW_ID_COMMITTED_NO_BCAST, Rep.LOG_TOO_LOW,
    Rep.LOG_TOO_HIGH, Rep.SEEN_HIGHER_PROP, Rep.SEEN_HIGHER_ACC,
    Rep.SEEN_LOWER_ACC,
})


@dataclasses.dataclass
class Msg:
    """A broadcast/unicast protocol message.

    Not every field is meaningful for every kind; ``lid`` steers replies back
    to the issuing Local-entry (§3.1.2).
    """

    kind: MsgKind
    src: int
    key: int = 0
    ts: TS = TS_ZERO
    log_no: int = 0
    rmw_id: RmwId = RMW_ID_NONE
    value: Optional[int] = None      # None on commits = §8.6 no-value commit
    base_ts: TS = TS_ZERO            # carstamp base (§10.3)
    val_log: int = 0                 # carstamp log part carried by commits
    lid: int = 0
    epoch: int = 0                   # sender's view epoch (fencing rule above)
    blob: object = None              # SYNC only: the snapshot tree

    def size_bytes(self) -> int:
        """Approximate wire size; used by the message-count/bytes benchmarks."""
        base = 1 + 1 + 4 + 8 + 8 + 8          # kind, src, key, ts, log, rmw_id
        if self.kind in (MsgKind.PROPOSE, MsgKind.ACCEPT, MsgKind.COMMIT,
                         MsgKind.READ_COMMIT, MsgKind.WRITE):
            base += 8 + 4                      # base_ts + val_log
        if self.value is not None:
            base += 8
        return base + 8                        # lid

    def clone(self) -> "Msg":
        """A shallow field copy, bypassing ``__init__``.

        ``dataclasses.replace`` re-runs the constructor per copy, which
        dominates the hot broadcast/trace paths (one copy per destination
        per send); TS/RmwId payloads are immutable, so a ``__dict__``
        copy is equivalent.
        """
        dup = Msg.__new__(Msg)
        dup.__dict__.update(self.__dict__)
        return dup


@dataclasses.dataclass
class Reply:
    """A unicast reply to a broadcast; ``opcode`` per :class:`Rep`."""

    kind: MsgKind
    src: int
    opcode: Rep
    lid: int
    key: int = 0
    # payloads (presence depends on opcode; see §4.2 / §4.5 / §10.3 / §11)
    ts: TS = TS_ZERO                 # Seen-higher-*: the blocking proposed-TS
    log_no: int = 0                  # Log-too-low: last committed log-no
    rmw_id: RmwId = RMW_ID_NONE      # Log-too-low / Seen-lower-acc
    value: Optional[int] = None
    base_ts: TS = TS_ZERO
    val_log: int = 0
    epoch: int = 0                   # sender's view epoch (fencing rule above)

    def size_bytes(self) -> int:
        base = 1 + 1 + 1 + 8 + 4
        if self.opcode in (Rep.LOG_TOO_LOW, Rep.SEEN_LOWER_ACC,
                           Rep.ACK_BASE_TS_STALE, Rep.CARSTAMP_TOO_LOW):
            base += 8 + 8 + 8 + 4
        if self.opcode in (Rep.SEEN_HIGHER_PROP, Rep.SEEN_HIGHER_ACC):
            base += 8
        return base


# ---------------------------------------------------------------------------
# The KV-pair (§3.1.1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVPair:
    """Per-key metadata. The 10 fields listed in §3.1.1 plus carstamp fields
    from §10.3 (``base_ts``, ``acc_base_ts``) and the value-carstamp log part
    needed to order RMW-committed values against ABD-written values."""

    key: int
    value: int = 0
    base_ts: TS = TS_ZERO            # carstamp base of `value` (§10.3)
    val_log: int = 0                 # carstamp log-no of `value`
    state: KVState = KVState.INVALID
    log_no: int = 0                  # slot currently being worked on
    last_committed_log_no: int = 0
    proposed_ts: TS = TS_ZERO        # highest propose seen for `log_no`
    accepted_ts: TS = TS_ZERO        # TS of the accepted RMW (valid in ACCEPTED)
    accepted_value: int = 0          # result the accepted RMW wants to commit
    acc_base_ts: TS = TS_ZERO        # base-TS chosen by the accepted RMW (§10.3)
    rmw_id: RmwId = RMW_ID_NONE      # RMW being worked on in `log_no`
    last_committed_rmw_id: RmwId = RMW_ID_NONE

    @property
    def carstamp(self) -> Carstamp:
        return Carstamp(self.base_ts, self.val_log)

    def working_log(self) -> int:
        """The slot a fresh grab would work on (inv-1: previous committed)."""
        return self.last_committed_log_no + 1


# ---------------------------------------------------------------------------
# The Local-entry (§3.1.2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HelpEntry:
    """State of the h-RMW being helped (the `helping-local-entry`, §6)."""

    rmw_id: RmwId = RMW_ID_NONE
    value: int = 0
    base_ts: TS = TS_ZERO
    acc_ts: TS = TS_ZERO             # highest accepted-TS seen for h-RMW
    log_no: int = 0
    val_log: int = 0                 # carstamp log part for the commit msg


@dataclasses.dataclass
class Tally:
    """Reply bookkeeping for the broadcast identified by ``lid``.

    Replies are tracked per *source machine* (sets, not counters): the
    network can duplicate messages, and a duplicated reply must not be able
    to fake a quorum.  All other aggregation is max/once semantics, which is
    idempotent under duplication.
    """

    lid: int = 0
    expected: int = 0                # number of machines replies come from
    ackers: set = dataclasses.field(default_factory=set)
    repliers: set = dataclasses.field(default_factory=set)
    rmw_committed: bool = False
    rmw_committed_no_bcast: bool = False
    log_too_low: Optional[Reply] = None
    log_too_high: bool = False
    seen_higher: Optional[TS] = None     # max blocking proposed-TS observed
    lower_acc: Optional[Reply] = None    # Seen-lower-acc with max accepted-TS
    fresh_value: Optional[int] = None    # Ack-base-TS-stale payload (§10.3)
    fresh_cs: Carstamp = CS_ZERO

    @property
    def acks(self) -> int:
        return len(self.ackers)

    @property
    def total(self) -> int:
        return len(self.repliers)

    def reset(self, lid: int, expected: int) -> None:
        self.__init__(lid=lid, expected=expected)

    def note(self, rep: Reply) -> None:
        self.repliers.add(rep.src)
        if rep.opcode in (Rep.ACK, Rep.ACK_BASE_TS_STALE):
            self.ackers.add(rep.src)
            if rep.opcode == Rep.ACK_BASE_TS_STALE:
                cs = Carstamp(rep.base_ts, rep.val_log)
                if cs > self.fresh_cs:
                    self.fresh_cs, self.fresh_value = cs, rep.value
        elif rep.opcode == Rep.RMW_ID_COMMITTED:
            self.rmw_committed = True
        elif rep.opcode == Rep.RMW_ID_COMMITTED_NO_BCAST:
            self.rmw_committed = True
            self.rmw_committed_no_bcast = True
        elif rep.opcode == Rep.LOG_TOO_LOW:
            if (self.log_too_low is None
                    or rep.log_no > self.log_too_low.log_no):
                self.log_too_low = rep
        elif rep.opcode == Rep.LOG_TOO_HIGH:
            self.log_too_high = True
        elif rep.opcode in (Rep.SEEN_HIGHER_PROP, Rep.SEEN_HIGHER_ACC):
            if self.seen_higher is None or rep.ts > self.seen_higher:
                self.seen_higher = rep.ts
        elif rep.opcode == Rep.SEEN_LOWER_ACC:
            if self.lower_acc is None or rep.ts > self.lower_acc.ts:
                self.lower_acc = rep


@dataclasses.dataclass
class LocalEntry:
    """Thread-local RMW state for one session (§3.1.2)."""

    sess: int                         # machine-local session index
    gsess: int                        # global session id
    state: LEState = LEState.INVALID
    key: int = 0
    op: RmwOp = RmwOp.FAA
    arg1: int = 0
    arg2: int = 0
    rmw_id: RmwId = RMW_ID_NONE
    ts: TS = TS_ZERO                  # TS of the current propose/accept round
    log_no: int = 0
    base_ts: TS = TS_ZERO             # base chosen at local accept (§10)
    accepted_value: int = 0           # result computed at local accept
    accepted_log_no: int = 0          # slot of the most recent local accept
    value_to_read: int = 0            # pre-state observed at local accept
    # back-off (§5)
    back_off_counter: int = 0
    kv_snapshot: Tuple = ()
    # helping (§6)
    helping_flag: HelpFlag = HelpFlag.NOT_HELPING
    help: HelpEntry = dataclasses.field(default_factory=HelpEntry)
    # retry / §8.7 bookkeeping
    log_too_high_counter: int = 0
    retry_version: int = 0            # next propose version (>= 3 for CP)
    # livelock avoidance: exponential back-off with per-machine stagger.
    # A fixed back-off threshold smaller than a round latency lets two
    # machines steal from each other forever; growing the wait per
    # consecutive steal/retry guarantees eventual progress.
    retry_count: int = 0
    steal_count: int = 0
    wait: int = 0                     # inspections to skip before acting
    base_ts_looked_up: bool = False   # §10.3 optimization flag
    # all-aboard (§9)
    all_aboard: bool = False
    all_aboard_timeout_counter: int = 0
    # reply plumbing
    lid: int = 0
    tally: Tally = dataclasses.field(default_factory=Tally)
    all_acked: bool = False           # accept acked by ALL -> §8.6 thin commit
    # which record the in-flight commit broadcast refers to (own vs help):
    # must be pinned at broadcast time — re-deriving it at ack time from
    # le.help is wrong when a stale aborted-help record lingers there.
    commit_from_help: bool = False
    # liveness: retransmit if a round stalls
    round_age: int = 0
    tag: int = 0                      # opaque client tag for completions

    def active(self) -> bool:
        return self.state != LEState.INVALID
