"""Scalar <-> lane glue shared by the replay oracle and the live serve path.

Protocol-level, dependency-light helpers used by BOTH the differential
trace-replay harness (:mod:`repro_torch.core.replay`) and the batched serve
subsystem (:mod:`repro_torch.serve.paxos`): single definitions, so the oracle
and the serving machine can never drift apart — and the core package
never has to import the serve layer to get them.

* converters between scalar protocol objects (:class:`KVPair`,
  :class:`Msg`, :class:`Reply`) and struct-of-arrays engine lanes
  (:class:`~repro_torch.core.vector.KVTable` / ``MsgBatch`` / ``ReplyBatch``,
  :class:`~repro_torch.core.proposer_vector.IssuerReplyBatch`);
* the issuer round-lane loaders (round events -> ProposerTable lanes);
* :func:`bucket_conflict_free` — single-pass O(n) conflict-free batch
  packing with O(1) generation-stamped flush bookkeeping, the strict-order
  core the ingest scheduler builds on;
* :class:`ShardMap` — pure key→shard steering over a block-partitioned
  lane axis, the partition the multi-device plane layout is built on
  (conflict-free batches already guarantee at most one message per lane,
  so lanes — and therefore shards — are independent within a batch).
"""

from __future__ import annotations

import dataclasses

from typing import Dict, List, Optional, Sequence

import numpy as np

from . import proposer_vector, vector
from .proposer import (
    ACTION_PAYLOAD_KEYS, AbdPhase, AbdRound, Decision, RmwRound,
)
from .types import (
    KVPair, KVState, Msg, MsgKind, Rep, Reply, RmwId, TS,
)

# Receiver-side registry coupling (see repro_torch.core.vector docstring): commits
# register rmw-ids after the batch; proposes/accepts read registered-ness
# before it.
_COMMIT_KINDS = (MsgKind.COMMIT, MsgKind.READ_COMMIT)
_REG_READERS = (MsgKind.PROPOSE, MsgKind.ACCEPT)


class _ConflictState:
    """Generation-stamped conflict bookkeeping for the open batch.

    ``advance`` (a batch boundary) is O(1): entries of older generations are
    simply ignored, never cleared.
    """

    __slots__ = ("gen", "_key_gen", "_reg_gen")

    def __init__(self) -> None:
        self.gen = 0
        self._key_gen: Dict[object, int] = {}
        self._reg_gen: Dict[int, List[int]] = {}    # gsess -> [gen, max cnt]

    def advance(self) -> None:
        self.gen += 1

    def conflicts(self, key: object, msg: Optional[Msg]) -> bool:
        if self._key_gen.get(key) == self.gen:
            return True
        if (msg is not None and msg.kind in _REG_READERS
                and msg.rmw_id.gsess >= 0):
            reg = self._reg_gen.get(msg.rmw_id.gsess)
            if (reg is not None and reg[0] == self.gen
                    and reg[1] >= msg.rmw_id.counter):
                return True
        return False

    def admit(self, key: object, msg: Optional[Msg]) -> None:
        self._key_gen[key] = self.gen
        if (msg is not None and msg.kind in _COMMIT_KINDS
                and msg.rmw_id.gsess >= 0):
            reg = self._reg_gen.get(msg.rmw_id.gsess)
            if reg is None or reg[0] != self.gen:
                self._reg_gen[msg.rmw_id.gsess] = [self.gen,
                                                   msg.rmw_id.counter]
            elif msg.rmw_id.counter > reg[1]:
                reg[1] = msg.rmw_id.counter



# ---------------------------------------------------------------------------
# scalar <-> lane converters (shared with repro_torch.core.replay)
# ---------------------------------------------------------------------------

def kv_to_lanes(kv: KVPair) -> Dict[str, int]:
    """One KVPair -> one lane of every KVTable plane."""
    return dict(
        state=int(kv.state), log_no=kv.log_no,
        last_log=kv.last_committed_log_no,
        prop_v=kv.proposed_ts.version, prop_m=kv.proposed_ts.mid,
        acc_v=kv.accepted_ts.version, acc_m=kv.accepted_ts.mid,
        acc_val=kv.accepted_value,
        acc_base_v=kv.acc_base_ts.version, acc_base_m=kv.acc_base_ts.mid,
        rmw_cnt=kv.rmw_id.counter, rmw_sess=kv.rmw_id.gsess,
        value=kv.value, base_v=kv.base_ts.version, base_m=kv.base_ts.mid,
        val_log=kv.val_log,
        last_rmw_cnt=kv.last_committed_rmw_id.counter,
        last_rmw_sess=kv.last_committed_rmw_id.gsess,
    )


def lanes_to_kv(planes: Dict[str, np.ndarray], key: int) -> KVPair:
    """One lane of every KVTable plane -> a scalar KVPair view."""
    g = lambda f: int(planes[f][key])
    return KVPair(
        key=key, value=g("value"),
        base_ts=TS(g("base_v"), g("base_m")), val_log=g("val_log"),
        state=KVState(g("state")), log_no=g("log_no"),
        last_committed_log_no=g("last_log"),
        proposed_ts=TS(g("prop_v"), g("prop_m")),
        accepted_ts=TS(g("acc_v"), g("acc_m")),
        accepted_value=g("acc_val"),
        acc_base_ts=TS(g("acc_base_v"), g("acc_base_m")),
        rmw_id=RmwId(g("rmw_cnt"), g("rmw_sess")),
        last_committed_rmw_id=RmwId(g("last_rmw_cnt"), g("last_rmw_sess")),
    )


def msg_to_lanes(msg: Msg) -> Dict[str, int]:
    """One wire message -> one lane of every MsgBatch plane."""
    return dict(
        kind=vector.VEC_KIND[msg.kind],
        ts_v=msg.ts.version, ts_m=msg.ts.mid, log_no=msg.log_no,
        rmw_cnt=msg.rmw_id.counter, rmw_sess=msg.rmw_id.gsess,
        value=msg.value if msg.value is not None else 0,
        base_v=msg.base_ts.version, base_m=msg.base_ts.mid,
        val_log=msg.val_log,
        has_value=0 if msg.value is None else 1,
    )


def reply_to_lanes(rep: Reply) -> Dict[str, int]:
    """One steered reply -> one lane of every IssuerReplyBatch plane."""
    return dict(
        kind=int(rep.kind), opcode=int(rep.opcode), src=rep.src, lid=rep.lid,
        ts_v=rep.ts.version, ts_m=rep.ts.mid, log_no=rep.log_no,
        rmw_cnt=rep.rmw_id.counter, rmw_sess=rep.rmw_id.gsess,
        value=0 if rep.value is None else rep.value,
        base_v=rep.base_ts.version, base_m=rep.base_ts.mid,
        val_log=rep.val_log,
    )


# Reply payload groups: which ReplyBatch lanes a given opcode pins down
# (mirrors the scalar handlers' wire format field-for-field).
TS_OPS = (Rep.SEEN_HIGHER_PROP, Rep.SEEN_HIGHER_ACC, Rep.SEEN_LOWER_ACC)
VALUE_OPS = (Rep.LOG_TOO_LOW, Rep.SEEN_LOWER_ACC, Rep.ACK_BASE_TS_STALE,
             Rep.CARSTAMP_TOO_LOW)
RMW_OPS = (Rep.LOG_TOO_LOW, Rep.SEEN_LOWER_ACC, Rep.CARSTAMP_TOO_LOW)
LOG_OPS = (Rep.LOG_TOO_LOW, Rep.CARSTAMP_TOO_LOW)


def reply_from_lanes(rep_np: Dict[str, np.ndarray], msg: Msg,
                     src: int) -> Reply:
    """One receiver-engine reply lane -> the scalar wire Reply.

    Sets exactly the fields the scalar handlers set for that opcode, leaving
    everything else at the Reply defaults — byte-for-byte what
    ``handlers.apply_msg`` would have returned (the differential replay
    asserts this correspondence lane-for-lane).
    """
    i = msg.key
    kind = MsgKind(int(rep_np["kind"][i]))
    opcode = Rep(int(rep_np["opcode"][i]))
    rep = Reply(kind, src, opcode, msg.lid, key=msg.key)
    if opcode in TS_OPS:
        rep.ts = TS(int(rep_np["ts_v"][i]), int(rep_np["ts_m"][i]))
    if opcode in LOG_OPS:
        rep.log_no = int(rep_np["log_no"][i])
    if opcode in RMW_OPS:
        rep.rmw_id = RmwId(int(rep_np["rmw_cnt"][i]),
                           int(rep_np["rmw_sess"][i]))
    if opcode in VALUE_OPS:
        rep.value = int(rep_np["value"][i])
        rep.base_ts = TS(int(rep_np["base_v"][i]), int(rep_np["base_m"][i]))
        rep.val_log = int(rep_np["val_log"][i])
    if kind == MsgKind.WRITE_QUERY_REPLY:
        rep.base_ts = TS(int(rep_np["base_v"][i]), int(rep_np["base_m"][i]))
    return rep


# ---------------------------------------------------------------------------
# Issuer round-lane loaders (shared with repro_torch.core.replay)
# ---------------------------------------------------------------------------

TALLY_PLANES = (
    "rep_bits", "ack_bits", "rmw_flag", "rmw_nb_flag", "lth_flag",
    "sh_has", "sh_v", "sh_m",
    "ltl_has", "ltl_log", "ltl_cnt", "ltl_sess", "ltl_val",
    "ltl_base_v", "ltl_base_m", "ltl_vlog",
    "la_has", "la_ts_v", "la_ts_m", "la_cnt", "la_sess", "la_val",
    "la_base_v", "la_base_m", "la_vlog",
    "fr_has", "fr_val", "fr_base_v", "fr_base_m", "fr_log",
)

ABD_PLANES = (
    "abd_phase", "abd_lid", "abd_key", "abd_value",
    "abd_rep_bits", "abd_ack_bits", "abd_store_bits",
    "abd_maxb_v", "abd_maxb_m",
    "abd_sent_base_v", "abd_sent_base_m", "abd_sent_vlog",
    "best_base_v", "best_base_m", "best_vlog",
    "best_val", "best_log", "best_cnt", "best_sess",
)


def load_rmw_round(lanes: Dict[str, np.ndarray], ev: RmwRound) -> None:
    """Reload session lane ``ev.sess`` from an RMW round start: round
    identity planes from the event, tally planes back to fresh defaults."""
    i = ev.sess
    lanes["phase"][i] = int(ev.phase)
    lanes["lid"][i] = ev.lid
    lanes["aboard"][i], lanes["helping"][i] = ev.aboard, ev.helping
    lanes["lth_counter"][i] = ev.lth_counter
    lanes["key"][i] = ev.key
    lanes["ts_v"][i], lanes["ts_m"][i] = ev.ts.version, ev.ts.mid
    lanes["log_no"][i] = ev.log_no
    lanes["rmw_cnt"][i] = ev.rmw_id.counter
    lanes["rmw_sess"][i] = ev.rmw_id.gsess
    lanes["value"][i], lanes["has_value"][i] = ev.value, ev.has_value
    lanes["base_v"][i], lanes["base_m"][i] = (ev.base_ts.version,
                                              ev.base_ts.mid)
    lanes["val_log"][i] = ev.val_log
    for f in TALLY_PLANES:
        lanes[f][i] = proposer_vector.TABLE_DEFAULTS[f]


def load_abd_round(lanes: Dict[str, np.ndarray], ev: AbdRound) -> None:
    """Reload session lane ``ev.sess`` from an ABD phase start (§10–§11)."""
    i = ev.sess
    for f in ABD_PLANES:
        lanes[f][i] = proposer_vector.TABLE_DEFAULTS[f]
    lanes["abd_phase"][i] = int(ev.phase)
    lanes["abd_lid"][i], lanes["abd_key"][i] = ev.lid, ev.key
    lanes["abd_value"][i] = ev.value
    lanes["abd_rep_bits"][i] = ev.rep_bits
    lanes["abd_store_bits"][i] = ev.store_bits
    if ev.phase in (AbdPhase.W_QUERY, AbdPhase.W_WRITE):
        lanes["abd_maxb_v"][i] = ev.base_ts.version
        lanes["abd_maxb_m"][i] = ev.base_ts.mid
    else:
        lanes["best_base_v"][i] = ev.base_ts.version
        lanes["best_base_m"][i] = ev.base_ts.mid
        lanes["best_vlog"][i] = ev.val_log
        lanes["best_val"][i] = ev.value
        lanes["best_log"][i] = ev.log_no
        lanes["best_cnt"][i] = ev.rmw_id.counter
        lanes["best_sess"][i] = ev.rmw_id.gsess
        lanes["abd_sent_base_v"][i] = ev.sent_base_ts.version
        lanes["abd_sent_base_m"][i] = ev.sent_base_ts.mid
        lanes["abd_sent_vlog"][i] = ev.sent_val_log


def action_payload(act: Dict[str, np.ndarray], lane: int,
                   decision: Decision) -> Optional[Dict[str, int]]:
    """The decision payload an ActionBatch lane pins down (None when the
    decision carries none) — same dict shape the scalar machine traces."""
    keys = ACTION_PAYLOAD_KEYS.get(decision)
    if keys is None:
        return None
    return {k: int(act[k][lane]) for k in keys}


def log_too_low_reply(act: Dict[str, np.ndarray], lane: int) -> Reply:
    """ActionBatch LOG_TOO_LOW lanes -> the payload Reply the scalar
    ``Machine._apply_log_too_low`` consumes (§8.2)."""
    return Reply(MsgKind.PROP_REPLY, -1, Rep.LOG_TOO_LOW, 0,
                 log_no=int(act["log_no"][lane]),
                 rmw_id=RmwId(int(act["rmw_cnt"][lane]),
                              int(act["rmw_sess"][lane])),
                 value=int(act["value"][lane]),
                 base_ts=TS(int(act["base_v"][lane]),
                            int(act["base_m"][lane])),
                 val_log=int(act["val_log"][lane]))


def lower_acc_reply(act: Dict[str, np.ndarray], lane: int) -> Reply:
    """ActionBatch HELP/HELP_SELF lanes -> the max-accepted-TS
    Seen-lower-acc payload Reply ``Machine._begin_help`` consumes (§6)."""
    return Reply(MsgKind.PROP_REPLY, -1, Rep.SEEN_LOWER_ACC, 0,
                 ts=TS(int(act["ts_v"][lane]), int(act["ts_m"][lane])),
                 rmw_id=RmwId(int(act["rmw_cnt"][lane]),
                              int(act["rmw_sess"][lane])),
                 value=int(act["value"][lane]),
                 base_ts=TS(int(act["base_v"][lane]),
                            int(act["base_m"][lane])),
                 val_log=int(act["val_log"][lane]))


def bucket_conflict_free(trace: Sequence[Msg],
                         batch_target: Optional[int] = None
                         ) -> List[List[Msg]]:
    """Pack a per-machine message trace into conflict-free batches.

    Single-pass O(n) with O(1) flush bookkeeping (generation stamps), shared
    between the differential replay harness (:mod:`repro_torch.core.replay`) and
    the live ingest path (:class:`IngestScheduler` strict mode): a batch
    boundary opens when the next message's key already has a message in the
    open batch, or when the next message is a PROPOSE/ACCEPT whose rmw-id a
    commit earlier in the open batch just registered.
    """
    batches: List[List[Msg]] = []
    cur: List[Msg] = []
    state = _ConflictState()
    for msg in trace:
        full = batch_target is not None and len(cur) >= batch_target
        if cur and (full or state.conflicts(msg.key, msg)):
            batches.append(cur)
            cur = []
            state.advance()
        cur.append(msg)
        state.admit(msg.key, msg)
    if cur:
        batches.append(cur)
    return batches


# ---------------------------------------------------------------------------
# key -> shard steering (the multi-device plane partition)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardMap:
    """Pure key→shard steering over a block-partitioned lane axis.

    The lane axis of a plane stack (``K`` keys or ``S`` sessions) is split
    into ``n_shards`` contiguous blocks of ``lanes_per_shard`` lanes each;
    shard ``s`` owns lanes ``[s·lps, (s+1)·lps)``.  Contiguous blocks are
    exactly how a JAX ``NamedSharding`` partitions an axis over a mesh
    axis, so "the shard a key steers to" and "the device its lane lives
    on" are the same thing by construction.

    Pure and layout-derived: the map is a value, recomputed whenever the
    lane axis grows (growth keeps the lane count a multiple of
    ``n_shards``, so blocks stay aligned).  Conflict-free batches admit at
    most one message per lane, so a batch split shard-by-shard
    (:meth:`split`) yields sub-batches that touch disjoint plane blocks —
    the property that makes shards independent within a wave.
    """

    n_shards: int
    n_lanes: int

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.n_lanes < self.n_shards:
            raise ValueError(
                f"{self.n_lanes} lanes cannot cover {self.n_shards} shards")
        if self.n_lanes % self.n_shards:
            raise ValueError(
                f"lane axis {self.n_lanes} not divisible into "
                f"{self.n_shards} aligned shard blocks")

    @property
    def lanes_per_shard(self) -> int:
        return self.n_lanes // self.n_shards

    def shard_of(self, key: int) -> int:
        """The shard whose plane block holds ``key``'s lane."""
        if not 0 <= key < self.n_lanes:
            raise ValueError(
                f"key {key} outside the sharded lane axis "
                f"[0, {self.n_lanes})")
        return key // self.lanes_per_shard

    def local_of(self, key: int) -> int:
        """``key``'s lane offset within its shard's block."""
        return key - self.shard_of(key) * self.lanes_per_shard

    def slice_of(self, shard: int) -> slice:
        """The contiguous lane slice owned by ``shard``."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"no shard {shard} in a {self.n_shards}-way map")
        lps = self.lanes_per_shard
        return slice(shard * lps, (shard + 1) * lps)

    def grown(self, n_lanes: int) -> "ShardMap":
        """The map for a grown lane axis (same shard count)."""
        return ShardMap(self.n_shards, n_lanes)

    def aligned(self, n_lanes: int) -> int:
        """Round a lane count up to the next shard-aligned size."""
        n = self.n_shards
        return ((max(n_lanes, n) + n - 1) // n) * n

    def split(self, items: Sequence, key_of=None) -> List[List]:
        """Partition a batch into per-shard sub-batches in one pass.

        Order is preserved within each shard.  ``key_of`` extracts the
        steering key (defaults to ``item.key`` — wire messages).
        """
        if key_of is None:
            key_of = lambda item: item.key
        out: List[List] = [[] for _ in range(self.n_shards)]
        lps = self.lanes_per_shard
        n = self.n_lanes
        for item in items:
            key = key_of(item)
            if not 0 <= key < n:
                raise ValueError(
                    f"key {key} outside the sharded lane axis [0, {n})")
            out[key // lps].append(item)
        return out
