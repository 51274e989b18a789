"""Differential trace replay: sim schedules become tests of the kernels.

Port of ``repro.core.replay``.  The discrete-event simulator
(:mod:`repro_torch.core.sim`) generates adversarial schedules — drops,
duplicates, reordering, heavy tails, crashes — and every machine can tap
BOTH halves of what it processed:

* the **receiver** message stream (``Machine.msg_trace``, enabled by
  ``Cluster.enable_msg_trace``), replayed here through the scalar handlers
  (:func:`repro_torch.core.handlers.apply_msg`) AND the receiver engine
  (:func:`repro_torch.kernels.paxos_apply.ops.replica_step` per machine,
  :func:`~repro_torch.kernels.paxos_apply.ops.paxos_apply` over the stacked
  machines), asserting reply- and plane-for-plane state equality after
  every conflict-free batch;
* the **issuer** event stream (``Machine.issuer_trace``, enabled by
  ``Cluster.enable_issuer_trace``): round starts, steered replies,
  decisions and pauses (see :mod:`repro_torch.core.proposer`), replayed
  through a scalar shadow built from the same pure transitions the live
  Machine dispatches on AND the issuer engine
  (:func:`repro_torch.kernels.paxos_propose.ops.issuer_step`, the
  whole-stack ``paxos_propose``), asserting decisions, emission payloads
  and every :class:`ProposerTable` plane.

Any schedule the simulator can produce is thereby a correctness test of
both engines.

**Device.**  Every replay takes ``device=None``, which means ``"cuda"``
(:func:`repro_torch.device.resolve_device`), where the reference takes
``use_kernel``/``interpret``/``block_rows``.  On a CUDA device the engine
steps launch the CUDA kernels; ``device="cpu"`` runs their plain versions.
There is no switch and no fallback: a failed build or launch raises.

**Full width.**  The checks are the reference's, at the same moments and
over the same lanes; what changes is how the port reaches 2^20 key lanes
a machine:

* the message planes live on the device as one resident NOOP stack; a
  batch or wave writes its staged lanes from one packed host buffer
  ``(2 + 12, L)`` (machine row, key lane, the 11 message planes,
  ``is_registered``) with one indexed write, the kernel runs over the whole
  stack (untouched lanes go through it as NOOPs), only the staged lanes'
  replies and register mask come back (one gather, one copy), and those
  lanes are reset to NOOP;
* the final KV compare builds the expected planes on the device (the
  fresh lane broadcast, overwritten at the keys the scalar shadows
  touched) and compares them with ``torch.equal``; a mismatch names the
  first differing (machine, key) in the reference's order;
* registries, the fused side's mirrors and the per-shard journals are
  numpy int64 arrays of ``num_gsess`` compared with ``np.array_equal``;
  a mismatch names the first differing global session and both values;
* the issuer shadows' expected planes are a ``(65, n_sess)`` array whose
  columns are recomputed only for the sessions an event or batch touched.

**Sharding.**  :func:`replay_sharded` keeps the shard-aligned lane axis,
the per-shard registration journals and their re-merge check.  The CUDA
kernel masks the ragged end of its lane axis itself and has no padding
contract, so the reference's shard-local kernel segments
(``pad_segments``/``unpad_segments``) have no counterpart: one call spans
every shard, as in the port's sharded engine.

**Receiver bucketing contract** (see ``core/vector.py``): per batch, at
most one message per key (lane ``i`` == key ``i``); per-key message order
preserved across batches; and a batch is flushed early when a
PROPOSE/ACCEPT's rmw-id was registered by a commit lane earlier in the
*same* batch — registrations scatter after the batch, so the scalar side
(which registers immediately) would otherwise observe a fresher registry
than the gather.

**Issuer bucketing contract**: per batch, at most one reply per session
(lane ``i`` == session ``i``); per-session order preserved; round/pause
events flush any pending reply for their session before applying (they
reload the lane — they are inputs, exactly like messages are inputs to
the receiver replay).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.paxos_apply.ops import (
    N_KV, N_MSG, N_MSGREG, N_REP, paxos_apply, replica_step,
)
from repro_torch.kernels.paxos_propose.ops import N_TAB, issuer_step

from . import handlers, proposer, proposer_vector
from .handlers import Registry, get_kv
from .proposer import (
    ABD_PAUSED, ACTION_PAYLOAD_KEYS, AbdEntry, AbdPhase, AbdRound,
    BCAST_KINDS, Decision, DecisionEvent, PauseEvent, Phase, ReplyEvent,
    RmwRound,
)
from .sim import Cluster, NetConfig, workload
from .node import ProtocolConfig
from .types import (
    Carstamp, KVPair, Msg, MsgKind, Reply, RmwId, RmwOp, Tally,
)
from .vector import KVTable, MsgBatch, ReplyBatch

# The scalar<->lane converters, issuer round-lane loaders and the
# conflict-free bucketer live in repro_torch.core.lanes, shared with the
# live batched serve path (repro_torch.serve.paxos) — single definitions,
# so the replay oracle and the serving machine can never drift apart.
from .lanes import (
    LOG_OPS as _LOG_OPS, RMW_OPS as _RMW_OPS, TS_OPS as _TS_OPS,
    VALUE_OPS as _VALUE_OPS, ShardMap, bucket_conflict_free, kv_to_lanes,
    load_abd_round as _load_abd_round_lanes,
    load_rmw_round as _load_rmw_round_lanes, msg_to_lanes, reply_to_lanes,
)

__all__ = [
    "ReplayMismatch", "bucket_conflict_free", "kv_to_lanes", "msg_to_lanes",
    "reply_to_lanes", "replay_trace", "replay_cluster",
    "replay_cluster_fused", "replay_sharded", "run_and_replay",
    "run_and_replay_fused", "run_and_replay_sharded",
    "replay_issuer_trace", "replay_issuer_cluster", "run_and_replay_issuer",
]

_KV_FIELDS = KVTable._fields
_MSG_FIELDS = MsgBatch._fields
_REP_FIELDS = ReplyBatch._fields
_REP_INDEX = {f: i for i, f in enumerate(_REP_FIELDS)}

_FUSED_NOOP = {f: 0 for f in _MSG_FIELDS}
_FUSED_NOOP["has_value"] = 1                    # matches MsgBatch.noop
# one NOOP lane of the (12, n) message + is_registered stack
_NOOP_LANE = np.array([_FUSED_NOOP[f] for f in _MSG_FIELDS] + [0], np.int32)


class ReplayMismatch(AssertionError):
    """The SIMD engine diverged from the scalar handlers on a trace."""


def _msg_lane(msg: Msg) -> List[int]:
    lane = msg_to_lanes(msg)
    return [lane[f] for f in _MSG_FIELDS]


def batch_to_msgbatch(batch: Sequence[Msg], n_keys: int,
                      device: DeviceLike = None) -> MsgBatch:
    """Conflict-free batch -> struct-of-arrays MsgBatch (NOOP elsewhere),
    int32 tensors on ``device``."""
    planes = np.repeat(_NOOP_LANE[:N_MSG, None], n_keys, axis=1)
    for msg in batch:
        planes[:, msg.key] = _msg_lane(msg)
    return MsgBatch(*torch.from_numpy(planes).to(
        resolve_device(device)).unbind(0))


# ---------------------------------------------------------------------------
# reply comparison (fields meaningful per opcode, mirroring the wire format;
# opcode groups shared with repro_torch.serve.paxos.bridge.reply_from_lanes)
# ---------------------------------------------------------------------------

def _expected_reply_lanes(rep) -> Dict[str, int]:
    """The ReplyBatch lanes a scalar Reply pins down (others are free)."""
    want = {"kind": int(rep.kind), "opcode": int(rep.opcode)}
    if rep.opcode in _TS_OPS:
        want["ts_v"], want["ts_m"] = rep.ts.version, rep.ts.mid
    if rep.opcode in _LOG_OPS:
        want["log_no"] = rep.log_no
    if rep.opcode in _RMW_OPS:
        want["rmw_cnt"] = rep.rmw_id.counter
        want["rmw_sess"] = rep.rmw_id.gsess
    if rep.opcode in _VALUE_OPS:
        want["value"] = rep.value
        want["base_v"], want["base_m"] = rep.base_ts.version, rep.base_ts.mid
        want["val_log"] = rep.val_log
    if rep.kind == MsgKind.WRITE_QUERY_REPLY:
        want["base_v"], want["base_m"] = rep.base_ts.version, rep.base_ts.mid
    return want


def _got_reply_lanes(got: np.ndarray, j: int, want: Dict[str, int]
                     ) -> Dict[str, int]:
    """Staged lane ``j`` of a downloaded ``(12, L)`` reply + mask block, at
    the fields ``want`` pins down."""
    return {f: int(got[_REP_INDEX[f], j]) for f in want}


# ---------------------------------------------------------------------------
# the device side: staged message lanes, registries, the final KV compare
# ---------------------------------------------------------------------------

class _StagedLanes:
    """The resident ``(12, M * K)`` message + ``is_registered`` stack,
    NOOP on every lane between waves.  A wave's lanes arrive as one packed
    host buffer ``(2 + 12, L)``: machine row, key lane, the 11 message
    planes, ``is_registered``."""

    def __init__(self, m: int, k: int, dev: torch.device):
        self.k = k
        self.noop = torch.from_numpy(_NOOP_LANE).to(dev)[:, None]
        self.planes = self.noop.expand(N_MSGREG, m * k).contiguous()

    def put(self, host: np.ndarray) -> torch.Tensor:
        """Upload ``host`` (one copy), write its lanes (one indexed write)
        and return their flat lane indices on the device."""
        buf = torch.from_numpy(host).to(self.planes.device)
        idx = buf[0].long() * self.k + buf[1].long()
        self.planes[:, idx] = buf[2:]
        return idx

    def clear(self, idx: torch.Tensor) -> None:
        self.planes[:, idx] = self.noop


def _pack(cols: List[List[int]]) -> np.ndarray:
    """Staged lane columns -> the packed ``(rows, L)`` int32 host buffer."""
    return np.ascontiguousarray(np.array(cols, np.int32).reshape(
        len(cols), -1).T)


class _ArrayRegistry(Registry):
    """:class:`handlers.Registry` over a numpy int64 row: the scalar
    shadows' registry, with the same ``is_registered``/``register``, held
    where ``np.array_equal`` can compare it."""

    def __init__(self, committed: np.ndarray):
        self.committed = committed


def _first_reg_diff(got: np.ndarray, want: np.ndarray
                    ) -> Optional[Tuple[int, int]]:
    """The first ``(row, global session)`` where two ``(M, num_gsess)``
    registries differ, row-major; ``None`` when equal."""
    if np.array_equal(got, want):
        return None
    row, gs = np.argwhere(got != want)[0]
    return int(row), int(gs)


def _fresh_stack(n: int, dev: torch.device) -> torch.Tensor:
    """``(18, n)`` KV planes of ``n`` fresh lanes (``KVPair()`` defaults)."""
    return torch.stack(KVTable.fresh(n, dev))


def _expected_kv(kvs: Sequence[Dict[int, KVPair]], k: int,
                 dev: torch.device) -> torch.Tensor:
    """The ``(18, M * K)`` planes the scalar shadows stand for: every lane
    ``kv_to_lanes(KVPair())``, overwritten at the keys a shadow touched
    (one packed upload, one indexed write)."""
    default = kv_to_lanes(KVPair(key=0))
    fresh = torch.tensor([default[f] for f in _KV_FIELDS], dtype=torch.int32,
                         device=dev)
    expected = fresh[:, None].expand(N_KV, len(kvs) * k).contiguous()
    cols = []
    for row, shadow in enumerate(kvs):
        for key, kv in shadow.items():
            lanes = kv_to_lanes(kv)
            cols.append([row, key] + [lanes[f] for f in _KV_FIELDS])
    if cols:
        buf = torch.from_numpy(_pack(cols)).to(dev)
        expected[:, buf[0].long() * k + buf[1].long()] = buf[2:]
    return expected


def _first_kv_diff(kv: torch.Tensor, kvs: Sequence[Dict[int, KVPair]],
                   k: int):
    """Hold ``kv (18, M * K)`` against the scalar shadows plane for plane.
    ``None`` when equal; else the first differing ``(row, key, diff)`` in
    row-major, key-ascending order, ``diff`` = ``{field: (scalar,
    engine)}``."""
    expected = _expected_kv(kvs, k, kv.device)
    if torch.equal(kv, expected):
        return None
    lane = int((kv != expected).any(0).nonzero()[0, 0])
    row, key = divmod(lane, k)
    want = kv_to_lanes(kvs[row].get(key) or KVPair(key=key))
    got = dict(zip(_KV_FIELDS, kv[:, lane].tolist()))
    return row, key, {f: (want[f], got[f]) for f in want
                      if want[f] != got[f]}


# ---------------------------------------------------------------------------
# the differential replay itself
# ---------------------------------------------------------------------------

def replay_trace(trace: Sequence[Msg], *, n_keys: int, num_gsess: int,
                 device: DeviceLike = None) -> Dict[str, int]:
    """Replay one machine's message trace through both implementations.

    Returns replay stats; raises :class:`ReplayMismatch` on the first
    divergence (reply stream, final KV planes, or registry).
    """
    dev = resolve_device(device)
    kvs: Dict[int, KVPair] = {}
    scalar_reg = np.zeros((num_gsess,), np.int64)
    registry = _ArrayRegistry(scalar_reg)
    table = KVTable(*_fresh_stack(n_keys, dev).unbind(0))
    registered = torch.zeros((num_gsess,), dtype=torch.int32, device=dev)
    stage = _StagedLanes(1, n_keys, dev)
    msgb = MsgBatch(*stage.planes[:N_MSG].unbind(0))

    batches = bucket_conflict_free(trace)
    kind_counts: Dict[str, int] = {}
    for step, batch in enumerate(batches):
        scalar_reps = []
        for msg in batch:
            if msg.key >= n_keys:
                raise ValueError(f"trace touches key {msg.key} >= n_keys "
                                 f"{n_keys}")
            rep = handlers.apply_msg(get_kv(kvs, msg.key), msg, registry)
            scalar_reps.append(rep)
            k = msg.kind.name.lower()
            kind_counts[k] = kind_counts.get(k, 0) + 1
        # replica_step gathers is_registered itself: that row stays 0
        idx = stage.put(_pack([[0, msg.key] + _msg_lane(msg) + [0]
                               for msg in batch]))
        table, replies, registered = replica_step(table, msgb, registered)
        got = torch.stack(replies)[:, idx].cpu().numpy()
        stage.clear(idx)
        for j, (msg, rep) in enumerate(zip(batch, scalar_reps)):
            want = _expected_reply_lanes(rep)
            got_j = _got_reply_lanes(got, j, want)
            if got_j != want:
                raise ReplayMismatch(
                    f"reply diverged at batch {step}, key {msg.key}, "
                    f"msg {msg}:\n scalar: {want}\n vector: {got_j}")

    # final state: every lane, plane for plane
    bad = _first_kv_diff(torch.stack(table), [kvs], n_keys)
    if bad is not None:
        _, key, diff = bad
        raise ReplayMismatch(
            f"final KV state diverged at key {key} "
            f"(field: (scalar, vector)): {diff}")
    got_reg = registered.cpu().numpy()
    bad = _first_reg_diff(got_reg[None], scalar_reg[None])
    if bad is not None:
        gs = bad[1]
        raise ReplayMismatch(
            f"registry diverged at global session {gs}: scalar "
            f"{scalar_reg[gs]}, vector {got_reg[gs]}")

    stats = {"messages": len(trace), "batches": len(batches)}
    stats.update(kind_counts)
    return stats


def _trace_of(cluster: Cluster, mid: int) -> List[Msg]:
    trace = cluster.machines[mid].msg_trace
    if trace is None:
        raise ValueError(
            f"machine {mid} has no msg_trace — call "
            f"cluster.enable_msg_trace() before running the workload")
    return trace


def replay_cluster(cluster: Cluster, *, n_keys: int,
                   device: DeviceLike = None,
                   machines: Optional[Sequence[int]] = None
                   ) -> Dict[str, int]:
    """Replay every (or selected) machine's trace; aggregate the stats."""
    total: Dict[str, int] = {"machines": 0}
    mids = machines if machines is not None else range(len(cluster.machines))
    for mid in mids:
        stats = replay_trace(_trace_of(cluster, mid), n_keys=n_keys,
                             num_gsess=cluster.cfg.num_gsess, device=device)
        total["machines"] += 1
        for k, v in stats.items():
            total[k] = total.get(k, 0) + v
    return total


def _faulty_net(seed: int) -> NetConfig:
    return NetConfig(seed=seed, drop_prob=0.06, dup_prob=0.05,
                     heavy_tail_prob=0.03, heavy_tail_extra=25.0)


def run_and_replay(seed: int, *, n_ops: int = 24, keys: int = 3,
                   cfg: Optional[ProtocolConfig] = None,
                   net: Optional[NetConfig] = None,
                   rmw_frac: float = 0.45, write_frac: float = 0.3,
                   all_aboard: bool = False,
                   device: DeviceLike = None) -> Dict[str, int]:
    """End-to-end harness: seeded faulty sim run -> differential replay.

    Defaults exercise the full vocabulary (mixed RMW/write/read) under an
    adversarial network (drops, dups, heavy tails) and replay **every**
    machine's trace through the receiver engine on ``device``.
    ``all_aboard=True`` deploys the §9 fast path, putting the all-aboard
    epoch-conflict lane into the replayed schedules.
    """
    if cfg is None:
        cfg = ProtocolConfig(n_machines=5, sessions_per_machine=2,
                             all_aboard=all_aboard)
    elif all_aboard and not cfg.all_aboard:
        # don't silently drop the §9 deployment request on an explicit cfg
        cfg = dataclasses.replace(cfg, all_aboard=True)
    cluster = Cluster(cfg, net or _faulty_net(seed))
    cluster.enable_msg_trace()
    workload(cluster, n_ops=n_ops, keys=keys, seed=seed,
             rmw_frac=rmw_frac, write_frac=write_frac, op=RmwOp.FAA)
    if not cluster.run_until_quiet(max_ticks=120_000):
        raise RuntimeError(f"sim (seed {seed}) did not quiesce")
    stats = replay_cluster(cluster, n_keys=keys, device=device)
    stats["history"] = len(cluster.history)
    return stats


# ===========================================================================
# Fused (stacked-machine) replay: cluster ticks, plane-for-plane
# ===========================================================================
#
# The device-resident ClusterEngine (repro_torch.serve.paxos.cluster_engine)
# stacks all N replicas' KV planes on a leading machine axis and runs ONE
# fused receiver call per wave by flattening ``(M, K) -> (M*K,)`` lanes.
# This replay drives the SAME flattening convention straight from recorded
# message traces — machine ``i``'s batch ``w`` staged into row ``i`` of
# wave ``w`` — and asserts, against N independent scalar-handler shadows,
# that rows stay isolated: every reply, every KV plane of every row, and
# every per-machine registry mirror are bit-identical after every fused
# wave.  The registry gather stays host-side exactly as the engine does it
# (the one cross-lane piece of the step): ``is_registered`` is computed
# per staged lane against the machine's own mirror before the wave, and
# commit-lane registrations max-merge back after it (out-of-range gsess
# dropped, mirroring ops.scatter_register's dead-slot drop).
#
# Wave alignment across machines is arbitrary (machines with shorter
# traces simply stop contributing rows) — apply_batch is elementwise, so
# this checks precisely the row-isolation property the fused engine's
# correctness argument rests on, with no serve-layer code imported.

def _fused_wave_step(stage: _StagedLanes, kv: torch.Tensor,
                     kv_out: torch.Tensor, repmask: torch.Tensor,
                     host: np.ndarray) -> np.ndarray:
    """One fused receiver wave over the ``(18, M * K)`` stack ``kv`` into
    ``kv_out``: stage ``host``'s lanes, one ``paxos_apply`` over every
    lane, and return the staged lanes' ``(11 + 1, L)`` replies and
    register mask; the staged lanes are NOOP again afterwards."""
    idx = stage.put(host)
    paxos_apply(kv, stage.planes, out=(kv_out, repmask[:N_REP],
                                       repmask[N_REP]))
    got = repmask[:, idx].cpu().numpy()
    stage.clear(idx)
    return got


def _replay_stacked(cluster: Cluster, n_keys: int, shards: Optional[int],
                    device: DeviceLike,
                    machines: Optional[Sequence[int]]) -> Dict[str, int]:
    """The fused replay (``shards=None``) and the sharded one: the same
    waves over one ``(18, M * K)`` stack; the sharded replay aligns ``K``
    to ``shards`` blocks, journals registrations per shard and names the
    shard in its mismatches."""
    dev = resolve_device(device)
    mids = list(machines if machines is not None
                else range(len(cluster.machines)))
    num_gsess = cluster.cfg.num_gsess
    batches: List[List[List[Msg]]] = []
    total_msgs = 0
    for mid in mids:
        trace = _trace_of(cluster, mid)
        for msg in trace:
            if msg.key >= n_keys:
                raise ValueError(f"trace touches key {msg.key} >= n_keys "
                                 f"{n_keys}")
        total_msgs += len(trace)
        batches.append(bucket_conflict_free(trace))

    m = len(mids)
    what = "fused" if shards is None else "sharded"
    k = n_keys if shards is None else ShardMap(shards, shards).aligned(n_keys)
    sm = None if shards is None else ShardMap(shards, k)
    where_key = ((lambda key: f"key {key}") if sm is None else
                 (lambda key: f"shard {sm.shard_of(key)}, key {key}"))
    # scalar shadows (one per row) + the fused side's host registry mirror
    # (sharded: the machine-global registry every shard gathers from, plus
    # one registration journal per shard row, the bridge's reg_mirror
    # analogue)
    kvs: List[Dict[int, KVPair]] = [{} for _ in mids]
    scalar_reg = np.zeros((m, num_gsess), np.int64)
    regs = [_ArrayRegistry(scalar_reg[row]) for row in range(m)]
    freg = np.zeros((m, num_gsess), np.int64)
    journals = (None if sm is None
                else np.zeros((m, shards, num_gsess), np.int64))
    stage = _StagedLanes(m, k, dev)
    kv = _fresh_stack(m * k, dev)
    kv_next = torch.empty_like(kv)
    repmask = torch.empty((N_REP + 1, m * k), dtype=torch.int32, device=dev)
    i_sess, i_cnt = 2 + _MSG_FIELDS.index("rmw_sess"), \
        2 + _MSG_FIELDS.index("rmw_cnt")

    n_waves = max((len(b) for b in batches), default=0)
    shard_lane_counts = np.zeros((shards or 1,), np.int64)
    kind_counts: Dict[str, int] = {}
    for wave in range(n_waves):
        cols: List[List[int]] = []
        staged: List[Tuple[int, Msg]] = []
        for row in range(m):
            if wave >= len(batches[row]):
                continue
            for msg in batches[row][wave]:
                gs, cnt = msg.rmw_id.gsess, msg.rmw_id.counter
                # host mirror of ops.gather_is_registered (clip + compare)
                reg = int(gs >= 0 and freg[row, min(gs, num_gsess - 1)]
                          >= cnt)
                cols.append([row, msg.key] + _msg_lane(msg) + [reg])
                staged.append((row, msg))
        host = _pack(cols)
        got = _fused_wave_step(stage, kv, kv_next, repmask, host)
        kv, kv_next = kv_next, kv
        for j, (row, msg) in enumerate(staged):
            rep = handlers.apply_msg(get_kv(kvs[row], msg.key), msg,
                                     regs[row])
            kn = msg.kind.name.lower()
            kind_counts[kn] = kind_counts.get(kn, 0) + 1
            want = _expected_reply_lanes(rep)
            got_j = _got_reply_lanes(got, j, want)
            if got_j != want:
                raise ReplayMismatch(
                    f"{what} reply diverged at wave {wave}, machine "
                    f"{mids[row]}, {where_key(msg.key)}, msg {msg}:\n"
                    f" scalar: {want}\n fused:  {got_j}")
        # commit-lane registrations scatter back after the wave (max-merge,
        # out-of-range dropped — ops.scatter_register's dead-slot contract)
        # into the machine-global registry AND, sharded, the journal of the
        # lane's owning shard
        rows, keys = host[0], host[1]
        gs, cnt = host[i_sess].astype(np.int64), host[i_cnt]
        live = (got[N_REP] != 0) & (gs >= 0) & (gs < num_gsess)
        np.maximum.at(freg, (rows[live], gs[live]), cnt[live])
        if sm is not None:
            lane_shard = keys // sm.lanes_per_shard
            shard_lane_counts += np.bincount(lane_shard, minlength=shards)
            np.maximum.at(journals, (rows[live], lane_shard[live], gs[live]),
                          cnt[live])
        # per machine in row order: its registry, then (sharded) its
        # journals' re-merge
        bad_reg = _first_reg_diff(freg, scalar_reg)
        bad_jnl = None
        if sm is not None:
            merged = journals.max(axis=1)
            bad_jnl = _first_reg_diff(merged, freg)
        if bad_reg is not None and (bad_jnl is None
                                    or bad_reg[0] <= bad_jnl[0]):
            row, gs_bad = bad_reg
            raise ReplayMismatch(
                f"{what} registry diverged at wave {wave}, machine "
                f"{mids[row]}, global session {gs_bad}: scalar "
                f"{scalar_reg[row, gs_bad]}, fused {freg[row, gs_bad]}")
        if bad_jnl is not None:
            row, gs_bad = bad_jnl
            raise ReplayMismatch(
                f"per-shard registration journals diverged from the "
                f"global registry at wave {wave}, machine {mids[row]}, "
                f"global session {gs_bad}: merged journals "
                f"{merged[row, gs_bad]}, global {freg[row, gs_bad]}")

    # final state: every row, every lane (shard block by shard block),
    # plane for plane
    bad = _first_kv_diff(kv, kvs, k)
    if bad is not None:
        row, key, diff = bad
        raise ReplayMismatch(
            f"{what} final KV state diverged at machine {mids[row]}, "
            f"{where_key(key)} (field: (scalar, fused)): {diff}")

    stats = {"machines": m, "messages": total_msgs, "fused_waves": n_waves}
    if sm is not None:
        stats.update(shards=shards, lane_axis=k)
        for s, c in enumerate(shard_lane_counts):
            stats[f"shard{s}_lanes"] = int(c)
    stats.update(kind_counts)
    return stats


def replay_cluster_fused(cluster: Cluster, *, n_keys: int,
                         device: DeviceLike = None,
                         machines: Optional[Sequence[int]] = None
                         ) -> Dict[str, int]:
    """Replay every (or selected) machine's trace through fused ticks.

    Unlike :func:`replay_cluster` (N independent single-machine replays),
    all machines share each fused step: one ``paxos_apply`` call over the
    ``(18, M*K)`` stack per wave, exactly like the serve-path
    ClusterEngine.  Raises :class:`ReplayMismatch` on the first reply,
    plane or registry divergence of any row.
    """
    return _replay_stacked(cluster, n_keys, None, device, machines)


def _traced_run(seed: int, n_ops: int, keys: int,
                cfg: Optional[ProtocolConfig], net: Optional[NetConfig],
                rmw_frac: float, write_frac: float) -> Cluster:
    cluster = Cluster(cfg or ProtocolConfig(n_machines=5,
                                            sessions_per_machine=2),
                      net or _faulty_net(seed))
    cluster.enable_msg_trace()
    workload(cluster, n_ops=n_ops, keys=keys, seed=seed,
             rmw_frac=rmw_frac, write_frac=write_frac, op=RmwOp.FAA)
    if not cluster.run_until_quiet(max_ticks=120_000):
        raise RuntimeError(f"sim (seed {seed}) did not quiesce")
    return cluster


def run_and_replay_fused(seed: int, *, n_ops: int = 24, keys: int = 3,
                         cfg: Optional[ProtocolConfig] = None,
                         net: Optional[NetConfig] = None,
                         rmw_frac: float = 0.45, write_frac: float = 0.3,
                         device: DeviceLike = None) -> Dict[str, int]:
    """End-to-end fused harness: seeded faulty sim -> stacked replay."""
    cluster = _traced_run(seed, n_ops, keys, cfg, net, rmw_frac, write_frac)
    stats = replay_cluster_fused(cluster, n_keys=keys, device=device)
    stats["history"] = len(cluster.history)
    return stats


def replay_sharded(cluster: Cluster, *, n_keys: int, shards: int = 2,
                   device: DeviceLike = None,
                   machines: Optional[Sequence[int]] = None
                   ) -> Dict[str, int]:
    """:func:`replay_cluster_fused` with a sharded lane axis, checked
    shard for shard.

    The lane axis is aligned up to ``shards`` contiguous blocks (the
    :class:`~repro_torch.core.lanes.ShardMap` block partition — lane ==
    key, no permutation), and one ``paxos_apply`` call spans every shard
    (the kernel has no padding contract, so no segment is padded).
    Against the same N scalar-handler shadows this asserts, per wave,
    every staged reply; per wave, that each machine's registry (gathered
    pre-wave, commit registrations scattered post-wave) matches the scalar
    one AND that re-merging the per-shard registration journals — the
    cross-shard scatter bookkeeping the serve bridge mirrors — reproduces
    it; and, finally, every KV plane of every shard block of every row.
    Raises :class:`ReplayMismatch` naming the shard on the first
    divergence.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    return _replay_stacked(cluster, n_keys, shards, device, machines)


def run_and_replay_sharded(seed: int, *, shards: int = 2, n_ops: int = 24,
                           keys: int = 3,
                           cfg: Optional[ProtocolConfig] = None,
                           net: Optional[NetConfig] = None,
                           rmw_frac: float = 0.45, write_frac: float = 0.3,
                           device: DeviceLike = None) -> Dict[str, int]:
    """End-to-end sharded harness: seeded faulty sim -> sharded replay."""
    cluster = _traced_run(seed, n_ops, keys, cfg, net, rmw_frac, write_frac)
    stats = replay_sharded(cluster, n_keys=keys, shards=shards,
                           device=device)
    stats["history"] = len(cluster.history)
    return stats


# ===========================================================================
# Differential proposer replay: issuer traces vs the batched proposer engine
# ===========================================================================
#
# The issuer is driven by replies *and* by local KV-coupled context, so its
# trace carries both: round-start events (the broadcasts, which reload a
# session's lane — they are inputs, exactly like messages are inputs to the
# receiver replay), steered replies (the engine's work), the decisions the
# live machine took (the oracle for the engine's decision planes), and
# pauses (rounds abandoned from inspection timeouts).  The replay drives a
# scalar shadow — the same Tally/abd_fold/decide_* code the Machine runs —
# and the batched ProposerTable through identical event streams and asserts
# after every reply batch that decisions, emissions and every table plane
# agree.

# ActionBatch planes a decision's payload pins down, and the wire kind of
# engine-owned emissions — canonical tables in repro_torch.core.proposer,
# shared with the live batched dispatch (repro_torch.serve.paxos.machine).
_ACTION_KEYS = ACTION_PAYLOAD_KEYS
_BCAST_KIND = BCAST_KINDS
_TAB_FIELDS = proposer_vector.ProposerTable._fields
_IREP_FIELDS = proposer_vector.IssuerReplyBatch._fields
_ACT_INDEX = {f: i for i, f in
              enumerate(proposer_vector.ActionBatch._fields)}


def _bits(srcs) -> int:
    out = 0
    for s in srcs:
        out |= 1 << s
    return out


class _SessShadow:
    """Scalar shadow of one issuer lane, driven by the SAME pure transition
    functions the live Machine runs (Tally.note, abd_fold, decide_*)."""

    def __init__(self):
        self.phase = Phase.IDLE
        self.lid = 0
        self.aboard = 0
        self.helping = 0
        self.lth_counter = 0
        self.key = 0
        self.ts_v, self.ts_m = 0, -1
        self.log_no = 0
        self.rmw_cnt, self.rmw_sess = 0, -1
        self.value = 0
        self.has_value = 0
        self.base_v, self.base_m = 0, -1
        self.val_log = 0
        self.tally = Tally()
        self.abd = AbdEntry(sess=0)
        self.abd_paused = False

    # -- event application (inputs: identical for shadow and lanes) ---------

    def load_rmw_round(self, ev: RmwRound) -> None:
        self.phase = ev.phase
        self.lid = ev.lid
        self.aboard, self.helping = ev.aboard, ev.helping
        self.lth_counter = ev.lth_counter
        self.key = ev.key
        self.ts_v, self.ts_m = ev.ts.version, ev.ts.mid
        self.log_no = ev.log_no
        self.rmw_cnt, self.rmw_sess = ev.rmw_id.counter, ev.rmw_id.gsess
        self.value, self.has_value = ev.value, ev.has_value
        self.base_v, self.base_m = ev.base_ts.version, ev.base_ts.mid
        self.val_log = ev.val_log
        self.tally = Tally()

    def load_abd_round(self, ev: AbdRound) -> None:
        ab = AbdEntry(sess=ev.sess)
        ab.phase = ev.phase
        ab.lid, ab.key, ab.value = ev.lid, ev.key, ev.value
        ab.repliers = {s for s in range(8) if ev.rep_bits >> s & 1}
        ab.storers = {s for s in range(8) if ev.store_bits >> s & 1}
        if ev.phase in (AbdPhase.W_QUERY, AbdPhase.W_WRITE):
            ab.max_base = ev.base_ts
        else:
            ab.best_cs = Carstamp(ev.base_ts, ev.val_log)
            ab.best_value = ev.value
            ab.best_log_no, ab.best_rmw_id = ev.log_no, ev.rmw_id
            ab.sent_cs = Carstamp(ev.sent_base_ts, ev.sent_val_log)
        self.abd = ab
        self.abd_paused = False

    def pause(self, abd: int) -> None:
        if abd:
            self.abd_paused = True
        else:
            self.phase = Phase.PAUSED

    # -- reply application (the logic under differential test) --------------

    def _abd_apply(self, rep: Reply, cfg: ProtocolConfig):
        if self.abd_paused or not proposer.abd_fold(self.abd, rep):
            return Decision.WAIT, None
        ab = self.abd
        d = proposer.decide_abd(ab, majority=cfg.majority)
        if d == Decision.WAIT:
            return d, None
        self.abd_paused = True
        if d == Decision.ABD_W2:
            return d, {"key": ab.key, "value": ab.value,
                       "base_v": ab.max_base.version,
                       "base_m": ab.max_base.mid}
        if d == Decision.ABD_R_WB:
            return d, {"key": ab.key, "log_no": ab.best_log_no,
                       "rmw_cnt": ab.best_rmw_id.counter,
                       "rmw_sess": ab.best_rmw_id.gsess,
                       "value": ab.best_value,
                       "base_v": ab.best_cs.base.version,
                       "base_m": ab.best_cs.base.mid,
                       "val_log": ab.best_cs.log_no}
        return d, None

    def apply_reply(self, rep: Reply, cfg: ProtocolConfig):
        """Steer + fold + decide; returns (Decision, payload dict | None).

        Mirrors ``proposer_core`` gating exactly (a PAUSED lane tallies
        nothing); the live machine may fold a straggler into a tally no
        check will ever read again — invisible to decisions either way.
        """
        if rep.kind in (MsgKind.WRITE_QUERY_REPLY, MsgKind.WRITE_ACK,
                        MsgKind.READ_QUERY_REPLY):
            return self._abd_apply(rep, cfg)
        if rep.kind == MsgKind.COMMIT_ACK:
            if self.phase == Phase.COMMITTED and self.lid == rep.lid:
                self.tally.note(rep)
                d = proposer.decide_commit(
                    self.tally, majority=cfg.majority,
                    quorum_is_majority=cfg.commit_ack_quorum_is_majority)
                if d != Decision.WAIT:
                    self.phase = Phase.PAUSED
                return d, None
            return self._abd_apply(rep, cfg)
        if (rep.kind == MsgKind.PROP_REPLY and self.phase == Phase.PROPOSED
                and self.lid == rep.lid):
            self.tally.note(rep)
            d, pay = proposer.decide_propose(
                self.tally, majority=cfg.majority,
                own_rmw_id=RmwId(self.rmw_cnt, self.rmw_sess),
                log_too_high_counter=self.lth_counter,
                log_too_high_threshold=cfg.log_too_high_threshold)
            if d == Decision.WAIT:
                return d, None
            self.phase = Phase.PAUSED
            if d == Decision.RETRY:
                return d, proposer.retry_payload(self.tally)
            if d == Decision.LOG_TOO_LOW:
                return d, proposer.log_too_low_payload(pay)
            if d in (Decision.HELP, Decision.HELP_SELF):
                return d, proposer.lower_acc_payload(pay)
            return d, None
        if (rep.kind == MsgKind.ACC_REPLY and self.phase == Phase.ACCEPTED
                and self.lid == rep.lid):
            self.tally.note(rep)
            d, pay = proposer.decide_accept(
                self.tally, n_machines=cfg.n_machines,
                majority=cfg.majority, helping=self.helping == 1,
                all_aboard=self.aboard == 1)
            if d == Decision.WAIT:
                return d, None
            self.phase = Phase.PAUSED
            if d == Decision.RETRY:
                return d, proposer.retry_payload(self.tally)
            if d == Decision.LOG_TOO_LOW:
                return d, proposer.log_too_low_payload(pay)
            if d == Decision.COMMIT_BCAST:
                thin = self.tally.acks >= cfg.n_machines
                return d, {"log_no": self.log_no, "rmw_cnt": self.rmw_cnt,
                           "rmw_sess": self.rmw_sess,
                           "value": 0 if thin else self.value,
                           "has_value": 0 if thin else 1,
                           "base_v": self.base_v, "base_m": self.base_m,
                           "val_log": self.val_log}
            return d, None
        return Decision.WAIT, None

    # -- plane conversion ----------------------------------------------------

    def to_lanes(self) -> Dict[str, int]:
        t = self.tally
        sh, ltl, la = t.seen_higher, t.log_too_low, t.lower_acc
        ab = self.abd
        return dict(
            phase=int(self.phase), lid=self.lid, aboard=self.aboard,
            helping=self.helping, lth_counter=self.lth_counter,
            key=self.key, ts_v=self.ts_v, ts_m=self.ts_m,
            log_no=self.log_no, rmw_cnt=self.rmw_cnt,
            rmw_sess=self.rmw_sess, value=self.value,
            has_value=self.has_value, base_v=self.base_v,
            base_m=self.base_m, val_log=self.val_log,
            rep_bits=_bits(t.repliers), ack_bits=_bits(t.ackers),
            rmw_flag=int(t.rmw_committed),
            rmw_nb_flag=int(t.rmw_committed_no_bcast),
            lth_flag=int(t.log_too_high),
            sh_has=int(sh is not None),
            sh_v=sh.version if sh is not None else 0,
            sh_m=sh.mid if sh is not None else -1,
            ltl_has=int(ltl is not None),
            ltl_log=ltl.log_no if ltl is not None else 0,
            ltl_cnt=ltl.rmw_id.counter if ltl is not None else 0,
            ltl_sess=ltl.rmw_id.gsess if ltl is not None else -1,
            ltl_val=ltl.value if ltl is not None else 0,
            ltl_base_v=ltl.base_ts.version if ltl is not None else 0,
            ltl_base_m=ltl.base_ts.mid if ltl is not None else -1,
            ltl_vlog=ltl.val_log if ltl is not None else 0,
            la_has=int(la is not None),
            la_ts_v=la.ts.version if la is not None else 0,
            la_ts_m=la.ts.mid if la is not None else -1,
            la_cnt=la.rmw_id.counter if la is not None else 0,
            la_sess=la.rmw_id.gsess if la is not None else -1,
            la_val=la.value if la is not None else 0,
            la_base_v=la.base_ts.version if la is not None else 0,
            la_base_m=la.base_ts.mid if la is not None else -1,
            la_vlog=la.val_log if la is not None else 0,
            fr_has=int(t.fresh_value is not None),
            fr_val=t.fresh_value if t.fresh_value is not None else 0,
            fr_base_v=t.fresh_cs.base.version,
            fr_base_m=t.fresh_cs.base.mid,
            fr_log=t.fresh_cs.log_no,
            abd_phase=ABD_PAUSED if self.abd_paused else int(ab.phase),
            abd_lid=ab.lid, abd_key=ab.key, abd_value=ab.value,
            abd_rep_bits=_bits(ab.repliers), abd_ack_bits=_bits(ab.ackers),
            abd_store_bits=_bits(ab.storers),
            abd_maxb_v=ab.max_base.version, abd_maxb_m=ab.max_base.mid,
            abd_sent_base_v=ab.sent_cs.base.version,
            abd_sent_base_m=ab.sent_cs.base.mid,
            abd_sent_vlog=ab.sent_cs.log_no,
            best_base_v=ab.best_cs.base.version,
            best_base_m=ab.best_cs.base.mid,
            best_vlog=ab.best_cs.log_no, best_val=ab.best_value,
            best_log=ab.best_log_no, best_cnt=ab.best_rmw_id.counter,
            best_sess=ab.best_rmw_id.gsess)


def replay_issuer_trace(events: Sequence[object], *, cfg: ProtocolConfig,
                        device: DeviceLike = None) -> Dict[str, int]:
    """Replay one machine's issuer trace through the scalar shadow AND the
    issuer engine on ``device``, asserting plane-for-plane equality after
    every reply batch, and decisions/emissions against the live machine's
    record.

    Raises :class:`ReplayMismatch` on the first divergence.
    """
    dev = resolve_device(device)
    n_sess = cfg.sessions_per_machine
    commit_need = (cfg.majority - 1 if cfg.commit_ack_quorum_is_majority
                   else 1)
    # the engine's table on the host, between steps; the round loaders
    # write into it through per-plane row views
    tab = np.repeat(np.array([proposer_vector.TABLE_DEFAULTS[f]
                              for f in _TAB_FIELDS], np.int32)[:, None],
                    n_sess, axis=1)
    lanes = {f: tab[i] for i, f in enumerate(_TAB_FIELDS)}
    shadows = [_SessShadow() for _ in range(n_sess)]
    # the shadows' planes, recomputed for the sessions in `dirty` only
    expected = np.zeros_like(tab)
    dirty: Set[int] = set(range(n_sess))
    pending: Dict[int, Reply] = {}
    expected_d: List[deque] = [deque() for _ in range(n_sess)]
    stats = {"events": len(events), "replies": 0, "batches": 0,
             "decisions": 0}
    wait = int(Decision.WAIT)

    def compare_planes(where: str) -> None:
        for sess in dirty:
            want = shadows[sess].to_lanes()
            expected[:, sess] = [want[f] for f in _TAB_FIELDS]
        dirty.clear()
        if np.array_equal(tab, expected):
            return
        sess = int(np.flatnonzero((tab != expected).any(0))[0])
        want = shadows[sess].to_lanes()
        got = {f: int(lanes[f][sess]) for f in want}
        diff = {f: (want[f], got[f]) for f in want if want[f] != got[f]}
        raise ReplayMismatch(
            f"proposer planes diverged ({where}) at session {sess} "
            f"(plane: (scalar, vector)): {diff}")

    def flush() -> None:
        if not pending:
            return
        stats["batches"] += 1
        repb = np.zeros((len(_IREP_FIELDS), n_sess), np.int32)
        repb[0] = -1                                   # idle lanes: kind -1
        for sess, rep in pending.items():
            lane = reply_to_lanes(rep)
            repb[:, sess] = [lane[f] for f in _IREP_FIELDS]
        table = proposer_vector.ProposerTable(
            *torch.from_numpy(tab).to(dev).unbind(0))
        batch = proposer_vector.IssuerReplyBatch(
            *torch.from_numpy(repb).to(dev).unbind(0))
        table, actions = issuer_step(
            table, batch, n_machines=cfg.n_machines, majority=cfg.majority,
            commit_need=commit_need,
            log_too_high_threshold=cfg.log_too_high_threshold)
        out = torch.cat([torch.stack(table), torch.stack(actions)]).cpu()
        tab[:] = out[:N_TAB].numpy()
        act = out[N_TAB:].numpy()
        # scalar shadow + three-way decision/emission check, in session
        # order over the pending lanes and any idle lane that decided
        idle_bad = np.flatnonzero(act[0] != wait).tolist()
        for sess in sorted(set(pending).union(idle_bad)):
            got_d = Decision(int(act[0, sess]))
            if sess not in pending:
                raise ReplayMismatch(
                    f"engine decided {got_d.name} on idle lane {sess}")
            dirty.add(sess)
            sh_d, sh_pay = shadows[sess].apply_reply(pending[sess], cfg)
            if got_d != sh_d:
                raise ReplayMismatch(
                    f"decision diverged at session {sess}: scalar "
                    f"{sh_d.name}, vector {got_d.name} "
                    f"(reply {pending[sess]})")
            if sh_d == Decision.WAIT:
                continue
            stats["decisions"] += 1
            stats[f"d_{sh_d.name.lower()}"] = \
                stats.get(f"d_{sh_d.name.lower()}", 0) + 1
            if not expected_d[sess]:
                raise ReplayMismatch(
                    f"session {sess} decided {sh_d.name} but the live "
                    f"machine recorded no decision here")
            ev = expected_d[sess].popleft()
            if ev.decision != sh_d:
                raise ReplayMismatch(
                    f"live machine decided {ev.decision.name} at session "
                    f"{sess}, replay decided {sh_d.name}")
            keys = _ACTION_KEYS.get(sh_d)
            if keys is not None:
                got_pay = {k: int(act[_ACT_INDEX[k], sess]) for k in keys}
                if ev.payload != got_pay or sh_pay != got_pay:
                    raise ReplayMismatch(
                        f"decision payload diverged at session {sess} "
                        f"({sh_d.name}): machine {ev.payload}, shadow "
                        f"{sh_pay}, vector {got_pay}")
            want_kind = _BCAST_KIND.get(sh_d, -1)
            got_kind = int(act[_ACT_INDEX["bcast_kind"], sess])
            if got_kind != want_kind:
                raise ReplayMismatch(
                    f"emission kind diverged at session {sess} "
                    f"({sh_d.name}): want {want_kind}, got {got_kind}")
        pending.clear()
        compare_planes("after batch")

    for ev in events:
        if isinstance(ev, ReplyEvent):
            if ev.sess in pending:
                flush()
            stats["replies"] += 1
            pending[ev.sess] = ev.reply
        elif isinstance(ev, DecisionEvent):
            expected_d[ev.sess].append(ev)
        elif isinstance(ev, RmwRound):
            if ev.sess in pending:
                flush()
            shadows[ev.sess].load_rmw_round(ev)
            _load_rmw_round_lanes(lanes, ev)
            dirty.add(ev.sess)
        elif isinstance(ev, AbdRound):
            if ev.sess in pending:
                flush()
            shadows[ev.sess].load_abd_round(ev)
            _load_abd_round_lanes(lanes, ev)
            dirty.add(ev.sess)
        elif isinstance(ev, PauseEvent):
            if ev.sess in pending:
                flush()
            shadows[ev.sess].pause(ev.abd)
            if ev.abd:
                lanes["abd_phase"][ev.sess] = ABD_PAUSED
            else:
                lanes["phase"][ev.sess] = int(Phase.PAUSED)
            dirty.add(ev.sess)
        else:
            raise TypeError(f"unknown issuer trace event {ev!r}")
    flush()
    compare_planes("end of trace")
    leftovers = sum(len(q) for q in expected_d)
    if leftovers:
        raise ReplayMismatch(
            f"{leftovers} live-machine decisions were never reproduced "
            f"by the replay")
    return stats


def replay_issuer_cluster(cluster: Cluster,
                          machines: Optional[Sequence[int]] = None, *,
                          device: DeviceLike = None) -> Dict[str, int]:
    """Replay every (or selected) machine's issuer trace; aggregate stats."""
    total: Dict[str, int] = {"machines": 0}
    mids = machines if machines is not None else range(len(cluster.machines))
    for mid in mids:
        events = cluster.machines[mid].issuer_trace
        if events is None:
            raise ValueError(
                f"machine {mid} has no issuer_trace — call "
                f"cluster.enable_issuer_trace() before running the workload")
        stats = replay_issuer_trace(events, cfg=cluster.cfg, device=device)
        total["machines"] += 1
        for k, v in stats.items():
            total[k] = total.get(k, 0) + v
    return total


def run_and_replay_issuer(seed: int, *, n_ops: int = 24, keys: int = 3,
                          cfg: Optional[ProtocolConfig] = None,
                          net: Optional[NetConfig] = None,
                          rmw_frac: float = 0.45, write_frac: float = 0.3,
                          all_aboard: bool = False,
                          device: DeviceLike = None) -> Dict[str, int]:
    """End-to-end proposer harness: seeded faulty sim -> issuer replay.

    The mirror image of :func:`run_and_replay`: same adversarial network
    and mixed workload, but the differential surface is the *issuer* side —
    every machine's recorded reply stream is replayed through the scalar
    shadow and :func:`repro_torch.kernels.paxos_propose.ops.issuer_step`.
    """
    if cfg is None:
        cfg = ProtocolConfig(n_machines=5, sessions_per_machine=2,
                             all_aboard=all_aboard)
    elif all_aboard and not cfg.all_aboard:
        # don't silently drop the §9 deployment request on an explicit cfg
        cfg = dataclasses.replace(cfg, all_aboard=True)
    cluster = Cluster(cfg, net or _faulty_net(seed))
    cluster.enable_issuer_trace()
    workload(cluster, n_ops=n_ops, keys=keys, seed=seed,
             rmw_frac=rmw_frac, write_frac=write_frac, op=RmwOp.FAA)
    if not cluster.run_until_quiet(max_ticks=120_000):
        raise RuntimeError(f"sim (seed {seed}) did not quiesce")
    stats = replay_issuer_cluster(cluster, device=device)
    stats["history"] = len(cluster.history)
    return stats
