"""Joiner catch-up: snapshot + replay.

A machine entering (or re-entering) the membership must not vote before
it holds the decided history — its acceptor state participates in quorum
intersection from its first reply.  Catch-up is the classic two-step:

1. **snapshot** — a member serializes its committed + acceptor state as a
   flat dict of numpy planes (:func:`take_snapshot`): the receiver KV
   planes (one column per :class:`~repro_torch.core.vector.KVTable` field, via
   the shared :func:`~repro_torch.core.lanes.kv_to_lanes` converter), the
   rmw-id registry, the write clock, and — for batched machines — the
   issuer :class:`~repro_torch.core.proposer_vector.ProposerTable` lanes.  The
   same dict round-trips through :mod:`repro_torch.checkpoint.store`
   (:func:`save_snapshot` / :func:`load_snapshot`), so a snapshot can
   also be persisted and committed like any checkpoint.
2. **replay** — the joiner installs the planes (:func:`install_snapshot`)
   and then replays the donor's committed tail (:func:`replay_tail`):
   every commit-log row the joiner does not know yet is re-applied
   through the ordinary :func:`~repro_torch.core.handlers.commit_to_kv` path,
   which is idempotent and carstamp/log-gated — a rejoiner with stale
   persistent state converges to the donor's history without ever
   regressing its own.

The snapshot travels in-sim as the ``blob`` of a SYNC message (see
``Machine._serve_sync`` / ``Machine._install_sync``); it contains only
*persistent* state — sessions, tallies and in-flight rounds are volatile
and deliberately absent (the donor's sessions are not the joiner's).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.handlers import commit_to_kv, get_kv
from repro_torch.core.lanes import kv_to_lanes, lanes_to_kv
from repro_torch.core.types import KVPair, KVState, RmwId, TS

SCHEMA = 1

# KVTable field names, in kv_to_lanes order (single source of truth)
_KV_FIELDS = tuple(kv_to_lanes(KVPair(key=0)).keys())


def _kv_columns_per_key(machine):
    """Sorted keys and field -> int32 column of a machine's KV pairs, read
    one checked-out pair at a time (the scalar machine's dict)."""
    keys = sorted(machine.kvs.keys())
    cols = {f: np.zeros((len(keys),), np.int32) for f in _KV_FIELDS}
    for i, key in enumerate(keys):
        lanes = kv_to_lanes(machine.kvs[key])
        for f in _KV_FIELDS:
            cols[f][i] = lanes[f]
    return keys, cols


def _kv_columns(machine):
    """As :func:`_kv_columns_per_key`; a batched machine's bridge reads
    its whole plane row as columns instead (every lane is a key, 2^20 of
    them at full width), with the same result."""
    row_columns = getattr(machine.kvs, "row_columns", None)
    if row_columns is None:
        return _kv_columns_per_key(machine)
    cols = row_columns()
    return range(machine.kvs.n_keys), {f: cols[f] for f in _KV_FIELDS}


def take_snapshot(machine) -> Dict[str, np.ndarray]:
    """Serialize a machine's persistent state as flat numpy planes."""
    keys, cols = _kv_columns(machine)
    commit_rows = [(key, log_no, rid.counter, rid.gsess, value,
                    base.version, base.mid)
                   for key, slots in sorted(machine.commit_log.items())
                   for log_no, (rid, value, base) in sorted(slots.items())]
    write_rows = [(key, base.version, base.mid, value)
                  for key, base, value in machine.write_log]
    snap = {
        "schema": np.array([SCHEMA], np.int32),
        "view": np.array([machine.view.encode()], np.int64),
        "write_clock": np.array([machine.write_clock], np.int64),
        "keys": np.array(keys, np.int64),
        "registry": np.array(machine.registry.committed, np.int64),
        "commit_rows": np.array(commit_rows, np.int64).reshape(-1, 7),
        "write_rows": np.array(write_rows, np.int64).reshape(-1, 4),
    }
    for f in _KV_FIELDS:
        snap[f"kv_{f}"] = cols[f]
    lanes = getattr(machine, "lanes_ro", None)
    if lanes is not None:
        # batched machine: issuer ProposerTable planes ride along so a
        # snapshot is also a full engine-state checkpoint (self-restore /
        # the round-trip property test) — install on a *different* machine
        # ignores them (sessions are volatile and per-machine).
        for f, plane in lanes.items():
            snap[f"lane_{f}"] = np.array(plane, np.int32)
    return snap


def _snap_kv(snap: Dict[str, np.ndarray], i: int, key: int) -> KVPair:
    planes = {f: snap[f"kv_{f}"] for f in _KV_FIELDS}
    kv = lanes_to_kv(planes, i)
    kv.key = key                     # lanes_to_kv uses the index as the key
    return kv


def _merge_kv(mine: Optional[KVPair], theirs: KVPair) -> KVPair:
    """Conservative per-field-group merge of a rejoiner's persistent pair
    with the donor's.  Per group, keep the maximum — acceptor state is
    sticky (promises/accepts must never regress, Paxos safety) and the
    value plane is carstamp-ordered (ABD safety)."""
    if mine is None:
        return theirs
    out = mine
    # committed prefix: donor ahead -> adopt its last-committed bookmark
    if theirs.last_committed_log_no > out.last_committed_log_no:
        out.last_committed_log_no = theirs.last_committed_log_no
        out.last_committed_rmw_id = theirs.last_committed_rmw_id
    # value plane: highest carstamp wins
    if theirs.carstamp > out.carstamp:
        out.value = theirs.value
        out.base_ts = theirs.base_ts
        out.val_log = theirs.val_log
    # working slot: donor strictly ahead -> adopt its slot state wholesale;
    # same slot -> keep the higher promise/accept (field-wise max)
    if theirs.log_no > out.log_no:
        out.state = theirs.state
        out.log_no = theirs.log_no
        out.proposed_ts = theirs.proposed_ts
        out.accepted_ts = theirs.accepted_ts
        out.accepted_value = theirs.accepted_value
        out.acc_base_ts = theirs.acc_base_ts
        out.rmw_id = theirs.rmw_id
    elif theirs.log_no == out.log_no:
        if theirs.proposed_ts > out.proposed_ts:
            out.proposed_ts = theirs.proposed_ts
            out.rmw_id = theirs.rmw_id
        if theirs.accepted_ts > out.accepted_ts:
            out.accepted_ts = theirs.accepted_ts
            out.accepted_value = theirs.accepted_value
            out.acc_base_ts = theirs.acc_base_ts
        if int(theirs.state) > int(out.state):
            out.state = theirs.state
    # a slot at or below the committed prefix is already decided
    if (out.state != KVState.INVALID
            and out.log_no <= out.last_committed_log_no):
        out.state = KVState.INVALID
    return out


def _gt(a, b):
    """Lexicographic ``a > b`` of equal-length tuples of int columns."""
    out = np.zeros(np.shape(a[0]), bool)
    tie = np.ones(np.shape(a[0]), bool)
    for x, y in zip(a, b):
        out |= tie & (x > y)
        tie &= x == y
    return out


# field groups of _merge_kv, by KVTable field
_COMMITTED = ("last_log", "last_rmw_cnt", "last_rmw_sess")
_VALUE = ("value", "base_v", "base_m", "val_log")
_PROPOSED = ("prop_v", "prop_m", "rmw_cnt", "rmw_sess")
_ACCEPTED = ("acc_v", "acc_m", "acc_val", "acc_base_v", "acc_base_m")
_SLOT = ("state", "log_no") + _PROPOSED + _ACCEPTED


def _merge_kv_columns(mine: Dict[str, np.ndarray],
                      theirs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """:func:`_merge_kv` over whole columns (field -> int column, lane
    ``i`` of each the pair of one key): the same per-group rules as
    selects."""
    o = {f: np.asarray(mine[f]) for f in _KV_FIELDS}
    t = {f: np.asarray(theirs[f]) for f in _KV_FIELDS}
    out = dict(o)
    take = t["last_log"] > o["last_log"]
    for f in _COMMITTED:
        out[f] = np.where(take, t[f], o[f])
    take = _gt([t[f] for f in ("base_v", "base_m", "val_log")],
               [o[f] for f in ("base_v", "base_m", "val_log")])
    for f in _VALUE:
        out[f] = np.where(take, t[f], o[f])
    ahead = t["log_no"] > o["log_no"]
    same = t["log_no"] == o["log_no"]
    sel = {f: ahead for f in _SLOT}
    prop = same & _gt((t["prop_v"], t["prop_m"]), (o["prop_v"], o["prop_m"]))
    for f in _PROPOSED:
        sel[f] = sel[f] | prop
    acc = same & _gt((t["acc_v"], t["acc_m"]), (o["acc_v"], o["acc_m"]))
    for f in _ACCEPTED:
        sel[f] = sel[f] | acc
    sel["state"] = sel["state"] | (same & (t["state"] > o["state"]))
    for f in _SLOT:
        out[f] = np.where(sel[f], t[f], o[f])
    invalid = int(KVState.INVALID)
    decided = (out["state"] != invalid) & (out["log_no"] <= out["last_log"])
    out["state"] = np.where(decided, invalid, out["state"])
    return {f: out[f].astype(np.int32) for f in _KV_FIELDS}


def _existing_kv(machine, key: int) -> Optional[KVPair]:
    """The joiner's own pair for ``key``, or None if it has no real state
    (scalar dict: key absent; bridge: a fresh lane IS a default pair, and
    merging with a default pair adopts the donor's fields anyway)."""
    if isinstance(machine.kvs, dict):
        return machine.kvs.get(key)
    return machine.kvs[key]


def _install_kv_per_key(machine, snap: Dict[str, np.ndarray]) -> None:
    """Merge the donor's KV planes into the joiner one pair at a time."""
    for i, key in enumerate(int(k) for k in snap["keys"]):
        merged = _merge_kv(_existing_kv(machine, key), _snap_kv(snap, i, key))
        machine.kvs[key] = merged


def _install_kv(machine, snap: Dict[str, np.ndarray]) -> None:
    """As :func:`_install_kv_per_key`; a batched machine's bridge merges
    the whole row as columns instead, with the same result."""
    write_row_columns = getattr(machine.kvs, "write_row_columns", None)
    keys = np.asarray(snap["keys"], np.int64)
    if write_row_columns is None or not len(keys):
        _install_kv_per_key(machine, snap)
        return
    machine.kvs.ensure(int(keys.max()))
    row = machine.kvs.row_columns()
    mine = {f: row[f][keys] for f in _KV_FIELDS}
    theirs = {f: snap[f"kv_{f}"] for f in _KV_FIELDS}
    write_row_columns(keys, _merge_kv_columns(mine, theirs))


def install_snapshot(machine, snap: Dict[str, np.ndarray]) -> None:
    """Install a donor snapshot on a (re)joiner, then replay the tail.

    Works on both the scalar machine (``kvs`` is a dict) and the batched
    machine (``kvs`` is the :class:`~repro_torch.serve.paxos.bridge.KVBridge`,
    whose row is merged as whole columns and scattered to the device at
    the next engine step).
    """
    assert int(snap["schema"][0]) == SCHEMA, "unknown snapshot schema"
    _install_kv(machine, snap)
    # registry: committed counters are monotone per global session
    reg = machine.registry.committed
    theirs = np.asarray(snap["registry"], np.int64)[:len(reg)]
    ahead = np.flatnonzero(theirs > np.array(reg[:len(theirs)], np.int64))
    for gsess in ahead.tolist():
        reg[gsess] = int(theirs[gsess])
    machine.write_clock = max(machine.write_clock,
                              int(snap["write_clock"][0]))
    for key, base_v, base_m, value in (tuple(int(x) for x in row)
                                       for row in snap["write_rows"]):
        rec = (key, TS(base_v, base_m), value)
        if rec not in machine.write_log:
            machine.write_log.append(rec)
    replay_tail(machine, snap)


def replay_tail(machine, snap: Dict[str, np.ndarray]) -> int:
    """Re-apply the donor's committed tail through the normal commit path.

    Every snapshot commit-log row the joiner does not know yet is applied
    via :func:`~repro_torch.core.handlers.commit_to_kv` (idempotent, log and
    carstamp gated) and recorded in the joiner's commit log for the
    checkers.  Returns the number of rows replayed.
    """
    replayed = 0
    for row in snap["commit_rows"]:
        key, log_no, cnt, gsess, value, base_v, base_m = (int(x) for x in row)
        if log_no in machine.commit_log.get(key, {}):
            continue
        rid, base = RmwId(cnt, gsess), TS(base_v, base_m)
        kv = get_kv(machine.kvs, key)
        commit_to_kv(kv, machine.registry, log_no=log_no, rmw_id=rid,
                     value=value, base_ts=base, val_log=log_no)
        machine.commit_log.setdefault(key, {})[log_no] = (rid, value, base)
        replayed += 1
    return replayed


# ---------------------------------------------------------------------------
# persistence through the checkpoint store
# ---------------------------------------------------------------------------

def save_snapshot(machine, directory: str, run: str, step: int = 1,
                  registry=None) -> bool:
    """Persist a snapshot through :func:`repro_torch.checkpoint.store.save`
    (optionally CAS-committed in a :class:`PaxosRegistry`)."""
    from repro_torch.checkpoint import store
    return store.save(directory, run, step, take_snapshot(machine),
                      registry=registry)


def load_snapshot(directory: str, run: str, like: Dict[str, np.ndarray],
                  step: Optional[int] = None,
                  registry=None) -> Dict[str, np.ndarray]:
    """Load a persisted snapshot back as numpy planes (``like`` supplies
    the shapes/dtypes, e.g. ``{k: np.zeros_like(v) for ...}`` of a
    :func:`take_snapshot` dict)."""
    from repro_torch.checkpoint import store
    if step is None and registry is None:
        step = 1                   # save_snapshot's default step
    tree, _ = store.restore(directory, run, like, registry=registry,
                            step=step)
    return {k: np.asarray(v) for k, v in tree.items()}


def snapshot_equal(a: Dict[str, np.ndarray],
                   b: Dict[str, np.ndarray]) -> bool:
    """Plane-for-plane equality of two snapshots."""
    if set(a) != set(b):
        return False
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
               for k in a)
