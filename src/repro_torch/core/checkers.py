"""Safety checkers: per-key log agreement, exactly-once, and linearizability.

These encode the paper's correctness requirements (§7):

* **log agreement** — for every key and log slot, all machines that recorded
  a commit for that slot recorded the *same* (rmw-id, value);
* **exactly-once** — no rmw-id appears in two different (key, slot) commit
  records; every completed RMW appears in at most one slot;
* **inv-1 projection** — the committed slots of each key form a prefix
  1..N on at least one machine (the decided log has no holes globally);
* **linearizability** — an interval-order checker over the client history
  produced by the simulator (invoke/complete times on the global simulated
  clock).  For the single-register-per-key semantics here we exploit that
  every completed RMW/write carries the *carstamp* it committed with, and
  carstamps are exactly the linearization order the protocol promises
  (ABD + Paxos serialize through them, §10).  The checker therefore
  verifies that ordering ops by carstamp yields a legal sequential history
  that respects real-time precedence — which is the Gryff/carstamp
  linearizability argument.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

from .node import ReqKind
from .sim import Cluster
from .types import CS_ZERO, Carstamp, RmwId, apply_rmw


class SafetyViolation(AssertionError):
    pass


# ---------------------------------------------------------------------------
# Replica-state invariants
# ---------------------------------------------------------------------------

def check_log_agreement(cluster: Cluster) -> Dict[Tuple[int, int], Tuple]:
    """All commit records for (key, slot) agree on (rmw-id, value).

    Returns the merged decided log: {(key, slot): (rmw_id, value, base_ts)}.
    """
    decided: Dict[Tuple[int, int], Tuple] = {}
    for m in cluster.machines:
        for key, slots in m.commit_log.items():
            for slot, rec in slots.items():
                prev = decided.get((key, slot))
                if prev is None:
                    decided[(key, slot)] = rec
                elif prev != rec:
                    raise SafetyViolation(
                        f"log disagreement key={key} slot={slot}: "
                        f"{prev} vs {rec} (machine {m.mid})")
    return decided


def check_exactly_once(cluster: Cluster) -> None:
    """No rmw-id committed in two different (key, slot) positions."""
    decided = check_log_agreement(cluster)
    seen: Dict[RmwId, Tuple[int, int]] = {}
    for (key, slot), (rmw_id, _value, _base) in decided.items():
        if rmw_id.gsess < 0:
            continue
        if rmw_id in seen and seen[rmw_id] != (key, slot):
            raise SafetyViolation(
                f"rmw-id {rmw_id} committed twice: "
                f"{seen[rmw_id]} and {(key, slot)}")
        seen[rmw_id] = (key, slot)


def check_log_prefix(cluster: Cluster) -> None:
    """The globally decided slots of each key form a contiguous prefix."""
    decided = check_log_agreement(cluster)
    per_key: Dict[int, List[int]] = defaultdict(list)
    for (key, slot) in decided:
        per_key[key].append(slot)
    for key, slots in per_key.items():
        slots.sort()
        if slots != list(range(1, len(slots) + 1)):
            raise SafetyViolation(f"key {key}: non-prefix slots {slots}")


def check_registry_monotone(cluster: Cluster) -> None:
    """Registered rmw-id counters never exceed what was actually decided."""
    decided = check_log_agreement(cluster)
    max_decided: Dict[int, int] = defaultdict(int)
    for (_key, _slot), (rmw_id, _v, _b) in decided.items():
        if rmw_id.gsess >= 0:
            max_decided[rmw_id.gsess] = max(max_decided[rmw_id.gsess],
                                            rmw_id.counter)
    for m in cluster.machines:
        for gsess, counter in enumerate(m.registry.committed):
            if counter > max_decided.get(gsess, 0):
                raise SafetyViolation(
                    f"machine {m.mid} registered ({counter},{gsess}) beyond "
                    f"decided {max_decided.get(gsess, 0)}")


def check_completed_rmws_decided(cluster: Cluster) -> None:
    """Every RMW whose session got a completion is in the decided log with
    the value the client computed (read-value + op = committed value)."""
    decided = check_log_agreement(cluster)
    by_rmw = {rec[0]: ((key, slot), rec)
              for (key, slot), rec in decided.items()}
    for h in cluster.history:
        if h["kind"] != ReqKind.RMW:
            continue
        rid = h["rmw_id"]
        if rid not in by_rmw:
            raise SafetyViolation(f"completed RMW {rid} not in decided log")
        (_key, _slot), (_rid, value, _base) = by_rmw[rid]
        expect = apply_rmw(h["op"], h["value"], h["arg1"], h["arg2"])
        if expect != value:
            raise SafetyViolation(
                f"RMW {rid}: read {h['value']} + op -> {expect} but log has "
                f"{value}")


# ---------------------------------------------------------------------------
# Linearizability over the client history
# ---------------------------------------------------------------------------

def check_linearizable(cluster: Cluster) -> None:
    """Carstamp-order linearizability check per key.

    For each key: order completed writes/RMWs by their commit carstamp, and
    verify that

    1. the order is consistent with real time: if op A completed before op B
       was invoked, then cs(A) <= cs(B);
    2. replaying updates in carstamp order reproduces each RMW's read-value
       (each RMW observes the state left by its carstamp predecessor);
    3. every read returns the value of some update whose carstamp it
       returned, and reads respect real time the same way.
    """
    decided = check_log_agreement(cluster)

    per_key: Dict[int, List[dict]] = defaultdict(list)
    for h in cluster.history:
        per_key[h["key"]].append(h)
    decided_keys = {key for (key, _slot) in decided}

    for key in decided_keys | set(per_key):
        ops = per_key.get(key, [])
        completed_rmws = {h["rmw_id"]: h for h in ops
                          if h["kind"] == ReqKind.RMW}
        # The update sequence is the *decided log* (which includes RMWs
        # whose issuer crashed before completing) merged with completed
        # writes, ordered by carstamp.
        seq: List[Tuple[Carstamp, dict]] = []
        for (k, slot), (rmw_id, value, base) in decided.items():
            if k == key:
                seq.append((Carstamp(base, slot),
                            {"type": "rmw", "rmw_id": rmw_id,
                             "value": value}))
        completed_write_cs = set()
        for h in ops:
            if h["kind"] == ReqKind.WRITE:
                seq.append((h["carstamp"],
                            {"type": "write", "value": h["wval"]}))
                completed_write_cs.add(h["carstamp"])
        # "ghost" writes: phase-2 issued but never completed (issuer crashed
        # or restarted).  Their installs are observable, and their carstamp
        # is unique, so they linearize at it like any write.
        for m in cluster.machines:
            for (k, base, value) in m.write_log:
                cs = Carstamp(base, 0)
                if k == key and cs not in completed_write_cs:
                    seq.append((cs, {"type": "write", "value": value}))
        seq.sort(key=lambda e: e[0])
        # real-time order among *completed* updates
        updates = sorted(
            [h for h in ops if h["kind"] in (ReqKind.RMW, ReqKind.WRITE)],
            key=lambda h: h["carstamp"])
        _check_realtime(updates, key)
        # replay: value evolution in carstamp order
        value = 0
        values_at: Dict[Carstamp, int] = {CS_ZERO: 0}
        for cs, ev in seq:
            if ev["type"] == "write":
                value = ev["value"]
            else:
                h = completed_rmws.get(ev["rmw_id"])
                if h is not None:
                    # the client's read-value must be the state left by the
                    # carstamp predecessor
                    if h["value"] != value:
                        raise SafetyViolation(
                            f"key {key} RMW tag {ev['rmw_id']} read "
                            f"{h['value']} but carstamp-predecessor state "
                            f"is {value} (cs={cs})")
                    expect = apply_rmw(h["op"], value, h["arg1"], h["arg2"])
                    if expect != ev["value"]:
                        raise SafetyViolation(
                            f"key {key} RMW {ev['rmw_id']}: replay gives "
                            f"{expect}, log has {ev['value']}")
                value = ev["value"]
            values_at[cs] = value
        # (3) reads: value matches the update at the returned carstamp and
        # real-time holds vs updates and other reads.
        reads = [h for h in ops if h["kind"] == ReqKind.READ]
        for h in reads:
            cs = h["carstamp"]
            if cs not in values_at:
                raise SafetyViolation(
                    f"key {key}: read returned unknown carstamp {cs}")
            if values_at[cs] != h["value"]:
                raise SafetyViolation(
                    f"key {key}: read value {h['value']} != update value "
                    f"{values_at[cs]} at cs {cs}")
        everything = sorted(ops, key=lambda h: (h["carstamp"], h["invoke"]))
        _check_realtime(everything, key)


def _check_realtime(seq: List[dict], key: int) -> None:
    """``seq`` is sorted ascending by carstamp (the linearization order).

    Real-time requirement: if X completed before Y was invoked then X must
    linearize no later than Y.  Violation in the sorted sequence: some op B
    placed *after* A (cs(B) >= cs(A)) actually *completed before A was
    invoked* while having a strictly larger carstamp — i.e. the
    linearization puts B after A even though B finished first AND they are
    not allowed to commute.  Equivalently: walking the sorted list, the
    invoke time of each op must not exceed the completion time of any
    *later-cs* op.  We scan with a running minimum from the right.
    """
    n = len(seq)
    if n < 2:
        return
    # min completion time over suffix seq[i:] with strictly larger carstamp
    suffix_min = [float("inf")] * (n + 1)
    for i in range(n - 1, -1, -1):
        suffix_min[i] = min(suffix_min[i + 1], seq[i]["complete"])
    for i, a in enumerate(seq):
        j = i + 1
        # skip equal-carstamp ops (same linearization point: reads of one
        # update commute with each other)
        while j < n and seq[j]["carstamp"] == a["carstamp"]:
            j += 1
        if j < n and suffix_min[j] + 1e-9 < a["invoke"]:
            raise SafetyViolation(
                f"key {key}: real-time violation: an op with carstamp > "
                f"{a['carstamp']} completed at {suffix_min[j]} before this "
                f"op was invoked at {a['invoke']}")


def check_view_transitions(cluster: Cluster) -> None:
    """Reconfiguration safety over the decided config-register history.

    The config register's committed slots (plus ABD writes riding on its
    value plane — there are none in practice, view changes are RMW-only)
    are the total order of view changes.  Every consecutive value change
    must decode to a view, bump the epoch by exactly one, and differ from
    its predecessor by a single member — the transition rule quorum
    intersection rests on (see :mod:`repro_torch.reconfig.views`).
    """
    if not getattr(cluster.cfg, "reconfig", False):
        return
    from .types import CONFIG_KEY, View
    decided = check_log_agreement(cluster)
    slots = sorted(slot for (key, slot) in decided if key == CONFIG_KEY)
    values = [decided[(CONFIG_KEY, s)][1] for s in slots]
    prev = View.initial(cluster.cfg.n_machines)
    last_raw = None
    for raw in values:
        if raw == last_raw:
            continue                       # FETCH / lost-CAS slots: no-ops
        last_raw = raw
        view = View.decode(raw)
        if view is None:
            if raw == 0:
                continue                   # initial unset value
            raise SafetyViolation(f"undecodable view value {raw}")
        if view.epoch != prev.epoch + 1:
            raise SafetyViolation(
                f"view epoch jumped {prev.epoch} -> {view.epoch} "
                f"({prev.members} -> {view.members})")
        delta = set(view.members) ^ set(prev.members)
        if len(delta) != 1:
            raise SafetyViolation(
                f"view change {prev.members} -> {view.members} is not a "
                f"single-member delta")
        prev = view


def check_all(cluster: Cluster) -> None:
    check_log_agreement(cluster)
    check_exactly_once(cluster)
    check_log_prefix(cluster)
    check_registry_monotone(cluster)
    check_completed_rmws_decided(cluster)
    check_view_transitions(cluster)
    check_linearizable(cluster)
