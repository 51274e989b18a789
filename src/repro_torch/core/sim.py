"""Deterministic discrete-event simulator for the asynchronous network model.

The paper assumes machines can crash (crash-stop) and that processing and
networking delays are unbounded (§1).  This module provides exactly that
environment, deterministically seeded, so safety properties can be
property-tested under adversarial schedules:

* per-message random delay (optionally heavy-tailed),
* message drops, duplication and reordering,
* crash-stop failures and (for elastic-membership experiments) rejoins with
  cleared volatile state,
* network partitions.

``Cluster`` wires :class:`repro_torch.core.node.Machine` replicas onto the
simulated network and exposes a small synchronous driver API used by the
tests, the benchmarks and the :mod:`repro_torch.coord` facade.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import random
from typing import Dict, List, Optional, Sequence, Tuple

from .node import (
    RECONFIG_NOT_PORTED, Completion, Machine, ProtocolConfig, ReqKind, Request,
)
from .proposer import PauseEvent
from .types import Msg, MsgKind, RmwOp, View

# control-plane kinds delivered even to machines outside the active view:
# VIEW is how a removed/lagging machine learns the membership it is not in;
# SYNC is how a joiner (not yet heard of by every member) gets its snapshot.
_VIEW_EXEMPT_KINDS = (MsgKind.VIEW, MsgKind.SYNC)


@dataclasses.dataclass
class NetConfig:
    """Fault-injection knobs for the simulated network."""

    seed: int = 0
    min_delay: float = 1.0
    max_delay: float = 3.0
    drop_prob: float = 0.0
    dup_prob: float = 0.0
    # With probability heavy_tail_prob a message is delayed by an extra
    # uniform(0, heavy_tail_extra) — models stragglers / unbounded delays.
    heavy_tail_prob: float = 0.0
    heavy_tail_extra: float = 50.0


class Network:
    """Event-heap message transport with drops/dups/reorder/partitions."""

    def __init__(self, cfg: NetConfig, n: int):
        self.cfg = cfg
        self.rng = random.Random(cfg.seed)
        self.n = n
        self.heap: List[Tuple[float, int, int, object]] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.partitioned: set = set()          # frozenset pairs that can't talk
        # the active view's member set (Cluster keeps it in sync): messages
        # addressed outside it are dropped like any unreachable destination
        self.members: set = set(range(n))
        # fault accounting: ``dropped`` is the umbrella (every message
        # that left the heap — or never entered it — without reaching an
        # inbox); ``removed_dst``/``crashed_dst`` attribute the delivery-
        # time drop causes; ``duplicated``/``heavy_tail`` count the fault
        # model's extra-copy and straggler-delay draws.  Conservation
        # (:meth:`conservation`): sent + duplicated ==
        # delivered + dropped + pending.
        self.stats = {"sent": 0, "dropped": 0, "duplicated": 0,
                      "delivered": 0, "removed_dst": 0, "crashed_dst": 0,
                      "heavy_tail": 0}

    def partition(self, group_a: Sequence[int], group_b: Sequence[int]) -> None:
        for a in group_a:
            for b in group_b:
                self.partitioned.add(frozenset((a, b)))

    def heal(self) -> None:
        self.partitioned.clear()

    def send(self, src: int, dst: int, payload: object) -> None:
        self.stats["sent"] += 1
        if frozenset((src, dst)) in self.partitioned:
            self.stats["dropped"] += 1
            return
        if self.rng.random() < self.cfg.drop_prob:
            self.stats["dropped"] += 1
            return
        copies = 2 if self.rng.random() < self.cfg.dup_prob else 1
        if copies == 2:
            self.stats["duplicated"] += 1
        for _ in range(copies):
            delay = self.rng.uniform(self.cfg.min_delay, self.cfg.max_delay)
            if self.rng.random() < self.cfg.heavy_tail_prob:
                delay += self.rng.uniform(0.0, self.cfg.heavy_tail_extra)
                self.stats["heavy_tail"] += 1
            heapq.heappush(self.heap,
                           (self.now + delay, next(self._seq), dst, payload))

    def deliver_due(self, until: float,
                    machines: Sequence[Machine]) -> int:
        """Deliver every message with arrival time <= until.

        A message addressed to a crashed machine is *dropped*, not
        delivered: ``Machine.deliver`` discards it anyway (crash-stop), so
        counting it as delivered would make ``delivered`` disagree with the
        number of messages that actually reached an inbox.

        A message addressed to a machine *outside the active view* is also
        dropped — a distinct case from crashed-dst (the process may be
        running, but the membership no longer routes to it), counted
        separately in ``removed_dst``.  VIEW/SYNC control messages are
        exempt: they are the catch-up plane for exactly those machines.
        """
        delivered = 0
        while self.heap and self.heap[0][0] <= until:
            t, _, dst, payload = heapq.heappop(self.heap)
            if dst >= len(machines) or (
                    dst not in self.members
                    and not (isinstance(payload, Msg)
                             and payload.kind in _VIEW_EXEMPT_KINDS)):
                self.stats["dropped"] += 1
                self.stats["removed_dst"] += 1
                continue
            if not machines[dst].alive:
                self.stats["dropped"] += 1
                self.stats["crashed_dst"] += 1
                continue
            machines[dst].deliver(payload)
            delivered += 1
        self.stats["delivered"] += delivered
        self.now = until
        return delivered

    def pending(self) -> int:
        return len(self.heap)

    def conservation(self) -> Dict[str, int]:
        """Message conservation terms: every sent message (plus every
        duplicate copy the fault model minted) is exactly one of
        delivered, dropped, or still in flight.  ``balance`` is 0 iff the
        books square — asserted at quiescence by ``tests/test_faults.py``.
        """
        s = self.stats
        return {
            "sent": s["sent"], "duplicated": s["duplicated"],
            "delivered": s["delivered"], "dropped": s["dropped"],
            "in_flight": len(self.heap),
            "balance": (s["sent"] + s["duplicated"]
                        - s["delivered"] - s["dropped"] - len(self.heap)),
        }


class Cluster:
    """A replicated RMW-register deployment on the simulated network.

    Drives the worker loop of every machine in lockstep rounds: each round
    advances simulated time by one tick, delivers due messages, then steps
    every live machine once (§3.1.3 while(true) iteration).
    """

    def __init__(self, cfg: Optional[ProtocolConfig] = None,
                 net: Optional[NetConfig] = None,
                 machine_cls: type = Machine):
        self.cfg = cfg or ProtocolConfig()
        self.netcfg = net or NetConfig()
        self.network = Network(self.netcfg, self.cfg.n_machines)
        # machine_cls is any Machine-interface replica implementation; the
        # batched serve path plugs in repro_torch.serve.paxos.BatchedMachine here.
        self.machine_cls = machine_cls
        self.machines: List[Machine] = [
            machine_cls(mid, self.cfg, self.network.send,
                        lambda: self.network.now)
            for mid in range(self.cfg.n_machines)
        ]
        # Fused serve path (duck-typed, no core -> serve import): when the
        # machine class provides attach_engine (repro_torch.serve.paxos), the
        # whole cluster ticks as one device-resident fused engine instead
        # of N sequential per-machine steps.
        attach = (getattr(self.machines[0], "attach_engine", None)
                  if self.machines else None)
        self.engine = attach(self.machines) if attach is not None else None
        self.completions: List[Tuple[int, int, Completion]] = []  # (mid, sess, c)
        # global-time intervals for the linearizability checker:
        # (key, kind, invoke_t, complete_t, value_read, value_written, rmw_id)
        self.history: List[dict] = []
        self._inflight: Dict[int, dict] = {}
        self._tag = itertools.count(1)
        self.rounds = 0

    def enable_msg_trace(self) -> None:
        """Record every receiver-side protocol message, per machine and in
        processing order, for the differential trace-replay harness
        (:mod:`repro_torch.core.replay`).  Traces survive :meth:`restart`."""
        for m in self.machines:
            if m.msg_trace is None:
                m.msg_trace = []

    def enable_issuer_trace(self) -> None:
        """Record every issuer-side event (round starts, steered replies,
        decisions, pauses — see :mod:`repro_torch.core.proposer`), per machine
        and in processing order, for the differential *proposer* replay
        (:mod:`repro_torch.core.replay`).  Traces survive :meth:`restart`."""
        for m in self.machines:
            if m.issuer_trace is None:
                m.issuer_trace = []

    def attach_obs(self, recorder) -> "Cluster":
        """Wire a :class:`repro_torch.obs.FlightRecorder` through the cluster
        (every machine, the network, the fused engine).  Duck-typed so
        core carries no obs import; survives :meth:`restart` /
        :meth:`add_machine` via the ``obs`` carry-over there.  Attach
        before submitting work — the recorder's path counters reconcile
        with the completion history only for ops it saw start."""
        recorder.attach(self)
        return self

    # -- client API ----------------------------------------------------------

    def submit(self, mid: int, sess: int, req: Request) -> int:
        """Enqueue a client request; returns the tag for history matching."""
        tag = next(self._tag)
        req.tag = tag
        self._inflight[tag] = {
            "tag": tag,
            "key": req.key, "kind": req.kind, "mid": mid, "sess": sess,
            "invoke": self.network.now, "op": req.op,
            "arg1": req.arg1, "arg2": req.arg2, "wval": req.value,
        }
        self.machines[mid].submit(sess, req)
        return tag

    def rmw(self, mid: int, sess: int, key: int, op: RmwOp = RmwOp.FAA,
            arg1: int = 1, arg2: int = 0) -> int:
        return self.submit(mid, sess, Request(ReqKind.RMW, key, op=op,
                                              arg1=arg1, arg2=arg2))

    def write(self, mid: int, sess: int, key: int, value: int) -> int:
        return self.submit(mid, sess, Request(ReqKind.WRITE, key, value=value))

    def read(self, mid: int, sess: int, key: int) -> int:
        return self.submit(mid, sess, Request(ReqKind.READ, key))

    def crash(self, mid: int) -> None:
        self.machines[mid].crash()

    # -- membership ----------------------------------------------------------

    @property
    def active_view(self) -> View:
        """Highest-epoch view installed by any live machine."""
        best = View.initial(self.cfg.n_machines)
        for m in self.machines:
            if m.view.epoch > best.epoch:
                best = m.view
        return best

    def _sync_view(self) -> None:
        """Keep ``network.members`` aligned with the active view.

        The network models the routing layer: once a view change commits
        somewhere, traffic to machines outside it is undeliverable (the
        removed-dst drop in :meth:`Network.deliver_due`), while machines
        that haven't installed the view yet keep running until fenced.
        """
        self.network.members = set(self.active_view.members)

    def add_machine(self, mid: int, *, syncing: bool = True) -> Machine:
        """Spawn (or respawn) machine ``mid`` so a view that includes it can
        route to it.  The new machine starts in catch-up mode: it JOIN_REQs
        a snapshot from the current members and does not vote until the
        snapshot is installed (``Machine.begin_catchup``).

        A *same-mid* rejoin is the same physical machine returning with
        its disk: acceptor state (KV metadata incl. promises, the rmw-id
        registry, commit/write logs) carries over exactly as in
        :meth:`restart` — discarding it could silently forget decided log
        slots whose only durable copies it held.  A never-before-seen mid
        starts empty and inherits a donor's log via the snapshot replay.
        """
        old = self.machines[mid] if mid < len(self.machines) else None
        if old is not None:
            incarnation = old.incarnation + 1
            traced_msgs = old.msg_trace is not None
            traced_issuer = old.issuer_trace is not None
        else:
            incarnation = 0
            traced_msgs = any(m.msg_trace is not None for m in self.machines)
            traced_issuer = any(m.issuer_trace is not None
                                for m in self.machines)
        fresh = self.machine_cls(mid, self.cfg, self.network.send,
                                 lambda: self.network.now,
                                 incarnation=incarnation,
                                 view=self.active_view)
        if old is not None:
            fresh.kvs = old.kvs
            fresh.registry = old.registry
            fresh.write_clock = old.write_clock
            fresh.commit_log = old.commit_log
            fresh.write_log = old.write_log
        if traced_msgs:
            fresh.msg_trace = []
        if traced_issuer:
            fresh.issuer_trace = []
        obs = (old.obs if old is not None
               else next((m.obs for m in self.machines
                          if m.obs is not None), None))
        if obs is not None:
            obs.adopt(fresh)
        if syncing:
            fresh.begin_catchup()
        while len(self.machines) <= mid:
            self.machines.append(fresh)  # placeholder overwritten below
        self.machines[mid] = fresh
        if self.engine is not None:
            # (re)load exactly this machine's row of the stacked planes —
            # the rest of the cluster keeps its device residency
            self.engine.adopt(fresh)
        return fresh

    def join(self, mid: Optional[int] = None, *,
             max_ticks: int = 200_000) -> int:
        """Add a machine to the membership via a CP-decided view change."""
        raise NotImplementedError(f"Cluster.join: {RECONFIG_NOT_PORTED}")

    def leave(self, mid: int, *, max_ticks: int = 200_000) -> None:
        """Remove a machine from the membership via a CP view change."""
        raise NotImplementedError(f"Cluster.leave: {RECONFIG_NOT_PORTED}")

    def restart(self, mid: int) -> None:
        """Crash-recover from stable storage.

        Acceptor state (KV-pair metadata incl. promises, the rmw-id
        registry, the write clock) is modeled as persistent — losing it
        would break quorum intersection, which is why real deployments
        either persist it or rejoin as a *new* member.  Volatile state
        (sessions, local entries, in-flight tallies, inbox) is lost: those
        clients time out.  The new incarnation's rmw-ids must not collide
        with the old one's (the registry would otherwise suppress them as
        already committed).
        """
        old = self.machines[mid]
        fresh = self.machine_cls(mid, self.cfg, self.network.send,
                                 lambda: self.network.now,
                                 incarnation=old.incarnation + 1,
                                 view=old.view)
        fresh.retired = old.retired
        if old.syncing:
            # snapshot never arrived before the crash: ask again
            fresh.begin_catchup()
        fresh.kvs = old.kvs
        fresh.registry = old.registry
        fresh.write_clock = old.write_clock
        fresh.commit_log = old.commit_log
        fresh.write_log = old.write_log
        fresh.msg_trace = old.msg_trace
        fresh.issuer_trace = old.issuer_trace
        if old.obs is not None:
            old.obs.adopt(fresh)
        if fresh.issuer_trace is not None:
            # volatile issuer state (sessions, tallies) died with the old
            # incarnation: park every lane so the proposer replay drops
            # stale-round replies exactly like the restarted machine does.
            for s in range(self.cfg.sessions_per_machine):
                fresh.issuer_trace.append(PauseEvent(s, 0))
                fresh.issuer_trace.append(PauseEvent(s, 1))
        self.machines[mid] = fresh
        if self.engine is not None:
            # evict the dead incarnation's issuer row (volatile proposer
            # state resets to defaults) while the durable KV row — carried
            # by the shared bridge — stays resident untouched
            self.engine.adopt(fresh)

    # -- driving -------------------------------------------------------------

    def step(self, ticks: int = 1) -> None:
        for _ in range(ticks):
            self.rounds += 1
            self.network.deliver_due(self.network.now + 1.0, self.machines)
            if self.engine is not None:
                # fused tick: every machine's generator driven in waves,
                # sends flushed in mid order (same global send sequence —
                # and hence the same network RNG stream — as the
                # sequential loop below)
                self.engine.step_all(self.machines, self.network.send)
            else:
                for m in self.machines:
                    m.step()
            # completions drain in mid order either way (the sequential
            # loop drains machine i before stepping i+1, and steps never
            # couple within a tick, so the order is identical)
            for m in self.machines:
                for sess, comp in m.completions:
                    self._complete(m.mid, sess, comp)
                m.completions.clear()
            if self.cfg.reconfig:
                self._sync_view()

    def _complete(self, mid: int, sess: int, comp: Completion) -> None:
        self.completions.append((mid, sess, comp))
        info = self._inflight.pop(comp.tag, None)
        if info is not None:
            info.update(complete=self.network.now, value=comp.value,
                        carstamp=comp.carstamp, rmw_id=comp.rmw_id)
            self.history.append(info)

    def run_until_quiet(self, max_ticks: int = 20_000,
                        extra: int = 50) -> bool:
        """Step until no session has in-flight work; returns success."""
        quiet = 0
        for _ in range(max_ticks):
            self.step()
            busy = any(not m.session_idle(s)
                       for m in self.machines if m.alive and not m.retired
                       for s in range(self.cfg.sessions_per_machine))
            busy = busy or any(m.alive and m.syncing and not m.retired
                               for m in self.machines)
            if not busy and not self.network.pending():
                quiet += 1
                if quiet >= extra:
                    return True
            else:
                quiet = 0
        return False

    # -- aggregate stats -----------------------------------------------------

    def stats(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for m in self.machines:
            for k, v in m.stats.items():
                out[k] = out.get(k, 0) + v
        out.update({f"net_{k}": v for k, v in self.network.stats.items()})
        view = self.active_view
        out["view_epoch"] = view.epoch
        out["view_members"] = view.n
        out["machines_retired"] = sum(1 for m in self.machines if m.retired)
        out["machines_syncing"] = sum(1 for m in self.machines
                                      if m.alive and m.syncing)
        return out


def completion_tuples(cluster: Cluster) -> List[Tuple]:
    """Full-fidelity completion projection, in completion order.

    THE equivalence gate for alternative Machine implementations: two
    clusters are "completion-for-completion identical" iff these lists are
    equal (same machines, sessions, tags, op kinds, keys, read values,
    commit carstamps and rmw-ids, in the same order).  Single definition so
    every gate — tests, benches, scripts/batched_smoke.py — compares the
    whole completion, not a stale subset.
    """
    return [(mid, sess, c.tag, c.kind, c.key, c.value, c.carstamp, c.rmw_id)
            for mid, sess, c in cluster.completions]


def workload(cluster: Cluster, *, n_ops: int, keys: int,
             rmw_frac: float = 1.0, write_frac: float = 0.0,
             seed: int = 0, op: RmwOp = RmwOp.FAA,
             cas_mode: bool = False, key_base: int = 0,
             mids: Optional[Sequence[int]] = None) -> List[int]:
    """Feed a mixed open-loop workload round-robin over machines/sessions.

    ``key_base`` offsets the key range (reconfig deployments reserve key 0
    for the config register); ``mids`` restricts the round-robin to a
    subset of machines (e.g. the active view's members).
    """
    rng = random.Random(seed)
    cfg = cluster.cfg
    pool = list(mids) if mids is not None else list(range(cfg.n_machines))
    tags = []
    for i in range(n_ops):
        mid = pool[i % len(pool)]
        sess = (i // len(pool)) % cfg.sessions_per_machine
        key = key_base + rng.randrange(keys)
        r = rng.random()
        if r < rmw_frac:
            if cas_mode:
                tags.append(cluster.rmw(mid, sess, key, RmwOp.CAS,
                                        arg1=rng.randrange(4),
                                        arg2=rng.randrange(1000)))
            else:
                tags.append(cluster.rmw(mid, sess, key, op, arg1=1))
        elif r < rmw_frac + write_frac:
            tags.append(cluster.write(mid, sess, key, rng.randrange(10_000)))
        else:
            tags.append(cluster.read(mid, sess, key))
    return tags
