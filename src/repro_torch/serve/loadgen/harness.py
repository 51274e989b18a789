"""OpenLoopHarness: seeded open-loop traffic against a simulated cluster.

Drives ``Cluster`` (scalar ``Machine`` or the batched serve path,
``Cluster(machine_cls=BatchedMachine)``) with a *virtual-time* open-loop
workload: arrivals happen at their scheduled tick whether or not earlier
ops finished (:mod:`.arrivals`), keys are Zipf-skewed over universes up to
millions of keys (:mod:`.zipf`), op classes follow a §2-style RMW/write/
read mix, and latency is recorded online per op class with steady-state
and fault windows kept separate (:mod:`.recorder`).

Faults run *through* the load: a :class:`FaultPlan` schedules crash/
restart and partition/heal events at virtual ticks using the existing
``sim.Network`` / ``Cluster`` knobs, and every event contributes a fault
window ``[t0, recovery + settle)`` so the recorder can attribute tail
latency to failures rather than smearing it into the steady-state
percentiles.

Everything is a pure function of the spec's seed: the arrival sequence,
the key stream, the op classes, the injection routing draws, and the
simulated network itself.  Running the same spec against the scalar and
the batched cluster therefore yields *identical completions* — the same
differential acceptance bar the serve path is tested against everywhere
else (``tests/test_open_loop.py`` pins this).

Measurement conventions (see ``docs/workloads.md`` for the full
methodology):

* latency = ``complete − arrival`` in virtual ticks, where *arrival* is
  the scheduled open-loop arrival time — injection rounding and all
  queueing (machine FIFO, ingest scheduler, network) land in the number;
* an op whose issuing session died in a crash never completes; it is
  counted in ``lost``, not silently dropped (offered = completed + lost
  after quiescence);
* queue-depth and scheduler-aging gauges are sampled every
  ``sample_every`` ticks into a :class:`~.recorder.GaugeLog` (batched
  clusters additionally expose ``IngestScheduler.gauges``).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Tuple

from repro_torch.core.node import Machine, ProtocolConfig, ReqKind, Request
from repro_torch.core.sim import Cluster, NetConfig
from repro_torch.core.types import RmwOp

from .arrivals import MIXES, ArrivalPhase, OpMix, arrival_times
from .recorder import OP_CLASS, GaugeLog, LatencyRecorder
from .zipf import ZipfKeys


# ---------------------------------------------------------------------------
# fault scheduling
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultEvent:
    at: float
    action: str                       # "crash" | "restart" | "partition" | "heal"
    mid: int = -1
    groups: Tuple[Tuple[int, ...], Tuple[int, ...]] = ((), ())


class FaultPlan:
    """Crash/restart and partition/heal events plus their fault windows.

    ``settle`` extends each window past the recovery event: completions
    that were queued or retried *because of* the fault keep landing for a
    while after the network heals or the machine returns, and those
    belong to the fault tail, not the steady state.
    """

    def __init__(self, settle: float = 50.0):
        self.settle = settle
        self.events: List[FaultEvent] = []
        self.windows: List[Tuple[float, float]] = []

    def crash_restart(self, mid: int, at: float,
                      down_for: float) -> "FaultPlan":
        """Crash ``mid`` at tick ``at``; restart it ``down_for`` later."""
        self.events.append(FaultEvent(at, "crash", mid=mid))
        self.events.append(FaultEvent(at + down_for, "restart", mid=mid))
        self.windows.append((at, at + down_for + self.settle))
        return self

    def crash(self, mid: int, at: float) -> "FaultPlan":
        """Crash ``mid`` at ``at`` with no restart (window extends to the
        end of time: the deployment is degraded from here on)."""
        self.events.append(FaultEvent(at, "crash", mid=mid))
        self.windows.append((at, float("inf")))
        return self

    def partition(self, at: float, heal_at: float, group_a, group_b
                  ) -> "FaultPlan":
        """Partition ``group_a`` from ``group_b`` during ``[at, heal_at)``.

        ``Network.heal`` clears *every* active partition, so overlapping
        partition windows heal together — schedule them disjoint."""
        if heal_at <= at:
            raise ValueError(f"heal {heal_at} not after partition {at}")
        self.events.append(FaultEvent(
            at, "partition", groups=(tuple(group_a), tuple(group_b))))
        self.events.append(FaultEvent(heal_at, "heal"))
        self.windows.append((at, heal_at + self.settle))
        return self

    def sorted_events(self) -> List[FaultEvent]:
        return sorted(self.events, key=lambda e: e.at)


# ---------------------------------------------------------------------------
# the workload spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpenLoopSpec:
    """Everything that determines an open-loop run, seed included."""

    seed: int = 0
    n_machines: int = 5
    sessions: int = 8
    n_keys: int = 1024                  # key-universe size (millions OK for
    zipf_s: float = 0.99                # the scalar cluster; see workloads.md)
    key_base: int = 0
    mix: OpMix = MIXES["kv_mixed"]
    phases: Tuple[ArrivalPhase, ...] = (ArrivalPhase(rate=0.5, ticks=240),)
    all_aboard: bool = False
    reconfig: bool = False
    # network knobs (defaults: the sim's uniform 1–3 tick delay)
    min_delay: float = 1.0
    max_delay: float = 3.0
    drop_prob: float = 0.0
    dup_prob: float = 0.0
    heavy_tail_prob: float = 0.0
    heavy_tail_extra: float = 50.0
    # observability
    sub_bits: int = 7                   # sketch resolution (see sketch.py)
    sample_every: int = 10              # gauge sampling period, ticks

    def __post_init__(self):
        if self.reconfig and self.key_base < 1:
            raise ValueError("reconfig deployments reserve key 0 for the "
                             "config register: set key_base >= 1")

    def protocol_config(self) -> ProtocolConfig:
        return ProtocolConfig(n_machines=self.n_machines,
                              sessions_per_machine=self.sessions,
                              all_aboard=self.all_aboard,
                              reconfig=self.reconfig)

    def net_config(self) -> NetConfig:
        return NetConfig(seed=self.seed, min_delay=self.min_delay,
                         max_delay=self.max_delay, drop_prob=self.drop_prob,
                         dup_prob=self.dup_prob,
                         heavy_tail_prob=self.heavy_tail_prob,
                         heavy_tail_extra=self.heavy_tail_extra)


@dataclasses.dataclass
class OpenLoopResult:
    """A finished run: the cluster (for checkers), the recorder, gauges,
    and the accounting the bench lanes report."""

    cluster: Cluster
    recorder: LatencyRecorder
    gauges: GaugeLog
    offered: int
    completed: int
    lost: int
    ticks: int
    load_ticks: float                   # arrival-phase span
    offered_by_class: Dict[str, int]

    def lane(self) -> dict:
        """The JSON row the ``open_loop`` bench lane is built from."""
        return {
            "offered": self.offered, "completed": self.completed,
            "lost": self.lost, "ticks": self.ticks,
            "offered_ops_per_tick": round(
                self.offered / max(self.load_ticks, 1e-9), 4),
            "achieved_ops_per_tick": round(
                self.completed / max(self.ticks, 1), 4),
            "offered_by_class": dict(self.offered_by_class),
            "windows": self.recorder.report(),
            "gauges": self.gauges.summary(),
        }


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

class OpenLoopHarness:
    """Build a cluster from a spec and drive the open-loop workload
    through it, faults and all."""

    def __init__(self, spec: OpenLoopSpec, machine_cls: type = Machine,
                 faults: Optional[FaultPlan] = None, obs=None):
        self.spec = spec
        self.machine_cls = machine_cls
        self.faults = faults or FaultPlan()
        # optional repro_torch.obs.FlightRecorder, attached to the cluster
        # before any traffic so path counters reconcile with completions
        self.obs = obs
        # The whole op sequence is precomputed from dedicated seeded
        # streams (arrival times, keys, classes/values, routing): pure in
        # the spec, identical across machine implementations.
        self._times = arrival_times(spec.phases, spec.seed)
        zipf = ZipfKeys(spec.n_keys, spec.zipf_s, seed=spec.seed,
                        key_base=spec.key_base)
        oprng = random.Random(f"ops:{spec.seed}")
        self._ops: List[Request] = []
        for _t in self._times:
            kind = spec.mix.draw(oprng)
            key = zipf.draw()
            if kind == ReqKind.RMW:
                req = Request(ReqKind.RMW, key, op=RmwOp.FAA, arg1=1)
            elif kind == ReqKind.WRITE:
                req = Request(ReqKind.WRITE, key,
                              value=oprng.randrange(1, 10_000))
            else:
                req = Request(ReqKind.READ, key)
            self._ops.append(req)
        self._route_rng = random.Random(f"route:{spec.seed}")

    # -- internals ------------------------------------------------------------

    def _eligible_mids(self, cluster: Cluster) -> List[int]:
        members = set(cluster.active_view.members)
        return [m.mid for m in cluster.machines
                if m.alive and not m.retired and not m.syncing
                and m.mid in members]

    def _apply_fault(self, cluster: Cluster, ev: FaultEvent) -> None:
        if ev.action == "crash":
            cluster.crash(ev.mid)
        elif ev.action == "restart":
            cluster.restart(ev.mid)
        elif ev.action == "partition":
            cluster.network.partition(*ev.groups)
        elif ev.action == "heal":
            cluster.network.heal()
        else:                                    # pragma: no cover
            raise ValueError(f"unknown fault action {ev.action!r}")

    def _sample_gauges(self, cluster: Cluster, log: GaugeLog) -> None:
        live = [m for m in cluster.machines if m.alive and not m.retired]
        log.sample("client_fifo_depth",
                   sum(len(f) for m in live for f in m.fifos))
        log.sample("inbox_depth", sum(len(m.inbox) for m in live))
        log.sample("net_pending", cluster.network.pending())
        log.sample("inflight", len(cluster._inflight))
        scheds = [m.ingest for m in cluster.machines
                  if hasattr(m, "ingest")]
        if scheds:
            gs = [s.gauges() for s in scheds]
            log.sample("sched_queue_depth",
                       sum(g["queue_depth"] for g in gs))
            log.sample("sched_keys_backlogged",
                       sum(g["keys_backlogged"] for g in gs))
            log.sample("sched_oldest_age",
                       max(g["oldest_age"] for g in gs))

    # -- driving --------------------------------------------------------------

    def run(self, max_ticks: int = 200_000, extra: int = 50,
            check: bool = True) -> OpenLoopResult:
        """Drive the workload to quiescence; raises ``RuntimeError`` when
        the cluster cannot drain within ``max_ticks``.  ``check=True``
        runs every safety checker on the final cluster (linearizability
        included) before returning."""
        spec = self.spec
        cluster = Cluster(spec.protocol_config(), spec.net_config(),
                          machine_cls=self.machine_cls)
        if self.obs is not None:
            cluster.attach_obs(self.obs)
        recorder = LatencyRecorder(self.faults.windows,
                                   sub_bits=spec.sub_bits)
        gauges = GaugeLog()
        events = self.faults.sorted_events()
        arrival_of: Dict[int, float] = {}        # tag -> scheduled arrival
        offered_by_class = {c: 0 for c in OP_CLASS.values()}
        ei = ai = 0
        offered = 0
        hist_cursor = 0
        quiet = 0
        load_ticks = sum(ph.ticks for ph in spec.phases)
        for tick in range(max_ticks):
            now = cluster.network.now
            while ei < len(events) and events[ei].at <= now:
                self._apply_fault(cluster, events[ei])
                ei += 1
            if ai < len(self._times) and self._times[ai] <= now:
                eligible = self._eligible_mids(cluster)
                # no live member to take traffic: hold the arrivals (the
                # client keeps retrying; queueing delay keeps accruing
                # against the scheduled arrival time)
                if eligible:
                    rng = self._route_rng
                    while (ai < len(self._times)
                           and self._times[ai] <= now):
                        req = self._ops[ai]
                        mid = eligible[rng.randrange(len(eligible))]
                        sess = rng.randrange(spec.sessions)
                        tag = cluster.submit(mid, sess, req)
                        arrival_of[tag] = self._times[ai]
                        offered_by_class[OP_CLASS[req.kind]] += 1
                        offered += 1
                        ai += 1
            cluster.step()
            hist = cluster.history
            while hist_cursor < len(hist):
                h = hist[hist_cursor]
                # latency is measured from the *scheduled arrival*, not
                # the submit tick: injection rounding is queueing delay
                t_arr = arrival_of.get(h.get("tag", -1), h["invoke"])
                recorder.observe({"kind": h["kind"], "invoke": t_arr,
                                  "complete": h["complete"]})
                hist_cursor += 1
            if tick % spec.sample_every == 0:
                self._sample_gauges(cluster, gauges)
            if ai >= len(self._times) and ei >= len(events):
                busy = any(
                    (not m.session_idle(s)) or m.fifos[s]
                    for m in cluster.machines
                    if m.alive and not m.retired
                    for s in range(spec.sessions))
                busy = busy or any(m.alive and m.syncing and not m.retired
                                   for m in cluster.machines)
                busy = busy or any(m.inbox for m in cluster.machines
                                   if m.alive)
                if not busy and not cluster.network.pending():
                    quiet += 1
                    if quiet >= extra:
                        break
                else:
                    quiet = 0
        else:
            raise RuntimeError(
                f"open-loop run did not quiesce within {max_ticks} ticks "
                f"(seed {spec.seed}: {offered} offered, "
                f"{len(cluster.history)} completed)")
        completed = len(cluster.history)
        result = OpenLoopResult(
            cluster=cluster, recorder=recorder, gauges=gauges,
            offered=offered, completed=completed,
            lost=offered - completed, ticks=cluster.rounds,
            load_ticks=load_ticks, offered_by_class=offered_by_class)
        if check:
            from repro_torch.core import checkers
            try:
                checkers.check_all(cluster)
            except checkers.SafetyViolation as exc:
                if self.obs is not None:
                    self.obs.note("checker_failure", cluster.network.now,
                                  error=str(exc))
                raise
        return result
