"""Virtual-time span tracer + bounded flight-recorder ring buffer.

One :class:`FlightRecorder` serves a whole cluster.  Machines call into it
from the protocol hook sites in :mod:`repro_torch.core.node` (guarded by
``if self.obs is not None`` — the same ``Optional`` tap idiom as
``msg_trace``/``issuer_trace``, so the default configuration pays nothing).
All timestamps are **virtual ticks** (``Network.now``), never wall clock:
a dump is a pure function of (seed, spec, mode), which is what makes the
byte-identical determinism tests possible.

Per-op **path classification** follows the paper's taxonomy:

* ``abd_read`` / ``abd_write`` — §10–§11 register ops (a read that needed
  the §11 write-back commit round still classifies ``abd_read``; the
  ``read_write_back`` event on the span records the slow read);
* ``all_aboard_fast`` — an RMW that attempted the §9 fast path and was
  never steered onto the classic machinery (no propose round, no retry,
  no helping);
* ``cp_slow`` — every other RMW: classic proposes, retries, steals,
  helping, or an all-aboard attempt that fell back (§9.2);
* ``aborted`` — an op whose issuing machine crashed before completion
  (recorded in the ring, **not** counted in the path counters — path
  counters reconcile exactly with the cluster completion history).

**Exactness vs sampling.**  Path counters, event counters and quorum-wait
tick counters are exact whenever a recorder is attached, independent of
mode.  What the mode governs is *ring recording*: ``full`` records every
span, ``sampled`` every ``sample_every``-th op (deterministically, by
admission order), ``off`` records none — counters stay exact either way.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional

from .registry import MetricsRegistry

# Path taxonomy (keep in sync with docs/observability.md)
PATHS = ("abd_read", "abd_write", "all_aboard_fast", "cp_slow")
ABORTED = "aborted"

_KIND_TO_ABD_PATH = {"write": "abd_write", "read": "abd_read"}


class Span:
    """One op's lifecycle: begin at admission, end at completion/abort.

    Created for *every* op while a recorder is attached (it carries the
    path-classification flags the exact counters need); appended to the
    ring only when ``rec`` is set (sampling decision at begin time).
    """

    __slots__ = ("mid", "sess", "kind", "key", "tag", "start", "rec",
                 "events", "aboard", "classic", "retries", "steals",
                 "helps", "wait_ticks", "end", "path")

    def __init__(self, mid: int, sess: int, kind: str, key: int, tag: int,
                 start: float, rec: bool):
        self.mid = mid
        self.sess = sess
        self.kind = kind
        self.key = key
        self.tag = tag
        self.start = start
        self.rec = rec
        self.events: List = [] if rec else None
        self.aboard = False
        self.classic = False
        self.retries = 0
        self.steals = 0
        self.helps = 0
        self.wait_ticks = 0
        self.end = -1.0
        self.path = ""

    def to_record(self) -> dict:
        return {
            "type": "span", "kind": self.kind, "path": self.path,
            "mid": self.mid, "sess": self.sess, "key": self.key,
            "tag": self.tag, "start": self.start, "end": self.end,
            "dur": (self.end - self.start) if self.end >= 0 else -1.0,
            "aboard": int(self.aboard), "retries": self.retries,
            "steals": self.steals, "helps": self.helps,
            "wait_ticks": self.wait_ticks,
            "events": [[t, name] for t, name in (self.events or [])],
        }


class FlightRecorder:
    """Cluster-wide tracer: exact counters + a bounded ring of spans.

    Parameters
    ----------
    mode:
        ``"off"`` | ``"sampled"`` | ``"full"`` — ring recording policy
        (counters are always exact while attached; see module docstring).
    sample_every:
        In ``sampled`` mode, record every N-th op's span (by global
        admission order — deterministic).
    capacity:
        Ring bound: only the most recent ``capacity`` records survive to
        a dump (postmortems care about the tail).
    meta:
        Run identity (seed, spec name, …) embedded in every dump header.
    """

    MODES = ("off", "sampled", "full")

    def __init__(self, mode: str = "sampled", *, sample_every: int = 16,
                 capacity: int = 4096,
                 registry: Optional[MetricsRegistry] = None,
                 meta: Optional[dict] = None):
        if mode not in self.MODES:
            raise ValueError(f"mode {mode!r} not in {self.MODES}")
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self.mode = mode
        self.sample_every = sample_every
        self.capacity = capacity
        self.registry = registry if registry is not None else MetricsRegistry()
        self.ring: Deque[dict] = deque(maxlen=capacity)
        self.meta = dict(meta or {})
        self._op_seq = 0
        self.network = None              # set by attach()
        self.engine = None
        self._machines: List = []

    # -- cluster wiring -------------------------------------------------------

    def attach(self, cluster) -> "FlightRecorder":
        """Wire this recorder through a :class:`repro_torch.core.sim.Cluster`:
        every machine's ``obs`` tap, the network stats, the fused engine
        (when present) and any per-machine ingest scheduler.  Attach
        *before* submitting work or the path counters cannot reconcile
        with the completion history.  Survives ``restart``/``add_machine``
        (the cluster re-adopts replacement machines)."""
        self.network = cluster.network
        self.engine = getattr(cluster, "engine", None)
        for m in cluster.machines:
            self.adopt(m)
        return self

    def adopt(self, machine) -> None:
        """Per-machine wiring (also called by the cluster when a machine
        is restarted or re-added, via the ``obs`` carry-over)."""
        machine.obs = self
        if machine not in self._machines:
            self._machines.append(machine)
        sched = getattr(machine, "ingest", None)
        if sched is not None and hasattr(sched, "bind_metrics"):
            sched.bind_metrics(self.registry, f"ingest.m{machine.mid}")

    # -- op lifecycle (called from repro_torch.core.node hook sites) ----------------

    def op_begin(self, mid: int, sess: int, kind: str, key: int, tag: int,
                 t: float) -> Span:
        self._op_seq += 1
        rec = (self.mode == "full"
               or (self.mode == "sampled"
                   and self._op_seq % self.sample_every == 1))
        self.registry.inc("ops.started." + kind)
        sp = Span(mid, sess, kind, key, tag, t, rec)
        if rec:
            sp.events.append((t, "start"))
        return sp

    def op_event(self, sp: Optional[Span], t: float, name: str) -> None:
        """A protocol event inside an op's lifetime.  ``sp`` may be None
        (op started before this recorder was attached): still counted."""
        self.registry.inc("evt." + name)
        if sp is not None and sp.rec:
            sp.events.append((t, name))

    def rmw_aboard(self, sp: Optional[Span], t: float) -> None:
        if sp is not None:
            sp.aboard = True
        self.op_event(sp, t, "all_aboard_attempt")

    def rmw_classic(self, sp: Optional[Span], t: float,
                    name: str = "propose") -> None:
        if sp is not None:
            sp.classic = True
        self.op_event(sp, t, name)

    def rmw_retry(self, sp: Optional[Span], t: float) -> None:
        if sp is not None:
            sp.classic = True
            sp.retries += 1
        self.op_event(sp, t, "retry")

    def rmw_steal(self, sp: Optional[Span], t: float) -> None:
        if sp is not None:
            sp.classic = True
            sp.steals += 1
        self.op_event(sp, t, "steal")

    def rmw_help(self, sp: Optional[Span], t: float,
                 name: str = "help") -> None:
        if sp is not None:
            sp.classic = True
            sp.helps += 1
        self.op_event(sp, t, name)

    def quorum_wait(self, sp: Optional[Span]) -> None:
        """One inspection tick spent waiting on a quorum (too chatty for
        the ring: counted on the span and in the aggregate counter)."""
        self.registry.inc("evt.quorum_wait_ticks")
        if sp is not None:
            sp.wait_ticks += 1

    def rmw_end(self, sp: Optional[Span], t: float) -> None:
        if sp is None:
            return
        path = ("all_aboard_fast" if sp.aboard and not sp.classic
                else "cp_slow")
        self._finish(sp, t, path)

    def abd_end(self, sp: Optional[Span], t: float) -> None:
        if sp is None:
            return
        self._finish(sp, t, _KIND_TO_ABD_PATH[sp.kind])

    def _finish(self, sp: Span, t: float, path: str) -> None:
        sp.end = t
        sp.path = path
        self.registry.inc("path." + path)
        if sp.rec:
            self.registry.observe("latency." + path, t - sp.start)
            self.ring.append(sp.to_record())

    def machine_crash(self, mid: int, t: float,
                      open_spans: List[Optional[Span]]) -> None:
        """A machine died with ops in flight: their spans abort (recorded
        in the ring when sampled, never path-counted — the ops produced
        no completion)."""
        self.registry.inc("evt.machine_crash")
        self.ring.append({"type": "event", "name": "machine_crash",
                          "mid": mid, "t": t})
        for sp in open_spans:
            if sp is None:
                continue
            sp.end = t
            sp.path = ABORTED
            self.registry.inc("path." + ABORTED)
            if sp.rec:
                sp.events.append((t, "machine_crash"))
                self.ring.append(sp.to_record())

    def note(self, name: str, t: float, **fields) -> None:
        """Out-of-band ring event (checker failure, phase marker, …)."""
        rec = {"type": "event", "name": name, "t": t}
        rec.update(fields)
        self.ring.append(rec)

    # -- views ----------------------------------------------------------------

    def _sync_sources(self) -> None:
        """Pull attached raw stats dicts into the registry as counters
        (point-in-time: zero hot-path cost, exact at snapshot time)."""
        reg = self.registry
        if self.network is not None:
            for k, v in self.network.stats.items():
                reg.counters["net." + k] = v
        if self.engine is not None:
            stats = (self.engine.telemetry()
                     if hasattr(self.engine, "telemetry")
                     else self.engine.stats)
            for k, v in stats.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    reg.counters["engine." + k] = v
            calls = stats.get("fused_receiver_calls", 0)
            if calls:
                reg.set_gauge("engine.receiver_lanes_per_call",
                              stats.get("fused_receiver_lanes", 0) / calls)
            calls = stats.get("fused_issuer_calls", 0)
            if calls:
                reg.set_gauge("engine.issuer_lanes_per_call",
                              stats.get("fused_issuer_lanes", 0) / calls)
        for m in self._machines:
            sched = getattr(m, "ingest", None)
            if sched is not None:
                for k, v in sched.stats.items():
                    reg.counters[f"ingest.m{m.mid}.{k}"] = v

    def snapshot(self) -> dict:
        """Registry snapshot with all attached raw sources synced in."""
        self._sync_sources()
        return self.registry.snapshot()

    def path_counts(self) -> dict:
        """Exact per-path completion counters (reconcile against
        :func:`repro_torch.core.sim.completion_tuples` kinds)."""
        c = self.registry.counters
        return {p: c.get("path." + p, 0) for p in PATHS}
