"""Online latency recording: per-op-class sketches split by fault window.

Production-grade evaluations report tail latency under contention *and*
failure, not just steady-state throughput — so the recorder keeps one
:class:`~repro_torch.serve.loadgen.sketch.QuantileSketch` per
``(op class, window)`` cell, where the window is

* ``steady`` — the op's whole ``[invoke, complete]`` interval lies outside
  every fault window, or
* ``fault``  — the interval overlaps at least one fault window (a
  half-open ``[t0, t1)`` span of virtual time covering an injected crash
  until some settle slack after recovery, or a partition until after
  heal; see :class:`~repro_torch.serve.loadgen.harness.FaultPlan`).

Classification is by *overlap*, not by invoke time: an op issued before a
crash whose completion was delayed by it belongs to the fault tail — that
delay is exactly the number the window exists to expose.

:class:`GaugeLog` is the companion time-series sink for queue-depth and
scheduler-aging gauges sampled while the run progresses (machine FIFO
backlog, ingest-scheduler ``queue_depth`` / ``oldest_age`` — see
``IngestScheduler.gauges``); it keeps only streaming aggregates
(max / mean / last), never the series itself.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.node import ReqKind

from .sketch import QuantileSketch

OP_CLASS = {ReqKind.RMW: "rmw", ReqKind.WRITE: "write", ReqKind.READ: "read"}
WINDOWS = ("steady", "fault")


class LatencyRecorder:
    """Per-(op class, window) latency sketches over a client history."""

    def __init__(self, fault_windows: Sequence[Tuple[float, float]] = (),
                 sub_bits: int = 7):
        for t0, t1 in fault_windows:
            if t1 <= t0:
                raise ValueError(f"empty fault window [{t0}, {t1})")
        self.fault_windows = tuple(fault_windows)
        self.sketches: Dict[Tuple[str, str], QuantileSketch] = {
            (w, c): QuantileSketch(sub_bits)
            for w in WINDOWS for c in OP_CLASS.values()}

    def window_of(self, invoke: float, complete: float) -> str:
        for t0, t1 in self.fault_windows:
            if invoke < t1 and complete >= t0:
                return "fault"
        return "steady"

    def observe(self, h: dict) -> None:
        """Record one completed op from the cluster's history projection
        (``Cluster.history`` rows: kind/invoke/complete)."""
        w = self.window_of(h["invoke"], h["complete"])
        self.sketches[(w, OP_CLASS[h["kind"]])].record(
            h["complete"] - h["invoke"])

    def report(self) -> dict:
        """``{window: {op_class: {count, p50, p99, p999, max}}}`` —
        empty cells reported as ``None`` (e.g. no fault window in the
        run, or a mix with no RMWs)."""
        return {w: {c: self.sketches[(w, c)].summary()
                    for c in OP_CLASS.values()}
                for w in WINDOWS}


class GaugeLog:
    """Streaming aggregates (max / mean / last) of named gauge series."""

    def __init__(self):
        self._agg: Dict[str, List[float]] = {}   # name -> [n, sum, max, last]

    def sample(self, name: str, value: float) -> None:
        a = self._agg.get(name)
        if a is None:
            self._agg[name] = [1, value, value, value]
        else:
            a[0] += 1
            a[1] += value
            if value > a[2]:
                a[2] = value
            a[3] = value

    def sample_many(self, gauges: Dict[str, float],
                    prefix: str = "") -> None:
        for name, value in gauges.items():
            self.sample(prefix + name, value)

    def summary(self) -> Dict[str, dict]:
        return {name: {"max": round(a[2], 3),
                       "mean": round(a[1] / a[0], 3),
                       "last": round(a[3], 3), "samples": a[0]}
                for name, a in sorted(self._agg.items())}


def merged_class_summary(rec: LatencyRecorder,
                         window: Optional[str] = None) -> Optional[dict]:
    """All-classes-combined summary for one window (or both), for
    single-number gating and log lines."""
    total = QuantileSketch(next(iter(rec.sketches.values())).sub_bits)
    for (w, _c), sk in rec.sketches.items():
        if window is None or w == window:
            total.merge(sk)
    return total.summary()
