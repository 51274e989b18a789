"""Open-loop workload harness for the replicated RMW register.

The paper's deployment model (§2) is a datacenter KV store serving reads,
writes and read-modify-writes over a huge, skewed key space.  This package
reproduces that *as a workload*: a seeded open-loop arrival process in
virtual time (arrivals do not wait for completions — overload shows up as
queueing delay in the measured latency), Zipfian key skew over universes
up to millions of keys, per-op-class traffic mixes, an online streaming
quantile recorder (p50/p99/p999 per op class), fault injection through the
load (crash/restart, partitions), and queue-depth / scheduler-aging gauges
sampled from the serve path's ``IngestScheduler``.

Entry points:

* :class:`OpenLoopSpec` + :class:`OpenLoopHarness` — build and drive a run
  (scalar ``Machine`` or batched serve path; same seed ⇒ identical
  completions across both).
* :class:`FaultPlan` — schedule crash/restart and partition/heal events;
  each contributes a fault window so tail latency is reported separately
  for steady-state vs fault intervals.
* :class:`ZipfKeys`, :class:`ArrivalPhase`, :class:`OpMix` / :data:`MIXES`,
  :class:`QuantileSketch`, :class:`LatencyRecorder`, :class:`GaugeLog` —
  the composable pieces.

Methodology, parameterization guidance and accuracy bounds live in
``docs/workloads.md``; the bench lanes built on top are described in
``docs/benchmarks.md`` (``benchmarks/bench_open_loop.py`` and the
20-seed ``scripts/open_loop_smoke.py`` gate).
"""

from .arrivals import MIXES, PRESETS, ArrivalPhase, OpMix, arrival_times
from .harness import FaultPlan, OpenLoopHarness, OpenLoopResult, OpenLoopSpec
from .recorder import (GaugeLog, LatencyRecorder, OP_CLASS, WINDOWS,
                       merged_class_summary)
from .sketch import QuantileSketch
from .zipf import ZipfKeys

__all__ = [
    "MIXES", "PRESETS", "ArrivalPhase", "OpMix", "arrival_times",
    "FaultPlan", "OpenLoopHarness", "OpenLoopResult", "OpenLoopSpec",
    "GaugeLog", "LatencyRecorder", "OP_CLASS", "WINDOWS",
    "merged_class_summary", "QuantileSketch", "ZipfKeys",
]
