"""Protocol flight recorder: unified metrics, per-op path tracing, dumps.

The paper's central claim is about *path distribution* — ABD reads/writes
(§10–§11) and All-aboard (§9) accelerate the common case while CP (§4–§8)
absorbs RMW conflicts.  This package makes that distribution a first-class
observable:

* :class:`~repro_torch.obs.registry.MetricsRegistry` — one named surface for
  counters, gauges (pushed or lazily sampled) and histograms (backed by
  :class:`repro_torch.serve.loadgen.sketch.QuantileSketch`);
* :class:`~repro_torch.obs.trace.FlightRecorder` — a virtual-time span tracer
  with a bounded ring buffer: per-op lifecycle spans classified by the
  path the op actually took (``abd_read`` / ``abd_write`` /
  ``all_aboard_fast`` / ``cp_slow``), plus protocol events (retries,
  steals, helps, quorum-wait ticks, machine crashes);
* :mod:`~repro_torch.obs.dump` — deterministic JSONL and Chrome-trace/Perfetto
  exports of the ring, and :func:`~repro_torch.obs.dump.flight_guard` which
  dumps automatically when a checker fails or a smoke script dies;
* :mod:`~repro_torch.obs.report` — the summarizer behind
  ``scripts/trace_report.py`` (path mix, fast-path hit rate, per-path
  latency percentiles, top contended keys).

Zero-cost-by-default contract: a :class:`~repro_torch.core.node.Machine` whose
``obs`` attribute is ``None`` (the default) pays nothing beyond an
``is not None`` branch per already-counted protocol event; path counters
are exact whenever a recorder is attached, while span *recording* into
the ring is governed by the recorder mode (``off`` / ``sampled`` /
``full``).  See ``docs/observability.md``.
"""

from .registry import MetricsRegistry
from .trace import PATHS, FlightRecorder, Span
from .dump import dump_all, dump_chrome_trace, dump_jsonl, flight_guard
from .report import load_records, summarize, render_summary

__all__ = [
    "MetricsRegistry", "FlightRecorder", "Span", "PATHS",
    "dump_all", "dump_chrome_trace", "dump_jsonl", "flight_guard",
    "load_records", "summarize", "render_summary",
]
