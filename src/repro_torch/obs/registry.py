"""One named metrics surface: counters, gauges and quantile histograms.

Every layer of the serve stack already keeps ad-hoc numbers — per-machine
``Machine.stats`` dicts, ``Network.stats``, scheduler gauges, engine wave
counters.  The registry does not replace those raw dicts (they stay the
cheap hot-path representation); it is the *aggregation point*: attach-time
wiring registers lazy gauge callables over them, protocol path counters
land here directly, and a :meth:`MetricsRegistry.snapshot` is the single
deterministic JSON-ready view a dump or a report reads.

Histograms reuse :class:`repro_torch.serve.loadgen.sketch.QuantileSketch`
(log-linear HDR-style buckets, proven relative-error bound), so per-path
latency percentiles in dumps carry the same accuracy contract as the
open-loop harness (``docs/workloads.md``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.serve.loadgen.sketch import QuantileSketch


class MetricsRegistry:
    """Counters, gauges and histograms under dotted string names.

    Name convention (see ``docs/observability.md`` for the full catalog):
    ``<layer>.<metric>`` — e.g. ``path.all_aboard_fast``, ``net.dropped``,
    ``ingest.m3.queue_depth``, ``engine.fused_receiver_calls``.

    Gauges come in two flavours: *pushed* (:meth:`set_gauge` stores the
    latest value) and *registered* (:meth:`register_gauge` stores a
    zero-arg callable sampled at :meth:`snapshot` time — the idiom for
    re-homing live stats dicts without copying them on the hot path).
    """

    def __init__(self, *, sub_bits: int = 7):
        self._sub_bits = sub_bits
        self.counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._gauge_fns: Dict[str, Callable[[], float]] = {}
        self.histograms: Dict[str, QuantileSketch] = {}

    # -- counters -------------------------------------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        return self.counters.get(name, 0)

    # -- gauges ---------------------------------------------------------------

    def set_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = value

    def register_gauge(self, name: str, fn: Callable[[], float]) -> None:
        """Register a lazy gauge: ``fn`` is invoked at snapshot time."""
        self._gauge_fns[name] = fn

    def gauge(self, name: str) -> Optional[float]:
        fn = self._gauge_fns.get(name)
        if fn is not None:
            return fn()
        return self._gauges.get(name)

    # -- histograms -----------------------------------------------------------

    def histogram(self, name: str) -> QuantileSketch:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = QuantileSketch(sub_bits=self._sub_bits)
        return h

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).record(value)

    # -- views ----------------------------------------------------------------

    def snapshot(self) -> Dict[str, Dict]:
        """Deterministic JSON-ready view: counters verbatim, gauges with
        lazy callables sampled now, histograms as quantile summaries."""
        gauges: Dict[str, float] = dict(self._gauges)
        for name, fn in self._gauge_fns.items():
            gauges[name] = fn()
        return {
            "counters": dict(self.counters),
            "gauges": gauges,
            "histograms": {name: h.summary()
                           for name, h in self.histograms.items()},
        }
