"""Streaming quantile sketch with a provable relative-error bound.

The open-loop harness records one latency sample per completed client op
— potentially millions per run — and must report p50/p99/p999 per op
class *online*, without retaining the samples.  This is the classic
log-linear ("HDR histogram") sketch:

* a value ``v >= 1`` lands in the bucket ``(e, m)`` where
  ``e = floor(log2 v)`` and ``m = floor((v / 2**e - 1) * 2**b)`` — ``2**b``
  linear sub-buckets per power of two (``b = sub_bits``);
* bucket counts are kept sparsely (a dict), so memory is bounded by the
  number of *distinct magnitude buckets touched* (a few hundred), never by
  the sample count;
* :meth:`QuantileSketch.quantile` returns the **upper edge** of the bucket
  holding the target rank.

Accuracy bound (the property ``tests/test_loadgen.py`` checks against a
sorted oracle): for any ``0 < p <= 1``, with ``q`` the true p-quantile
(the ``ceil(p·n)``-th smallest recorded value) and ``q >= 1``,

    ``q  <=  quantile(p)  <=  q · (1 + 2**-sub_bits)``

i.e. the estimate never *under*-reports the oracle rank's value and
over-reports by at most the relative bucket width ``eps = 2**-sub_bits``
(default ``b = 7`` → eps < 0.8 %).  Why: the target rank's value lies in
the returned bucket, whose width is at most ``eps`` times its lower edge.
Values below one tick all collapse into bucket 0 (reported as ``1.0``) —
simulated-network latencies are >= one virtual tick, so sub-tick
resolution is deliberately not spent for.  Estimates are additionally
clamped to the recorded maximum, which preserves both inequalities.

Sketches :meth:`merge` losslessly (bucket-wise sum), so per-window or
per-shard recorders can be combined after a run.  See
``docs/workloads.md`` ("Quantile-sketch accuracy") for the methodology.
"""

from __future__ import annotations

import math
from typing import Dict, Optional


class QuantileSketch:
    """Sparse log-linear histogram over non-negative values."""

    def __init__(self, sub_bits: int = 7):
        if not 0 <= sub_bits <= 16:
            raise ValueError(f"sub_bits out of range [0, 16]: {sub_bits}")
        self.sub_bits = sub_bits
        self._counts: Dict[int, int] = {}
        self.count = 0
        self.max = 0.0
        self.min = math.inf

    @property
    def relative_error(self) -> float:
        """The documented bound: estimates over-report by at most this
        fraction (values >= 1)."""
        return 2.0 ** -self.sub_bits

    # -- bucket arithmetic ----------------------------------------------------

    def _bucket(self, v: float) -> int:
        if v < 1.0:
            return 0
        m, e = math.frexp(v)                    # v = m * 2**e, m in [0.5, 1)
        exp = e - 1                             # floor(log2 v)
        sub = int((v / (1 << exp) - 1.0) * (1 << self.sub_bits))
        sub = min(sub, (1 << self.sub_bits) - 1)
        return 1 + (exp << self.sub_bits) + sub

    def _upper_edge(self, bucket: int) -> float:
        if bucket == 0:
            return 1.0
        exp, sub = divmod(bucket - 1, 1 << self.sub_bits)
        return (1 << exp) * (1.0 + (sub + 1) / (1 << self.sub_bits))

    # -- recording ------------------------------------------------------------

    def record(self, v: float, n: int = 1) -> None:
        if v < 0:
            raise ValueError(f"latency samples must be >= 0, got {v}")
        if n < 1:
            return
        b = self._bucket(v)
        self._counts[b] = self._counts.get(b, 0) + n
        self.count += n
        if v > self.max:
            self.max = float(v)
        if v < self.min:
            self.min = float(v)

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into this sketch (lossless bucket-wise sum)."""
        if other.sub_bits != self.sub_bits:
            raise ValueError(
                f"cannot merge sketches with sub_bits "
                f"{self.sub_bits} != {other.sub_bits}")
        for b, n in other._counts.items():
            self._counts[b] = self._counts.get(b, 0) + n
        self.count += other.count
        self.max = max(self.max, other.max)
        self.min = min(self.min, other.min)
        return self

    # -- queries --------------------------------------------------------------

    def quantile(self, p: float) -> float:
        """The p-quantile estimate (see the module docstring for the
        bound).  ``nan`` when nothing was recorded."""
        if not 0.0 < p <= 1.0:
            raise ValueError(f"p must be in (0, 1], got {p}")
        if self.count == 0:
            return math.nan
        target = max(1, math.ceil(p * self.count))
        cum = 0
        for b in sorted(self._counts):
            cum += self._counts[b]
            if cum >= target:
                return min(self._upper_edge(b), self.max)
        return self.max                          # pragma: no cover

    def summary(self) -> Optional[dict]:
        """JSON-ready p50/p99/p999 row; ``None`` when empty."""
        if self.count == 0:
            return None
        r = lambda x: round(x, 3)
        return {"count": self.count, "p50": r(self.quantile(0.50)),
                "p99": r(self.quantile(0.99)),
                "p999": r(self.quantile(0.999)), "max": r(self.max)}
