"""Seeded Zipfian key sampling over key universes up to millions of keys.

The open-loop harness (:mod:`repro_torch.serve.loadgen.harness`) needs realistic
*key skew*: production KV traffic concentrates on a small hot set while the
key universe is huge (§2's datacenter deployment), and that skew is exactly
what exercises the ingest scheduler's aging-fairness guarantees and ABD's
common-case acceleration.  This module provides the standard model:

* **Zipf(s) over ranks.**  Rank ``r`` (0 = hottest) is drawn with
  probability proportional to ``1 / (r + 1) ** s``.  Sampling is
  inverse-CDF: one ``float64`` cumulative-weight table of size ``n_keys``
  (8 MB at one million keys — built once, O(log n) per draw), so a
  million-key universe costs the same per draw as a 16-key one.

* **Rank → key scatter.**  Hot ranks must not trivially be keys
  ``0, 1, 2, …`` (key 0 is the config register in reconfig deployments,
  and contiguous hot keys would all land in one shard block of the
  sharded plane layout).  Ranks are scattered over the universe by a
  seeded *affine bijection* ``key = key_base + (a·r + b) mod n`` with
  ``gcd(a, n) = 1`` — a permutation by construction, O(1) memory, fully
  determined by the seed.

* **Determinism.**  The same ``(n_keys, s, seed)`` triple yields the same
  key sequence on every host and every run — the property the smoke
  seeds and the scalar-vs-batched identity gates rest on.  Derived
  streams (:meth:`ZipfKeys.stream`) give shard- or phase-local
  generators that are themselves deterministic functions of the parent
  seed (tested in ``tests/test_loadgen.py``).

See ``docs/workloads.md`` for the parameterization guidance (what ``s``
means, typical values, and how universe size interacts with the batched
plane layout).
"""

from __future__ import annotations

import math
import random

import numpy as np


def _coprime_multiplier(n: int, rng: random.Random) -> int:
    """A seeded multiplier ``a`` with ``gcd(a, n) == 1`` (and ``a != 1``
    when the universe allows it, so the scatter actually scatters)."""
    if n <= 2:
        return 1
    for _ in range(64):
        a = rng.randrange(2, n)
        if math.gcd(a, n) == 1:
            return a
    # degenerate n (e.g. highly composite small n with unlucky draws):
    # n - 1 is always coprime with n
    return n - 1


class ZipfKeys:
    """Seeded Zipf(s) key generator over ``[key_base, key_base + n_keys)``.

    ``s = 0`` is uniform; ``s ~ 0.99`` is the classic YCSB default;
    ``s > 1`` concentrates mass hard on the hot set (at ``s = 1.2`` the
    hottest key draws a few percent of all traffic regardless of universe
    size).
    """

    def __init__(self, n_keys: int, s: float = 0.99, seed: int = 0,
                 key_base: int = 0):
        if n_keys < 1:
            raise ValueError(f"n_keys must be >= 1, got {n_keys}")
        if s < 0:
            raise ValueError(f"zipf exponent must be >= 0, got {s}")
        self.n_keys = n_keys
        self.s = s
        self.seed = seed
        self.key_base = key_base
        ranks = np.arange(1, n_keys + 1, dtype=np.float64)
        cdf = np.cumsum(ranks ** -s)
        cdf /= cdf[-1]
        self._cdf = cdf
        # str seeding hashes via sha512 (deterministic across processes;
        # tuple seeds would go through PYTHONHASHSEED-salted hash())
        self._rng = random.Random(f"zipf:{seed}")
        self._a = _coprime_multiplier(n_keys, self._rng)
        self._b = self._rng.randrange(n_keys)

    def _key_of_rank(self, rank: int) -> int:
        return self.key_base + (self._a * rank + self._b) % self.n_keys

    def draw(self) -> int:
        """One key, Zipf-distributed, advancing the seeded stream."""
        rank = int(np.searchsorted(self._cdf, self._rng.random(),
                                   side="left"))
        return self._key_of_rank(min(rank, self.n_keys - 1))

    def sample(self, k: int) -> list:
        """``k`` keys (one stream advance each)."""
        return [self.draw() for _ in range(k)]

    def hottest(self, k: int = 1) -> list:
        """The ``k`` hottest keys (ranks ``0..k-1`` through the scatter) —
        for tests and docs, not part of the sampling stream."""
        return [self._key_of_rank(r) for r in range(min(k, self.n_keys))]

    def stream(self, i: int) -> "ZipfKeys":
        """A derived generator (same universe/skew, independent seeded
        stream) — e.g. one per shard or per arrival phase.  Deterministic
        in ``(seed, i)``; ``stream(i)`` twice yields identical sequences.
        """
        return ZipfKeys(self.n_keys, self.s,
                        seed=self.seed * 1_000_003 + i + 1,
                        key_base=self.key_base)
