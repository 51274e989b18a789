"""Ingest scheduler: per-key FIFO queues -> conflict-free engine batches.

This is ``replay.bucket_conflict_free`` promoted into a real subsystem.  The
SIMD engines (:mod:`repro_torch.core.vector` receiver, `repro_torch.core.proposer_vector`
issuer) consume *conflict-free batches*: at most one message per key lane (or
one reply per session lane), per-lane arrival order preserved across batches,
and — receiver only — a batch boundary before any PROPOSE/ACCEPT whose rmw-id
a commit earlier in the *same* batch just registered (registrations scatter
after the batch, so in-batch registered-ness would be invisible to the
gather).  The scheduler owns turning unbounded ingest streams — inbound wire
messages and client :class:`~repro_torch.core.node.Request` admissions alike — into
such batches.

Two emission modes:

* **strict order** (``strict_order=True``) — batches are contiguous runs of
  the global arrival sequence; an item that conflicts opens a new batch and
  nothing overtakes it.  This is the mode :class:`~.machine.BatchedMachine`
  uses: because no item ever overtakes another, the batched execution applies
  every message in exactly the arrival order the scalar
  :class:`~repro_torch.core.node.Machine` would, which is what makes the batched
  cluster *completion-for-completion identical* to the scalar one (the
  differential acceptance bar).  :func:`bucket_conflict_free` — shared with
  :mod:`repro_torch.core.replay` — is this mode applied to a whole trace.

* **aging fairness** (``strict_order=False``) — per-key FIFO queues are
  scanned oldest-head-first, so every ``emit`` admits the globally oldest
  pending item and a hot key can never starve a cold one; items may overtake
  a conflicted older item of a *different* key.  Cross-key overtaking
  preserves per-key order and the in-batch registration rule, so any emitted
  schedule is still a legal asynchronous-network schedule (safety holds); it
  trades the scalar-oracle exactness of strict mode for latency fairness
  under key skew, which is the right default for a real serving front end.

Both modes are single-pass O(n): conflict bookkeeping uses generation
stamps, so opening a new batch is O(1) — no per-flush set/dict rebuilding
(the pre-subsystem ``replay.bucket_conflict_free`` re-allocated both on
every flush).

**Observability.**  The scheduler exposes live queue gauges for the
open-loop workload harness (``docs/workloads.md``): :meth:`IngestScheduler.
gauges` reports ``queue_depth`` (items pending), ``keys_backlogged``
(distinct keys with a non-empty queue — the fan-out the next emission pass
faces) and ``oldest_age`` (how many admissions ago the oldest pending item
arrived — the scheduler-aging signal the fairness mode bounds).  An
optional :attr:`~IngestScheduler.gauge_hook` fires with that snapshot after
every emitted batch for in-situ sampling, and
:meth:`IngestScheduler.bind_metrics` re-homes the same snapshot onto a
:class:`repro_torch.obs.MetricsRegistry` so the whole stack shares one gauge
surface (``docs/observability.md``).  :meth:`IngestScheduler.reset`
clears all queued state (crash-stop semantics: a machine's staged ingest
dies with its inbox) while the cumulative ``stats`` counters survive — see
``BatchedMachine.crash``.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import (
    Callable, Deque, Dict, Iterable, Iterator, List, Optional, Tuple,
)

from repro_torch.core.lanes import ShardMap
from repro_torch.core.types import Msg

# The strict-order batching core (generation-stamped conflict bookkeeping
# and bucket_conflict_free itself) lives in repro_torch.core.lanes, shared with
# the replay harness; this module re-exports it and layers the per-key
# queueing / aging / emission policy on top.
from repro_torch.core.lanes import _ConflictState, bucket_conflict_free  # noqa: F401

# Engine lane budget for one emitted batch.  The fused ClusterEngine
# stacks every machine's batch into one call, so the per-machine target is
# an explicit lane budget, high enough that no realistic conflict-free run
# is ever split by the cap — BatchedMachine uses it as its default.
DEFAULT_BATCH_TARGET = 128


class IngestScheduler:
    """Per-key FIFO ingest queues with conflict-free batch emission.

    Parameters
    ----------
    batch_target:
        Soft cap on emitted batch size (engine lane budget).  ``None`` means
        unbounded — a batch ends only on a lane conflict (or, strict mode, a
        registration conflict).
    strict_order:
        See the module docstring.  Strict mode emits contiguous runs of the
        arrival order (oracle-exact); aging mode emits oldest-head-first
        across per-key queues (starvation-free under key skew).
    key_of:
        Lane extractor for non-``Msg`` items (client requests use the target
        key; issuer replies use the session lane).  ``Msg`` items default to
        ``msg.key`` and additionally respect the registry rule.
    """

    def __init__(self, *, batch_target: Optional[int] = None,
                 strict_order: bool = False,
                 key_of: Optional[Callable[[object], object]] = None):
        if batch_target is not None and batch_target < 1:
            raise ValueError(f"batch_target must be >= 1, got {batch_target}")
        self.batch_target = batch_target
        self.strict_order = strict_order
        self._key_of = key_of
        self._queues: Dict[object, Deque] = {}
        # heap of (oldest pending seq, key): aging order over queue heads
        self._heads: List = []
        self._seq = 0
        self._pending = 0
        self._backlogged = 0             # keys with a non-empty queue
        self.stats = {"offered": 0, "emitted": 0, "batches": 0,
                      "conflict_deferrals": 0}
        # observer called with gauges() after every emitted batch
        self.gauge_hook: Optional[Callable[[Dict[str, int]], None]] = None
        # the unified gauge surface (repro_torch.obs.MetricsRegistry): when
        # bound, every emitted batch publishes the same snapshot the
        # gauge_hook sees — see bind_metrics()
        self._metrics = None
        self._metrics_prefix = "ingest"

    # -- ingest ---------------------------------------------------------------

    def _lane(self, item: object) -> object:
        if self._key_of is not None:
            return self._key_of(item)
        if isinstance(item, Msg):
            return item.key
        raise TypeError(
            f"IngestScheduler needs key_of for non-Msg items, got {item!r}")

    def offer(self, item: object) -> None:
        """Enqueue one item on its key's FIFO."""
        key = self._lane(item)
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = deque()
        if not q:
            heapq.heappush(self._heads, (self._seq, key))
            self._backlogged += 1
        q.append((self._seq, item))
        self._seq += 1
        self._pending += 1
        self.stats["offered"] += 1

    def offer_many(self, items: Iterable[object]) -> None:
        """Enqueue a run of items with per-item bookkeeping hoisted out of
        the admit loop: attribute loads become locals, and the sequence /
        pending / stats counters update once per run instead of once per
        item (the ~50 µs/item host-path shave — see
        ``benchmarks/bench_protocol.py`` ``host_path`` lane).

        Exception-safe: if the iterable (or ``key_of``) raises mid-run,
        the items admitted so far are committed consistently.  Without
        the ``finally`` the hoisted counters never landed, so the *next*
        admissions reused the same sequence numbers — and a stale heap
        entry for a long-dead key could then alias a live head's seq,
        making :meth:`gauges` report the dead key's ``oldest_age`` (and
        ``queue_depth`` drift negative).  See
        ``tests/test_scheduler.py::test_offer_many_partial_failure``.
        """
        queues = self._queues
        heads = self._heads
        lane = self._lane
        seq = self._seq
        n = 0
        newly = 0
        try:
            for item in items:
                key = lane(item)
                q = queues.get(key)
                if q is None:
                    q = queues[key] = deque()
                if not q:
                    heapq.heappush(heads, (seq, key))
                    newly += 1
                q.append((seq, item))
                seq += 1
                n += 1
        finally:
            self._seq = seq
            self._pending += n
            self._backlogged += newly
            self.stats["offered"] += n

    def pending(self) -> int:
        return self._pending

    # -- observability --------------------------------------------------------

    def gauges(self) -> Dict[str, int]:
        """Live queue gauges: ``queue_depth`` (pending items),
        ``keys_backlogged`` (keys with a non-empty queue) and
        ``oldest_age`` (admissions since the oldest pending item arrived
        — 0 when idle).  O(stale heap entries), usually O(1).

        The lazy cleanup is sound because dead keys leave no trace: an
        emptied queue is deleted from ``_queues`` (see :meth:`_pop`) and
        sequence numbers are never reused (see :meth:`offer_many`), so a
        heap top is live **iff** its key still has a queue whose head
        carries exactly that seq.
        """
        heads = self._heads
        # lazily discard stale heap entries so the age reading is live
        while heads:
            seq, key = heads[0]
            q = self._queues.get(key)
            if q and q[0][0] == seq:
                break
            heapq.heappop(heads)
        oldest = (self._seq - heads[0][0]) if heads else 0
        return {"queue_depth": self._pending,
                "keys_backlogged": self._backlogged,
                "oldest_age": oldest}

    def bind_metrics(self, registry, prefix: str = "ingest") -> None:
        """Re-home the gauge surface onto a
        :class:`repro_torch.obs.MetricsRegistry`: every emitted batch publishes
        ``<prefix>.queue_depth`` / ``keys_backlogged`` / ``oldest_age``
        gauges plus a ``<prefix>.batch_lanes`` occupancy histogram there
        — the same snapshot any ``gauge_hook`` observer receives, so
        there is exactly one gauge surface regardless of consumer."""
        self._metrics = registry
        self._metrics_prefix = prefix

    def reset(self) -> None:
        """Drop all queued state — crash-stop hygiene.

        An abandoned :meth:`drain_sharded` / :meth:`drain` generator (the
        machine crashed mid-wave, or the engine aborted mid-tick) leaves
        offered-but-unemitted items queued; a restarted incarnation must
        not replay them, and a crashed machine must not keep reporting
        stale backlog to gauge observers.  Cumulative ``stats`` survive
        (they describe history, not state); the admission sequence keeps
        counting so ``oldest_age`` stays monotone for observers.
        """
        self._queues.clear()
        self._heads.clear()
        self._pending = 0
        self._backlogged = 0

    # -- emission -------------------------------------------------------------

    def _pop(self, key: object) -> object:
        q = self._queues[key]
        _seq, item = q.popleft()
        if q:
            heapq.heappush(self._heads, (q[0][0], key))
        else:
            # dead key: drop the deque entirely.  Keeping empty deques
            # around leaked one per key ever seen (unbounded under key
            # churn) and was the only reason a stale heap entry could
            # still resolve a dead key at all.
            del self._queues[key]
            self._backlogged -= 1
        self._pending -= 1
        return item

    def emit(self) -> List[object]:
        """Emit one conflict-free batch (empty when nothing is pending).

        Strict mode: the longest conflict-free contiguous prefix of the
        arrival order (capped at ``batch_target``).  Aging mode: scan queue
        heads oldest-first, deferring conflicted heads to the next batch —
        the globally oldest pending item is always admitted, so no key
        starves.
        """
        batch, _shards = self._emit(None)
        return batch

    def emit_sharded(self, shard_map: ShardMap
                     ) -> Tuple[List[object], List[List[object]]]:
        """Emit one conflict-free batch *and* its per-shard sub-batches in
        a single admission pass: every admitted item is appended to its
        shard's sub-batch at admit time, not split post hoc.

        Returns ``(batch, per_shard)``: the batch in emission order (the
        reply/dispatch order the wave protocol needs) plus one
        order-preserving sub-batch per shard (disjoint plane blocks — the
        conflict rules already guarantee at most one item per lane).  A
        key outside the shard map's lane axis raises ``ValueError``.
        """
        return self._emit(shard_map)

    def _emit(self, shard_map: Optional[ShardMap]
              ) -> Tuple[List[object], List[List[object]]]:
        batch: List[object] = []
        shards: List[List[object]] = (
            [] if shard_map is None
            else [[] for _ in range(shard_map.n_shards)])
        lps = None if shard_map is None else shard_map.lanes_per_shard
        state = _ConflictState()
        deferred: List = []
        try:
            while self._heads:
                if (self.batch_target is not None
                        and len(batch) >= self.batch_target):
                    break
                seq, key = heapq.heappop(self._heads)
                q = self._queues.get(key)
                if not q or q[0][0] != seq:
                    continue                   # stale heap entry
                if lps is not None and not 0 <= key < shard_map.n_lanes:
                    # caller error — restore the live head before raising
                    # so the scheduler stays consistent (nothing queued
                    # for *other* keys may be lost to a bad shard map)
                    heapq.heappush(self._heads, (seq, key))
                    raise ValueError(
                        f"key {key} outside the sharded lane axis "
                        f"[0, {shard_map.n_lanes})")
                item = q[0][1]
                msg = item if isinstance(item, Msg) else None
                if state.conflicts(key, msg):
                    self.stats["conflict_deferrals"] += 1
                    if self.strict_order:
                        heapq.heappush(self._heads, (seq, key))
                        break                  # nothing may overtake it
                    deferred.append((seq, key))
                    continue
                state.admit(key, msg)
                item = self._pop(key)
                batch.append(item)
                if lps is not None:
                    shards[key // lps].append(item)
        finally:
            # also on the error path: deferred heads are live entries —
            # dropping them would strand their queues forever
            for entry in deferred:
                heapq.heappush(self._heads, entry)
        if batch:
            self.stats["batches"] += 1
            self.stats["emitted"] += len(batch)
            if self._metrics is not None or self.gauge_hook is not None:
                g = self.gauges()
                if self._metrics is not None:
                    mp = self._metrics_prefix
                    self._metrics.set_gauge(mp + ".queue_depth",
                                            g["queue_depth"])
                    self._metrics.set_gauge(mp + ".keys_backlogged",
                                            g["keys_backlogged"])
                    self._metrics.set_gauge(mp + ".oldest_age",
                                            g["oldest_age"])
                    self._metrics.observe(mp + ".batch_lanes", len(batch))
                if self.gauge_hook is not None:
                    self.gauge_hook(g)
        return batch, shards

    def drain(self) -> Iterator[List[object]]:
        """Emit batches until the queues are empty."""
        while self._pending:
            batch = self.emit()
            if not batch:            # defensive: cannot happen (oldest head
                break                # is always admissible)
            yield batch

    def drain_sharded(self, shard_map: ShardMap
                      ) -> Iterator[Tuple[List[object], List[List[object]]]]:
        """:meth:`drain`, yielding ``(batch, per_shard)`` pairs — the
        sharded serve path's emission loop."""
        while self._pending:
            batch, shards = self._emit(shard_map)
            if not batch:            # defensive: cannot happen
                break
            yield batch, shards

