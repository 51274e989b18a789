"""Host-side bridges between scalar machine state and the SIMD engines.

The two batched engines are deliberately lane-parallel and pure: the fused
receiver step and the fused issuer step (:mod:`.cluster_engine`) never
touch anything that needs gather/scatter across lanes.  Everything that
does is the *host bridge*, defined here:

* :class:`KVBridge` — the per-key KV gather–scatter bridge.  The
  authoritative KV-pair metadata lives in the cluster's stacked
  :class:`~.cluster_engine.PlaneStack` (the receiver engine's
  :class:`~repro_torch.core.vector.KVTable` planes with a leading machine axis);
  each bridge is one machine's *row* of that stack.  Host decisions
  (grabbing the pair §4.1/§5, computing accept values §8.5/§10.1, local
  commits) *check out* scalar :class:`~repro_torch.core.types.KVPair` views of
  single lanes, mutate them with the unchanged scalar code paths, and the
  bridge scatters them back before the next fused engine step.  It quacks
  like the ``Dict[int, KVPair]`` the scalar
  :class:`~repro_torch.core.node.Machine` uses, so ``handlers.get_kv`` and every
  host action work verbatim.

* :class:`SteeringTable` — the lid -> (machine, session-lane) reply-steering
  table (§3.1.2): round starts register their lid on the issuing lane;
  inbound network replies are routed to their ProposerTable lane — in the
  fused cluster engine a *coordinate* ``(machine row, lane)`` of the
  stacked planes (staleness itself is decided *inside* the engine by the
  lid/phase gates — the table only picks the lane and drops out-of-range
  lids, exactly like the scalar machine's ``lid & 0xFFFF`` steering).

The registry has no lane mirror: the fused engine computes
``is_registered`` per staged message against the machine's scalar registry
and scatters commit registrations back host-side (see
:mod:`.cluster_engine`).

The scalar <-> lane converters and issuer round-lane loaders this bridge
uses are defined in :mod:`repro_torch.core.lanes` (shared with the differential
replay harness so the live batched path and the replay oracle can never
drift apart) and re-exported here as part of the bridge surface.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import vector
# The scalar<->lane converters, issuer round-lane loaders and ActionBatch
# payload helpers are protocol-level and live in repro_torch.core.lanes (shared
# with the differential replay harness without any core -> serve import);
# re-exported here because they are part of this bridge's public surface.
from repro_torch.core.lanes import (                                    # noqa: F401
    ABD_PLANES, LOG_OPS, RMW_OPS, TALLY_PLANES, TS_OPS, VALUE_OPS,
    ShardMap, action_payload, kv_to_lanes, lanes_to_kv, load_abd_round,
    load_rmw_round, log_too_low_reply, lower_acc_reply, msg_to_lanes,
    reply_from_lanes, reply_to_lanes,
)
from repro_torch.core.types import KVPair
from repro_torch.device import DeviceLike

from .cluster_engine import KV_DEFAULTS, PlaneStack

I32 = np.int32


# ---------------------------------------------------------------------------
# The KV gather-scatter bridge: one machine's row of the stacked planes
# ---------------------------------------------------------------------------

class KVBridge:
    """One machine's KV-pair state: a row of the cluster's PlaneStack,
    with scalar checkout views.

    Quacks like the ``Dict[int, KVPair]`` the scalar machine host code uses
    (``get`` always materializes a lane view — a fresh lane *is* a default
    ``KVPair``, so create-on-read matches ``handlers.get_kv`` exactly).
    Checked-out views stay live and mutable until the next fused engine
    step: the engine calls :meth:`flush` (scatter back) on *every* bridge
    sharing the stack before stepping, and :meth:`drop_views` after
    absorbing the output (the views would be stale).

    Lane count grows on demand in powers of two, so growth is rare;
    growth is shared — all machines' rows grow together, which is exactly
    the fused layout's point.

    A bridge constructed without an explicit stack (unit tests, standalone
    machines) owns a private single-row stack; :meth:`ClusterEngine.adopt
    <repro_torch.serve.paxos.cluster_engine.ClusterEngine.adopt>` migrates the
    row into the shared stack.
    """

    def __init__(self, n_keys: int = 8, *, stack: Optional[PlaneStack] = None,
                 mi: int = 0, shards: int = 1, device: DeviceLike = None):
        if stack is None:
            stack = PlaneStack(vector.KVTable._fields, KV_DEFAULTS,
                               1, max(8, n_keys), n_shards=shards,
                               device=device)
            mi = 0
        self._stack = stack
        self._mi = mi
        self._views: Dict[int, KVPair] = {}
        # sharded registry mirror: per shard, the highest rmw-id counter
        # registered by commits that landed in that shard's lane block
        # (gsess -> counter).  The machine-global scalar registry is the
        # cross-shard max-merge of these journals plus snapshot state —
        # see ClusterEngine._run_receiver's scatter.
        self.reg_mirror: List[Dict[int, int]] = [
            {} for _ in range(self._stack.n_shards)]

    @property
    def planes(self) -> Dict[str, np.ndarray]:
        """Mutable host views of this machine's KV row (pulls device
        state and marks the stack for re-upload)."""
        return self._stack.write_views(self._mi)

    @property
    def n_keys(self) -> int:
        return self._stack.n_lanes

    # -- shard layout ---------------------------------------------------------

    @property
    def shard_map(self) -> ShardMap:
        """Key→shard steering over the stack's current lane axis."""
        return self._stack.shard_map

    def shard_planes(self, shard: int) -> Dict[str, np.ndarray]:
        """Mutable host views of one *shard block* of this machine's KV
        row — the per-shard plane set (checkpointing serializes these;
        per-shard host writes mark only that block dirty)."""
        sl = self.shard_map.slice_of(shard)
        planes = self._stack.write_views(self._mi)
        self._stack.mark_shard_dirty(shard)
        return {f: planes[f][sl] for f in self._stack.fields}

    def shard_view(self, shard: int) -> "ShardedKVView":
        """A checkout view restricted to ``shard``'s keys: foreign-shard
        checkouts raise a loud ``ValueError`` (a silent cross-shard write
        would corrupt another shard's plane block without failing any
        checker)."""
        return ShardedKVView(self, shard)

    def note_registration(self, shard: int, gsess: int, cnt: int) -> None:
        """Journal a commit registration into its shard's mirror."""
        while shard >= len(self.reg_mirror):     # stack shard growth
            self.reg_mirror.append({})
        mirror = self.reg_mirror[shard]
        if cnt > mirror.get(gsess, -1):
            mirror[gsess] = cnt

    def ensure(self, key: int) -> None:
        """Grow the stack's lane axis (power-of-two) to cover ``key``."""
        if key < 0:
            raise KeyError(f"negative key {key}")
        n = self.n_keys
        if key < n:
            return
        new_n = n
        while key >= new_n:
            new_n *= 2
        self._stack.grow(n_lanes=new_n)

    # -- dict-of-KVPair protocol (what handlers.get_kv / host code uses) ----

    def get(self, key: int, default=None):
        del default                      # a fresh lane IS a default KVPair
        return self[key]

    def __getitem__(self, key: int) -> KVPair:
        kv = self._views.get(key)
        if kv is None:
            self.ensure(key)
            kv = self._views[key] = lanes_to_kv(
                self._stack.read_views(self._mi), key)
        return kv

    def __setitem__(self, key: int, kv: KVPair) -> None:
        self.ensure(key)
        self._views[key] = kv

    def __contains__(self, key: int) -> bool:
        return 0 <= key < self.n_keys

    def keys(self):
        return range(self.n_keys)

    # -- whole-row access (snapshot catch-up) --------------------------------

    def row_columns(self) -> Dict[str, np.ndarray]:
        """A copy of this machine's whole KV row, field -> int32 column
        over every lane, with the checked-out views laid over it: what
        reading each key through ``self[key]`` gives, without checking out
        a pair per lane (the host mirror is pulled first if a wave left it
        stale)."""
        planes = self._stack.read_views(self._mi)
        cols = {f: planes[f].copy() for f in self._stack.fields}
        for key, kv in self._views.items():
            for f, v in kv_to_lanes(kv).items():
                cols[f][key] = v
        return cols

    def write_row_columns(self, keys: np.ndarray,
                          cols: Dict[str, np.ndarray]) -> None:
        """Write field -> column ``cols`` into the row at ``keys`` (only
        those lanes upload at the next engine step).  Checked-out views of
        those keys are dropped: they would scatter stale pairs back."""
        keys = np.asarray(keys, np.int64)
        if not len(keys):
            return
        self.ensure(int(keys.max()))
        if self._views:
            hit = np.isin(np.fromiter(self._views, np.int64,
                                      len(self._views)), keys)
            for key in [k for k, h in zip(list(self._views), hit) if h]:
                del self._views[key]
        self._stack.write_lanes(
            self._mi, keys,
            np.stack([np.asarray(cols[f], I32) for f in self._stack.fields]))

    # -- engine boundary ------------------------------------------------------

    def flush(self) -> None:
        """Scatter every checked-out view back into the row's planes (only
        those lanes are marked for upload)."""
        if not self._views:
            return
        keys = np.fromiter(self._views.keys(), np.int64, len(self._views))
        cols = np.array([[kv_to_lanes(kv)[f] for f in self._stack.fields]
                         for kv in self._views.values()], I32).T
        self._stack.write_lanes(self._mi, keys, cols)

    def drop_views(self) -> None:
        """Invalidate checkouts after the engine replaced the planes."""
        self._views.clear()


class ShardedKVView:
    """One shard's restriction of a :class:`KVBridge`.

    Shares the parent bridge's checkout cache (so the engine's
    flush/drop_views discipline covers it), but any access to a key steered
    to a foreign shard raises ``ValueError`` loudly — the guard the sharded
    serve path and checkpointing use to make mis-steering impossible to
    miss.
    """

    def __init__(self, bridge: KVBridge, shard: int):
        n_shards = bridge.shard_map.n_shards
        if not 0 <= shard < n_shards:
            raise ValueError(f"no shard {shard} in a {n_shards}-way layout")
        self._bridge = bridge
        self.shard = shard

    def _check(self, key: int) -> None:
        owner = self._bridge.shard_map.shard_of(key)
        if owner != self.shard:
            raise ValueError(
                f"key {key} is steered to shard {owner}, not shard "
                f"{self.shard}: cross-shard checkout would write a foreign "
                f"plane block")

    def get(self, key: int, default=None):
        del default
        return self[key]

    def __getitem__(self, key: int) -> KVPair:
        self._check(key)
        return self._bridge[key]

    def __setitem__(self, key: int, kv: KVPair) -> None:
        self._check(key)
        self._bridge[key] = kv

    def __contains__(self, key: int) -> bool:
        return (0 <= key < self._bridge.n_keys
                and self._bridge.shard_map.shard_of(key) == self.shard)

    def keys(self):
        sl = self._bridge.shard_map.slice_of(self.shard)
        return range(sl.start, sl.stop)

    @property
    def planes(self) -> Dict[str, np.ndarray]:
        return self._bridge.shard_planes(self.shard)


# ---------------------------------------------------------------------------
# lid -> (machine, lane) reply steering
# ---------------------------------------------------------------------------

class SteeringTable:
    """Routes network replies into ProposerTable session lanes (§3.1.2).

    Lids encode their issuing session in the low 16 bits (see
    ``Machine._new_lid``); the table tracks which lids are *live* per lane
    (current RMW round + current ABD round) purely for observability — the
    engine's lid/phase gates are what actually drop stale replies, exactly
    like the scalar tally's ``le.lid`` check.

    With the fused :class:`~.cluster_engine.ClusterEngine`, a steering
    target is a *coordinate* into the stacked planes: the table carries its
    machine's row (``mid``) so :meth:`coords` names the exact
    ``(machine row, lane)`` slot a reply folds into.
    """

    def __init__(self, n_lanes: int, mid: int = 0,
                 shard_map: Optional[ShardMap] = None):
        self.n_lanes = n_lanes
        self.mid = mid
        # session→shard steering: which shard block of the stacked
        # ProposerTable each session lane lives in (None = unsharded)
        self.shard_map = shard_map
        if shard_map is not None and shard_map.n_lanes != n_lanes:
            raise ValueError(
                f"shard map covers {shard_map.n_lanes} lanes, steering "
                f"table has {n_lanes}")
        self._live: List[List[int]] = [[0, 0] for _ in range(n_lanes)]
        self.epoch = 0
        self.stats = {"steered": 0, "dropped": 0, "stale": 0,
                      "view_remaps": 0}

    def shard_of(self, lid: int) -> Optional[int]:
        """The issuer shard a reply lid steers to (None when unsharded
        or unroutable)."""
        if self.shard_map is None:
            return None
        lane = lid & 0xFFFF
        if not 0 <= lane < self.n_lanes:
            return None
        return self.shard_map.shard_of(lane)

    def remap(self, epoch: int,
              shard_map: Optional[ShardMap] = None) -> None:
        """Note a view install.  Lids are machine-local (they encode the
        issuing session, not the membership), so routing is unchanged
        across views — cross-epoch replies are fenced *before* steering
        (``Machine._admit``); this tracks the epoch for stats and, when a
        shard map is supplied, re-checks the session→shard steering: a
        remap that would move any *live* lane's lid to a foreign shard
        raises a loud ``ValueError`` (lids already in flight would fold
        into another shard's plane block)."""
        if shard_map is not None:
            old = self.shard_map
            if old is not None:
                for lane, live in enumerate(self._live):
                    if not any(live):
                        continue
                    if shard_map.shard_of(lane) != old.shard_of(lane):
                        raise ValueError(
                            f"view remap steers live session lane {lane} "
                            f"(lids {live}) from shard "
                            f"{old.shard_of(lane)} to foreign shard "
                            f"{shard_map.shard_of(lane)}")
            self.shard_map = shard_map
        if epoch != self.epoch:
            self.epoch = epoch
            self.stats["view_remaps"] += 1

    def register(self, lane: int, lid: int, abd: bool = False) -> None:
        if 0 <= lane < self.n_lanes:
            self._live[lane][1 if abd else 0] = lid

    def lane_of(self, lid: int) -> Optional[int]:
        """The ProposerTable lane for a reply lid; None = drop (unroutable,
        e.g. a reply to a session of a previous incarnation layout)."""
        lane = lid & 0xFFFF
        if not 0 <= lane < self.n_lanes:
            self.stats["dropped"] += 1
            return None
        self.stats["steered"] += 1
        if lid not in self._live[lane]:
            self.stats["stale"] += 1     # engine lid-gates it to a no-op
        return lane

    def coords(self, lid: int) -> Optional[Tuple[int, int]]:
        """The ``(machine row, lane)`` stacked-plane coordinate for a
        reply lid; None = drop."""
        lane = self.lane_of(lid)
        return None if lane is None else (self.mid, lane)
