"""ClusterEngine: one device-resident fused tick for every replica (torch).

Port of ``repro.serve.paxos.cluster_engine``.  All N replicas' receiver
``KVTable`` planes and issuer ``ProposerTable`` lanes live in two
:class:`PlaneStack`\\ s with a leading machine axis — ``(18, M, K)`` KV
ints and ``(65, M, S)`` proposer ints — resident on the engine's device,
and :meth:`ClusterEngine.step_all` advances every machine's tick generator
in waves: each wave runs one fused receiver call (the ``paxos_apply``
kernel over the flattened ``(M·K,)`` lanes) and/or one fused issuer call
(``paxos_propose_staged`` over the wave's staged session lanes), then
resumes the generators in mid order with views of their row of the
outputs.  Host code — KV-coupled decisions, the registry scatter, wire
I/O — runs between waves through the unchanged scalar paths, and sends
are buffered per machine and flushed in mid order so the network RNG
draws exactly as the sequential loop's.

What differs from the reference, and why it changes no result:

* **No donation.**  Torch cannot donate a buffer to a kernel.  The
  receiver step writes the KV stack's second device buffer (``spare``) and
  :meth:`PlaneStack.absorb` swaps the two.
* **The issuer wave updates in place, on its staged lanes only.**  An idle
  reply lane leaves its proposer lane bit-identical and decides WAIT, so
  the staged-lane entry computes what the reference's whole-stack step
  does.  A wave packs its ``(machine, lane, 13 reply values)`` columns into
  one pinned host buffer and is one upload, one ``paxos_propose_staged``
  launch (in place on the resident table) and one download of the actions
  and the 44 changed planes, which :meth:`PlaneStack.absorb_in_place`
  writes into the host mirror: host and device then agree on every lane.
* **Lane-granular transfers.**  The reference re-uploads the whole message
  staging stack and downloads the whole reply stack every wave, pulls the
  whole KV stack on any host checkout and re-uploads it after any flush —
  at 5 replicas × 2^20 keys that is up to ~1.26 GB across PCIe a wave.
  Here the message staging stack is device-resident (NOOP by default):
  a receiver wave uploads only its staged ``(machine, lane)`` columns
  (``index_put_``), resets them after the call, and downloads only the
  staged lanes' reply columns into a persistent host buffer that
  ``reply_from_lanes`` reads (it reads staged lanes only); an issuer wave
  moves its staged lanes alone, as above.  Host KV writes upload only the
  lanes a bridge flushed, and a receiver wave brings its staged lanes'
  new KV planes down with their replies, in the same download.  This is exact because a NOOP message lane (kind 0) and an idle
  reply lane (kind -1) leave their KV/proposer lane bit-identical — the
  same property the reference's fused waves rest on, pinned by
  ``tests/test_torch_cluster_engine.py`` (host mirror == device stack
  after every tick).  So a wave leaves nothing on the device for the host
  to fetch later.
* **Kernels read the stacks in place.**  ``(F, M, K)`` views flatten to
  ``(F, M·K)`` without a copy; the kernels mask the ragged end by lane
  index, so there is no segment padding and ``shard_lanes`` plays no role
  in the kernels.
* **Lane blocks over ranks, not devices of one controller.**  The
  reference places its stacks on a ``"shard"`` device mesh of one process
  (:func:`_shard_mesh`).  Here the mesh is a ``torch.distributed`` group
  of ``shards`` ranks, every rank running the same host program (the
  seeded cluster, machines, scheduler and bridges).  Each rank's device
  holds only its lane block of each stack whose lane axis the group
  divides (:meth:`PlaneStack.set_mesh`), and launches the kernels on it;
  the compact columns a wave brings down are exchanged in one all-gather
  over a gloo group, so every rank's host mirror stays whole and equal.
  Without a group (one process) the engine is rank 0 of a group of one:
  its block is every lane, one launch a wave streams all of them, and
  there is nothing to gather.

Crash/restart evict or (re)load **one row**: :meth:`ClusterEngine.adopt`
copies the machine's planes into its slice (volatile issuer lanes reset on
restart, durable KV carried by the shared bridge).
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import proposer_vector, vector
from repro_torch.core.lanes import (
    ShardMap, kv_to_lanes, msg_to_lanes, reply_to_lanes,
)
from repro_torch.core.types import KVPair
from repro_torch.device import DeviceLike, int32_planes, resolve_device
from repro_torch.kernels.paxos_apply.ops import paxos_apply
from repro_torch.kernels.paxos_propose.ops import (
    CHANGED_ROWS, N_OUT, N_PAR, N_STAGED, paxos_propose, paxos_propose_staged,
)
from repro_torch.parallel.sharding import MeshShape, NamedSharding, resolve

I32 = np.int32

N_KV = len(vector.KVTable._fields)                  # 18
N_MSG = len(vector.MsgBatch._fields)                # 11
N_REP = len(vector.ReplyBatch._fields)              # 11
N_TAB = len(proposer_vector.ProposerTable._fields)  # 65
N_IREP = len(proposer_vector.IssuerReplyBatch._fields)  # 13
N_ACT = len(proposer_vector.ActionBatch._fields)    # 14
N_MSGREG = N_MSG + 1                    # 11 message planes + is_registered

KV_DEFAULTS = kv_to_lanes(KVPair(key=0))

_MSG_IDX = {f: i for i, f in enumerate(vector.MsgBatch._fields)}
_KV_ROWS = np.arange(N_KV)

# an unstaged message lane is a NOOP (kind=0, has_value=1, not registered)
_NOOP_COL = np.zeros((N_MSGREG,), I32)
_NOOP_COL[_MSG_IDX["has_value"]] = 1


def _host_array(shape, device: torch.device) -> np.ndarray:
    """A host int32 array; page-locked when it mirrors a CUDA stack so
    uploads and pulls run at full PCIe rate."""
    return _host_tensor(shape, device).numpy()


def _host_tensor(shape, device: torch.device) -> torch.Tensor:
    """A host int32 tensor, page-locked when it feeds a CUDA device (its
    copies can then run without a staging copy and ``non_blocking``)."""
    return torch.empty(shape, dtype=torch.int32,
                       pin_memory=device.type == "cuda")


def _coords(mi: List[int], lanes: List[int], cols: np.ndarray,
            device: torch.device) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Upload ``(machine, lane)`` coordinates and their value columns in one
    host->device copy; returns (mi, lane, values) device tensors."""
    packed = np.empty((2 + cols.shape[0], len(mi)), I32)
    packed[0] = mi
    packed[1] = lanes
    packed[2:] = cols
    dev = torch.from_numpy(packed).to(device)
    return dev[0].long(), dev[1].long(), dev[2:]


# ---------------------------------------------------------------------------
# the shard group: lane blocks over the ranks of a process group
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """This rank's place in a ``"shard"`` group of ``world`` ranks, and the
    gloo group the engine's collectives run on (host tensors, so they work
    the same under a gloo or an NCCL default group, and with every rank on
    one card)."""
    rank: int
    world: int
    group: object

    @property
    def mesh(self) -> MeshShape:
        """The 1-D ``"shard"`` mesh the sharding rules resolve over."""
        return MeshShape(("shard",), (self.world,))


# (default group, its gloo twin): ``dist.new_group`` is a collective call,
# and every machine first builds a private engine before the cluster's
# shared one, so the twin is made once a process and reused
_GLOO: Optional[Tuple[object, object]] = None


def _shard_mesh(shards: int) -> Optional[ShardGroup]:
    """The shard group of this rank, or ``None`` when sharding is off or
    no process group is initialised (the one-process layout: one device
    tensor holds every lane block).

    Every rank runs the same host program, so the group's world size must
    be ``shards``: a rank with no lane block has no counterpart in a
    replicated program, and a mismatch raises ``ValueError``."""
    if shards <= 1 or not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    if world != shards:
        raise ValueError(f"shards={shards}, but the process group has "
                         f"{world} ranks: each rank holds one lane block")
    global _GLOO
    if _GLOO is None or _GLOO[0] is not dist.group.WORLD:
        _GLOO = (dist.group.WORLD, dist.new_group(backend="gloo"))
    return ShardGroup(dist.get_rank(), world, _GLOO[1])


# ---------------------------------------------------------------------------
# PlaneStack: a device-resident (fields, machines, lanes) int32 block
# ---------------------------------------------------------------------------

class PlaneStack:
    """Struct-of-arrays planes for the whole cluster, resident on device.

    One packed ``(F, M, L)`` int32 tensor holds field ``f`` of machine
    ``m`` at lane ``l``, with a host numpy mirror (pinned for a CUDA
    stack).  Coherence between the two:

    * ``host_dirty`` — whole-row host writes (:meth:`write_views`, row
      reloads) not yet uploaded: the next :meth:`push` re-uploads the
      whole stack.  Tracked per shard block (:attr:`shard_dirty`).  A new
      stack, and the lanes growth adds, start at the field defaults on
      both sides, so neither costs an upload.
    * dirty lanes — single lanes written through :meth:`write_lanes` (the
      bridge's flush) or :meth:`write_lane_views` (issuer round loads): the
      next :meth:`push` uploads only those columns.
    * fused steps — a step brings its staged lanes' new planes down
      itself and :meth:`absorb_in_place` writes them into the mirror
      (every other lane is bit-identical, see the module docstring), so
      host and device agree after every step and nothing is left to pull.

    ``syncs`` counts uploads, ``reloads`` row evict/reloads, and
    ``h2d_bytes``/``d2h_bytes`` the bytes of the stack's planes each
    direction moved.

    **Shard group.**  :meth:`set_mesh` places the device stack on a
    :class:`ShardGroup`: the device then holds only this rank's
    :attr:`block` of lanes, ``(F, M, L/S)``, while the host mirror stays
    whole (every rank's equal).  Host writes and dirtiness stay in global
    lane coordinates; :meth:`push` uploads the block, or the dirty lanes
    that fall in it at block-local coordinates, and a fused step's
    coordinates are block-local.  Without a group the block is every lane.
    """

    # a fused step brings its staged lanes down itself (see above): the
    # device never holds lanes the host mirror lacks
    dev_fresh = False

    def __init__(self, fields: Tuple[str, ...], defaults: Dict[str, int],
                 n_machines: int, n_lanes: int, n_shards: int = 1,
                 device: DeviceLike = None):
        self.fields = tuple(fields)
        self.device = resolve_device(device)
        self.n_shards = max(1, n_shards)
        n_lanes = ShardMap(self.n_shards, self.n_shards).aligned(n_lanes)
        self._defaults = np.array([defaults[f] for f in self.fields], I32)
        self.host = _host_array((len(self.fields), n_machines, n_lanes),
                                self.device)
        self.host[:] = self._defaults[:, None, None]
        self.dev = self._default_stack(self.host.shape)
        self.spare: Optional[torch.Tensor] = None
        self.shard_dirty = np.zeros(self.n_shards, dtype=bool)
        self._dirty_lanes: List[Tuple[int, np.ndarray]] = []
        self.mesh: Optional[ShardGroup] = None
        self._sharding: Optional[NamedSharding] = None
        self._sharding_shape: Optional[Tuple[int, ...]] = None
        self.syncs = 0
        self.reloads = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self._views: List[Dict[str, np.ndarray]] = []
        self._rebuild_views()

    # -- shape ---------------------------------------------------------------

    @property
    def n_machines(self) -> int:
        return self.host.shape[1]

    @property
    def n_lanes(self) -> int:
        return self.host.shape[2]

    @property
    def shard_map(self) -> ShardMap:
        """The key→shard steering for this stack's current lane axis."""
        return ShardMap(self.n_shards, self.n_lanes)

    # -- host dirtiness ------------------------------------------------------

    @property
    def host_dirty(self) -> bool:
        return bool(self.shard_dirty.any())

    @host_dirty.setter
    def host_dirty(self, value: bool) -> None:
        self.shard_dirty[:] = value

    def mark_shard_dirty(self, shard: int) -> None:
        """Record host writes confined to one shard's lane block."""
        self.shard_dirty[shard] = True

    # -- device placement ----------------------------------------------------

    def set_mesh(self, mesh: Optional[ShardGroup]) -> None:
        """Place the device stack on ``mesh``: plane fields and machine
        rows replicate, the lane axis block-partitions over the group's
        ``"shard"`` axis (rule ``"lanes"``), so this rank's device holds
        :attr:`block`.  Resolution is divisibility-aware: a lane axis the
        group does not divide replicates, whole on every rank.  The block
        is uploaded from the host mirror at the next :meth:`push`."""
        self.mesh = mesh
        self._sharding = self._sharding_shape = None
        self._place()

    def device_sharding(self) -> Optional[NamedSharding]:
        """The stack's layout over the shard group (None without one)."""
        if self.mesh is None:
            return None
        if self._sharding_shape != self.host.shape:
            spec = resolve(("plane_fields", "machines", "lanes"),
                           self.mesh.mesh, shape=self.host.shape)
            self._sharding = NamedSharding(self.mesh.mesh, spec)
            self._sharding_shape = self.host.shape
        return self._sharding

    @property
    def lane_sharded(self) -> bool:
        """Whether this rank's device holds one lane block, not all."""
        sharding = self.device_sharding()
        return sharding is not None and sharding.spec[2] is not None

    @property
    def block(self) -> slice:
        """The lanes this rank's device stack holds: its shard's block of
        the current lane axis under a shard group that divides it, else
        every lane."""
        if not self.lane_sharded:
            return slice(0, self.n_lanes)
        return ShardMap(self.mesh.world, self.n_lanes).slice_of(
            self.mesh.rank)

    def _place(self) -> None:
        """A fresh device stack for the current shape and block, filled
        from the host mirror at the next push."""
        blk = self.block
        self.dev = self._default_stack(
            (len(self.fields), self.n_machines, blk.stop - blk.start))
        self.spare = None
        self.host_dirty = True

    def _default_stack(self, shape) -> torch.Tensor:
        """A device stack of ``shape`` holding the field defaults."""
        col = torch.from_numpy(self._defaults).to(self.device)
        return col[:, None, None].expand(shape).contiguous()

    def _rebuild_views(self) -> None:
        self._views = [
            {f: self.host[i, mi] for i, f in enumerate(self.fields)}
            for mi in range(self.n_machines)]

    def grow(self, n_machines: Optional[int] = None,
             n_lanes: Optional[int] = None) -> None:
        """Grow either axis; new rows/lanes start at field defaults.  The
        host mirror grows and the device block is uploaded from it at the
        next :meth:`push`: under a shard group the block boundaries move
        with the lane count (a key can change owner), as the reference
        re-resolves its sharding on a new shape.  Lanes grow by doubling,
        so the uploads add up to at most twice the final stack."""
        new_m = max(self.n_machines, n_machines or 0)
        new_l = ShardMap(self.n_shards, self.n_shards).aligned(
            max(self.n_lanes, n_lanes or 0))
        if (new_m, new_l) == (self.n_machines, self.n_lanes):
            return
        grown = _host_array((len(self.fields), new_m, new_l), self.device)
        grown[:] = self._defaults[:, None, None]
        grown[:, :self.n_machines, :self.n_lanes] = self.host
        self.host = grown
        self._rebuild_views()
        self._place()

    # -- host <-> device coherence -------------------------------------------

    def pull(self) -> None:
        """Sync the host mirror from the device: a no-op, since every fused
        step has already brought its lanes down (see :attr:`dev_fresh`)."""

    def read_views(self, mi: int) -> Dict[str, np.ndarray]:
        """Field -> row-``mi`` lane views, for host reads."""
        return self._views[mi]

    def write_views(self, mi: int) -> Dict[str, np.ndarray]:
        """Like :meth:`read_views`, but marks the stack for a whole
        re-upload (the caller may write any lane)."""
        self.host_dirty = True
        return self._views[mi]

    def write_lane_views(self, mi: int, lane: int) -> Dict[str, np.ndarray]:
        """Row ``mi``'s views for a host write confined to ``lane``: only
        that lane is marked for upload."""
        if not self.host_dirty:
            self._dirty_lanes.append((mi, np.array([lane])))
        return self._views[mi]

    def write_lanes(self, mi: int, lanes: np.ndarray,
                    cols: np.ndarray) -> None:
        """Write ``cols`` ``(F, len(lanes))`` into row ``mi`` at ``lanes``;
        the next push uploads only these columns."""
        self.host[:, mi, lanes] = cols
        if not self.host_dirty:
            self._dirty_lanes.append((mi, lanes))

    def load_row(self, mi: int, src: "PlaneStack", src_mi: int) -> None:
        """Copy machine ``src_mi``'s lanes from ``src`` into row ``mi``
        (growing this stack's lane axis to cover them); lanes past the
        source keep defaults.  Field layouts must match."""
        if src.fields != self.fields:
            raise ValueError("load_row: plane stacks of different layouts")
        if src.n_lanes > self.n_lanes:
            self.grow(n_lanes=src.n_lanes)
        self.host_dirty = True
        self.reloads += 1
        length = src.n_lanes
        if self.n_shards > 1 and length == self.n_lanes:
            sm = self.shard_map
            for s in range(self.n_shards):
                sl = sm.slice_of(s)
                self.host[:, mi, sl] = src.host[:, src_mi, sl]
            return
        self.host[:, mi, :length] = src.host[:, src_mi, :]
        self.host[:, mi, length:] = self._defaults[:, None]

    def push(self) -> torch.Tensor:
        """Upload what the host changed and hand the device stack to a
        fused step, which must write into :meth:`out_buffer` and
        :meth:`absorb`, or update the stack in place and
        :meth:`absorb_in_place`, before any further host access.  Under a
        shard group only this rank's block moves."""
        blk = self.block
        if self.host_dirty:
            self.dev.copy_(torch.from_numpy(self.host[:, :, blk]))
            self.h2d_bytes += self.dev.numel() * self.dev.element_size()
            self.host_dirty = False
            self._dirty_lanes.clear()
            self.syncs += 1
        elif self._dirty_lanes:
            mi = np.concatenate([np.full(len(lanes), m, I32)
                                 for m, lanes in self._dirty_lanes])
            lanes = np.concatenate([lanes for _, lanes in self._dirty_lanes])
            self._dirty_lanes.clear()
            if self.lane_sharded:
                mine = (lanes >= blk.start) & (lanes < blk.stop)
                mi, lanes = mi[mine], lanes[mine]
                if not len(mi):
                    return self.dev
            cols = self.host[:, mi, lanes]
            mi_t, lane_t, cols_t = _coords(mi, lanes - blk.start, cols,
                                           self.device)
            self.dev[:, mi_t, lane_t] = cols_t
            self.h2d_bytes += cols.nbytes + 2 * mi.nbytes
            self.syncs += 1
        return self.dev

    def out_buffer(self) -> torch.Tensor:
        """The second device stack a fused step writes its output into."""
        if self.spare is None or self.spare.shape != self.dev.shape:
            self.spare = torch.empty_like(self.dev)
        return self.spare

    def absorb(self, dev_out: torch.Tensor) -> None:
        """Adopt a fused step's output (written into :meth:`out_buffer`) as
        the new resident state.  The step brings its staged lanes down
        itself, and :meth:`absorb_in_place` writes them into the mirror."""
        if self.host_dirty or self._dirty_lanes:
            raise RuntimeError("host writes raced a fused step; push() "
                               "must precede absorb()")
        self.spare, self.dev = self.dev, dev_out

    def absorb_in_place(self, rows: np.ndarray, mi: np.ndarray,
                        lanes: np.ndarray, cols: np.ndarray) -> None:
        """Adopt a fused step that updated the device stack in place (the
        stack :meth:`push` returned), or whose output :meth:`absorb` took,
        at ``(mi, lanes)`` (host coordinates), where
        it changed only the planes ``rows``; ``cols (len(rows), len(mi))``
        are their new values, brought down by the step (from every rank,
        under a shard group).  They go into the host mirror, so host and
        device agree on every lane and nothing is left to pull."""
        if self.host_dirty or self._dirty_lanes:
            raise RuntimeError("host writes raced a fused step; push() "
                               "must precede absorb_in_place()")
        self.host[rows[:, None], mi, lanes] = cols


def stacks_from_numpy(kv, tab, device: DeviceLike = None
                      ) -> Tuple[Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """The reference's numpy plane stacks (``PlaneStack.host`` of the JAX
    engine, or ``np.asarray`` of its stacked planes) as the port's
    ``(18, M, K)`` KV and ``(65, M, S)`` proposer tensors on ``device``
    (fresh copies; ``None`` passes through)."""
    return (None if kv is None else int32_planes(kv, N_KV, device),
            None if tab is None else int32_planes(tab, N_TAB, device))


# ---------------------------------------------------------------------------
# fused step functions
# ---------------------------------------------------------------------------

def _fused_receiver_step(kv_stack: torch.Tensor, msgreg_stack: torch.Tensor,
                         out: Optional[torch.Tensor] = None):
    """One receiver step for every machine: (18,M,K),(12,M,K) ->
    (18,M,K),(11,M,K),(M,K) int32.  The stacks are read in place as
    ``(F, M·K)`` lanes (apply_batch is elementwise, so rows stay isolated
    by construction); the 12th input plane is the host-gathered
    is_registered bit.  ``out`` is the (18,M,K) buffer the new KV planes
    go to (the stack's spare)."""
    _, m, k = kv_stack.shape
    n = m * k
    dev = kv_stack.device
    outs = (out.view(N_KV, n) if out is not None
            else torch.empty((N_KV, n), dtype=torch.int32, device=dev),
            torch.empty((N_REP, n), dtype=torch.int32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev))
    new_kv, rep, mask = paxos_apply(kv_stack.view(N_KV, n),
                                    msgreg_stack.view(N_MSGREG, n), out=outs)
    return new_kv.view(N_KV, m, k), rep.view(N_REP, m, k), mask.view(m, k)


def _fused_issuer_step(tab_stack: torch.Tensor, rep_stack: torch.Tensor,
                       params: torch.Tensor,
                       out: Optional[torch.Tensor] = None):
    """One issuer step for every machine: (65,M,S),(13,M,S),(4,M) ->
    (65,M,S),(14,M,S).  Quorum parameters are per machine row — each
    machine's active view pins its own quorum sizes (§8.7)."""
    _, m, s = tab_stack.shape
    n = m * s
    dev = tab_stack.device
    outs = (out.view(N_TAB, n) if out is not None
            else torch.empty((N_TAB, n), dtype=torch.int32, device=dev),
            torch.empty((N_ACT, n), dtype=torch.int32, device=dev))
    new_tab, act = paxos_propose(tab_stack.view(N_TAB, n),
                                 rep_stack.view(N_IREP, n), params, s,
                                 out=outs)
    return new_tab.view(N_TAB, m, s), act.view(N_ACT, m, s)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

SELECT_NETWORKS = ("paxos_apply", "paxos_propose")


def select_launches() -> Counter:
    """The select networks' launch counters (the staged issuer entry
    counts in ``paxos_propose.launches``); the difference of two readings
    is the launches between them."""
    return Counter(paxos_apply=paxos_apply.launches,
                   paxos_propose=paxos_propose.launches)


def require_launches(launched: Counter, device: DeviceLike) -> None:
    """Raises when a run on a CUDA ``device`` launched a select network
    no time (``launched``: the difference of two :func:`select_launches`
    readings).  On the CPU the wrappers run their plain versions and
    count nothing."""
    if torch.device(device).type != "cuda":
        return
    idle = [k for k in SELECT_NETWORKS if not launched[k]]
    if idle:
        raise AssertionError(f"no launch of {', '.join(idle)} on {device}")


class ClusterEngine:
    """Owns the cluster's stacked planes and drives fused tick waves.

    Machines talk to the engine through a generator protocol: a machine's
    ``_tick_gen()`` yields ``("recv", batch)`` / ``("issuer", batch)``
    requests and is resumed with row views of the fused output planes.
    :meth:`drive` groups concurrently-pending requests of all machines
    into one fused call per kind per wave.

    With ``shards > 1`` the lane axes are kept shard-aligned and the
    staging/occupancy and registry scatter are accounted per shard.  In
    one process one fused call per wave spans every shard.  Inside a
    process group of ``shards`` ranks (:func:`_shard_mesh`) each rank
    holds its lane block of each divisible stack and launches the kernels
    on it; a wave's compact outputs are all-gathered, so the host
    program, replicated on every rank, sees every lane.
    """

    def __init__(self, cfg, n_machines: int = 1, *, n_keys: int = 8,
                 shards: int = 1, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.shards = max(1, int(shards))
        # session lanes shard only when the axis divides evenly; the KV
        # lane axis is kept shard-aligned by the stack itself
        sess = cfg.sessions_per_machine
        self.tab_shards = self.shards if sess % self.shards == 0 else 1
        self.kv = PlaneStack(vector.KVTable._fields, KV_DEFAULTS,
                             max(1, n_machines), max(8, n_keys),
                             n_shards=self.shards, device=self.device)
        self.tab = PlaneStack(proposer_vector.ProposerTable._fields,
                              proposer_vector.TABLE_DEFAULTS,
                              max(1, n_machines), sess,
                              n_shards=self.tab_shards, device=self.device)
        self.mesh = _shard_mesh(self.shards)
        if self.mesh is not None:
            self.kv.set_mesh(self.mesh)
            self.tab.set_mesh(self.mesh)
        self._machines: Dict[int, object] = {}    # mi -> BatchedMachine
        self._bridges: Dict[int, object] = {}     # mi -> its KVBridge
        # the device-resident message staging stack (NOOP between waves)
        # and the host buffer the staged lanes' replies are gathered into
        self._msg_stage: Optional[torch.Tensor] = None
        self._rep_host: Optional[np.ndarray] = None
        self._noop_col = torch.from_numpy(_NOOP_COL).to(self.device)[:, None]
        # the issuer wave's flat buffers: packed staged lanes and the
        # compact output, each pinned on the host and resident on the
        # device; and the host actions the machines read
        self._iss_bufs: Optional[Tuple[torch.Tensor, ...]] = None
        self._act_host: Optional[np.ndarray] = None
        self._params_key = None
        self._params_dev: Optional[torch.Tensor] = None
        # rank_*: this rank's share (all of it without a group); a
        # kernel call on a CUDA device is one launch
        self.stats = {"ticks": 0, "waves": 0, "shards": self.shards,
                      "fused_receiver_calls": 0, "fused_receiver_lanes": 0,
                      "fused_issuer_calls": 0, "fused_issuer_lanes": 0,
                      "receiver_shard_lanes": [0] * self.shards,
                      "issuer_shard_lanes": [0] * self.tab_shards,
                      "shard_registrations": [0] * self.shards,
                      "stage_h2d_bytes": 0, "gather_d2h_bytes": 0,
                      "issuer_wave_syncs": 0,
                      "mesh_world": self.mesh.world if self.mesh else 1,
                      "mesh_rank": self.mesh.rank if self.mesh else 0,
                      "rank_receiver_lanes": 0, "rank_issuer_lanes": 0,
                      "rank_paxos_apply_calls": 0,
                      "rank_paxos_propose_calls": 0,
                      "mesh_gathers": 0, "mesh_gather_bytes": 0,
                      "mesh_gather_s": 0.0}

    # -- telemetry -----------------------------------------------------------

    def telemetry(self) -> Dict[str, object]:
        """``stats`` plus the plane-coherence counters that live on the
        stacks themselves: uploads (``plane_syncs``, split per stack), row
        evict/reloads, and the bytes moved host<->device in all."""
        t = dict(self.stats)
        t["kv_plane_syncs"] = self.kv.syncs
        t["tab_plane_syncs"] = self.tab.syncs
        t["plane_syncs"] = self.kv.syncs + self.tab.syncs
        t["row_reloads"] = self.kv.reloads + self.tab.reloads
        t["transfer_bytes"] = (
            self.stats["stage_h2d_bytes"] + self.stats["gather_d2h_bytes"]
            + self.kv.h2d_bytes + self.kv.d2h_bytes
            + self.tab.h2d_bytes + self.tab.d2h_bytes)
        return t

    # -- shard steering ------------------------------------------------------

    def kv_shard_map(self) -> ShardMap:
        """Key→shard steering over the current KV lane axis."""
        return self.kv.shard_map

    def sess_shard_map(self) -> ShardMap:
        """Session→shard steering over the issuer lane axis."""
        return self.tab.shard_map

    # -- membership ----------------------------------------------------------

    def adopt(self, m) -> None:
        """(Re)bind machine ``m`` to row ``m.mid`` of the stacked planes.

        Loads the row from the machine's current planes: a brand-new or
        restarted machine carries default issuer lanes (volatile proposer
        state is lost on crash), while its KV bridge, if it already shares
        this engine's stack (restart carrying the durable acceptor state),
        is left in place untouched."""
        mi = m.mid
        if mi >= self.kv.n_machines:
            self.kv.grow(n_machines=mi + 1)
            self.tab.grow(n_machines=mi + 1)
        if m._engine is not self:
            if m.kvs._stack is not self.kv:
                self.kv.load_row(mi, m.kvs._stack, m.kvs._mi)
                m.kvs._stack = self.kv
                m.kvs._mi = mi
            self.tab.load_row(mi, m._engine.tab, m._mi)
            m._engine = self
            m._mi = mi
        self._machines[mi] = m
        self._bridges[mi] = m.kvs
        self._params_key = None

    def _params(self) -> torch.Tensor:
        """(4, M) per-machine quorum-parameter block on the device, cached
        until any adopted machine's view-derived quorums change."""
        m_ax = self.tab.n_machines
        key = (m_ax,) + tuple(
            (mi, mach.view.all_aboard_quorum(), mach.view.quorum(),
             mach._commit_need)
            for mi, mach in sorted(self._machines.items()))
        if key != self._params_key:
            p = np.ones((N_PAR, m_ax), I32)
            p[3] = self.cfg.log_too_high_threshold
            for mi, mach in self._machines.items():
                p[0, mi] = mach.view.all_aboard_quorum()
                p[1, mi] = mach.view.quorum()
                p[2, mi] = mach._commit_need
            self._params_dev = torch.from_numpy(p).to(self.device)
            self._params_key = key
        return self._params_dev

    # -- staging buffers (persistent, reset lane-by-lane) --------------------

    def _msg_buffers(self) -> Tuple[torch.Tensor, np.ndarray]:
        """(the device message stack, shaped as this rank's KV block; the
        host reply planes, over every lane)."""
        shape = (self.kv.n_machines, self.kv.n_lanes)
        if self._rep_host is None or self._rep_host.shape[1:] != shape:
            self._msg_stage = self._noop_col[:, :, None].expand(
                N_MSGREG, *self.kv.dev.shape[1:]).contiguous()
            self._rep_host = np.empty((N_REP,) + shape, I32)
        return self._msg_stage, self._rep_host

    def _issuer_buffers(self) -> Tuple[torch.Tensor, ...]:
        """(staged host, staged device, out host, out device): flat int32
        buffers sized for every lane of this rank's table staged at once (a
        wave stages each ``(machine, lane)`` at most once)."""
        cap = self.tab.dev.shape[1] * self.tab.dev.shape[2]
        if self._iss_bufs is None or self._iss_bufs[0].numel() != \
                N_STAGED * cap:
            self._iss_bufs = tuple(
                buf for rows in (N_STAGED, N_OUT) for buf in (
                    _host_tensor((rows * cap,), self.device),
                    torch.empty((rows * cap,), dtype=torch.int32,
                                device=self.device)))
        return self._iss_bufs

    def _owners(self, stack: PlaneStack, lanes: np.ndarray
                ) -> Tuple[Optional[np.ndarray], np.ndarray]:
        """(the rank whose block holds each staged lane, or ``None`` when
        this rank holds every lane of ``stack``; the mask of this rank's
        lanes).  Without a group the engine is rank 0 of a group of one."""
        if not stack.lane_sharded:
            return None, np.ones(len(lanes), dtype=bool)
        blk = stack.block
        owner = lanes // (blk.stop - blk.start)
        return owner, owner == self.mesh.rank

    def _all_gather(self, cols: np.ndarray, owner: np.ndarray) -> np.ndarray:
        """Every rank's compact columns, ``cols (rows, n_r)`` from this
        one, exchanged in one all-gather over the shard group -> ``(rows,
        len(owner))`` in staging order: column ``j`` came from rank
        ``owner[j]``.  Each rank knows every rank's count from the
        replicated staging list, so the buffers pad to the largest."""
        world = self.mesh.world
        counts = np.bincount(owner, minlength=world)
        send = torch.zeros((cols.shape[0], int(counts.max())),
                           dtype=torch.int32)
        send[:, :cols.shape[1]] = torch.from_numpy(cols)
        bufs = [torch.empty_like(send) for _ in range(world)]
        t0 = time.perf_counter()
        dist.all_gather(bufs, send, group=self.mesh.group)
        self.stats["mesh_gather_s"] += time.perf_counter() - t0
        self.stats["mesh_gathers"] += 1
        self.stats["mesh_gather_bytes"] += world * send.numel() * 4
        out = np.empty((cols.shape[0], len(owner)), I32)
        for q, buf in enumerate(bufs):
            out[:, owner == q] = buf[:, :counts[q]].numpy()
        return out

    # -- fused wave execution ------------------------------------------------

    def _run_receiver(self, requests) -> Dict[int, Dict[str, np.ndarray]]:
        """requests: [(machine, [Msg,...]), ...] — one fused call."""
        # every bridge sharing the stack scatters its checked-out views
        # first: the fused call reads the whole stack
        for br in self._bridges.values():
            br.flush()
        fields = vector.MsgBatch._fields
        lps = self.kv.n_lanes // self.shards    # lanes per shard block
        shard_lanes_stat = self.stats["receiver_shard_lanes"]
        cols: List[List[int]] = []
        s_mi: List[int] = []
        s_key: List[int] = []
        for mach, batch in requests:
            mi = mach._mi
            committed = mach.registry.committed
            last = len(committed) - 1
            for msg in batch:
                vals = msg_to_lanes(msg)
                # host mirror of ops.gather_is_registered (clip + compare):
                # packed as the 12th staging plane
                rid = msg.rmw_id
                gs = rid.gsess
                cols.append([vals[f] for f in fields] + [
                    1 if (gs >= 0 and committed[min(gs, last)] >= rid.counter)
                    else 0])
                s_mi.append(mi)
                s_key.append(msg.key)
                shard_lanes_stat[msg.key // lps] += 1
        kv_dev = self.kv.push()
        stage, rep_host = self._msg_buffers()
        staged = np.array(cols, I32).T
        all_mi, all_key = np.array(s_mi, I32), np.array(s_key, I32)
        # this rank stages the lanes of its block, at block offsets, and
        # brings their replies, mask and new KV planes down in one copy
        owner, mine = self._owners(self.kv, all_key)
        mi_a, key_a = all_mi[mine], all_key[mine] - self.kv.block.start
        staged = staged[:, mine]
        self.stats["rank_receiver_lanes"] += len(mi_a)
        got = np.empty((N_REP + 1 + N_KV, 0), I32)
        if len(mi_a):
            mi_t, key_t, vals_t = _coords(mi_a, key_a, staged, self.device)
            self.stats["stage_h2d_bytes"] += staged.nbytes + 8 * len(mi_a)
            stage[:, mi_t, key_t] = vals_t
            out_kv, out_rep, out_mask = _fused_receiver_step(
                kv_dev, stage, out=self.kv.out_buffer())
            self.stats["rank_paxos_apply_calls"] += 1
            # reset to NOOP for the next wave
            stage[:, mi_t, key_t] = self._noop_col
            got = torch.cat([out_rep[:, mi_t, key_t],
                             out_mask[mi_t, key_t][None],
                             out_kv[:, mi_t, key_t]]).cpu().numpy()
            self.kv.absorb(out_kv)
            self.stats["gather_d2h_bytes"] += got[:N_REP + 1].nbytes
            self.kv.d2h_bytes += got[N_REP + 1:].nbytes
        if owner is not None:
            got = self._all_gather(got, owner)
        self.kv.absorb_in_place(_KV_ROWS, all_mi, all_key, got[N_REP + 1:])
        for br in self._bridges.values():
            br.drop_views()              # stale against the new stack
        rep_host[:, s_mi, s_key] = got[:N_REP]
        mask_col = got[N_REP]
        results: Dict[int, Dict[str, np.ndarray]] = {}
        self.stats["fused_receiver_calls"] += 1
        reg_stat = self.stats["shard_registrations"]
        j = 0
        for mach, batch in requests:
            mi = mach._mi
            committed = mach.registry.committed
            for msg in batch:
                # host mirror of ops.scatter_register (max, OOB dropped):
                # a registration born in one shard's lane block max-merges
                # into the machine-global registry every shard's gather
                # reads next wave, journaled in the bridge's shard mirror
                if mask_col[j]:
                    gs = msg.rmw_id.gsess
                    cnt = msg.rmw_id.counter
                    if 0 <= gs < len(committed) and cnt > committed[gs]:
                        committed[gs] = cnt
                    shard = msg.key // lps
                    mach.kvs.note_registration(shard, gs, cnt)
                    reg_stat[shard] += 1
                j += 1
            self.stats["fused_receiver_lanes"] += len(batch)
            results[id(mach)] = {f: rep_host[i, mi] for i, f
                                 in enumerate(vector.ReplyBatch._fields)}
        return results

    def _run_issuer(self, requests) -> Dict[int, Dict[str, np.ndarray]]:
        """requests: [(machine, [(lane, Reply),...]), ...] — one call."""
        fields = proposer_vector.IssuerReplyBatch._fields
        lps = self.tab.n_lanes // self.tab_shards
        shard_lanes_stat = self.stats["issuer_shard_lanes"]
        cols: List[List[int]] = []
        s_mi: List[int] = []
        s_lane: List[int] = []
        for mach, batch in requests:
            mi = mach._mi
            for lane, rep in batch:
                vals = reply_to_lanes(rep)
                cols.append([vals[f] for f in fields])
                s_mi.append(mi)
                s_lane.append(lane)
                shard_lanes_stat[lane // lps] += 1
        got = self.issuer_wave(s_mi, s_lane, np.array(cols, I32).T)
        shape = (N_ACT, self.tab.n_machines, self.tab.n_lanes)
        if self._act_host is None or self._act_host.shape != shape:
            self._act_host = np.empty(shape, I32)
        act_host = self._act_host
        act_host[:, s_mi, s_lane] = got[:N_ACT]
        results: Dict[int, Dict[str, np.ndarray]] = {}
        self.stats["fused_issuer_calls"] += 1
        for mach, batch in requests:
            self.stats["fused_issuer_lanes"] += len(batch)
            results[id(mach)] = {
                f: act_host[i, mach._mi] for i, f
                in enumerate(proposer_vector.ActionBatch._fields)}
        return results

    def issuer_wave(self, s_mi: List[int], s_lane: List[int],
                    replies: np.ndarray) -> np.ndarray:
        """One fused issuer step over the staged lanes ``(s_mi[j],
        s_lane[j])`` with the ``(13, L)`` reply columns ``replies``: one
        upload of the packed lanes, one ``paxos_propose_staged`` launch in
        place on the resident table, one download of the compact ``(14 +
        44, L)`` output and one wait for it.  The changed planes go into
        the table's host mirror; returns the output (a view of a buffer the
        next wave overwrites).  Under a shard group that splits the table
        each rank does this for the lanes of its block, at block offsets,
        and the outputs are all-gathered."""
        tab_dev = self.tab.push()
        mi_a, lane_a = np.asarray(s_mi, I32), np.asarray(s_lane, I32)
        owner, mine = self._owners(self.tab, lane_a)
        got = np.empty((N_OUT, 0), I32)
        if mine.any():
            got = self._issuer_launch(tab_dev, mi_a[mine],
                                      lane_a[mine] - self.tab.block.start,
                                      replies[:, mine])
        if owner is not None:
            got = self._all_gather(got, owner)
        self.tab.absorb_in_place(CHANGED_ROWS, mi_a, lane_a, got[N_ACT:])
        return got

    def _issuer_launch(self, tab_dev: torch.Tensor, s_mi: np.ndarray,
                       s_lane: np.ndarray, replies: np.ndarray) -> np.ndarray:
        """The staged issuer step on this rank's device table at its
        coordinates -> the compact output on the host."""
        n = len(s_mi)
        self.stats["rank_issuer_lanes"] += n
        st_host, st_dev, out_host, out_dev = self._issuer_buffers()
        packed = st_host[:N_STAGED * n].view(N_STAGED, n)
        packed_np = packed.numpy()
        packed_np[0] = s_mi
        packed_np[1] = s_lane
        packed_np[2:] = replies
        staged = st_dev[:N_STAGED * n].view(N_STAGED, n)
        staged.copy_(packed, non_blocking=True)
        self.stats["stage_h2d_bytes"] += packed_np.nbytes
        out = out_dev[:N_OUT * n].view(N_OUT, n)
        paxos_propose_staged(tab_dev.view(N_TAB, -1), staged, self._params(),
                             tab_dev.shape[2], out=out, coords=packed_np[:2])
        self.stats["rank_paxos_propose_calls"] += 1
        got = out_host[:N_OUT * n].view(N_OUT, n)
        got.copy_(out, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.stats["issuer_wave_syncs"] += 1
        got_np = got.numpy()
        self.stats["gather_d2h_bytes"] += got_np.nbytes
        return got_np

    def drive(self, pairs: Iterable[Tuple[object, object]]) -> None:
        """Advance (machine, tick-generator) pairs to completion in waves.

        Each wave collects every pending request, executes at most one
        fused receiver call and one fused issuer call, and resumes the
        generators in the order given (mid order — matching the sequential
        loop's per-machine ordering of host actions)."""
        pending = []
        for mach, gen in pairs:
            try:
                req = next(gen)
            except StopIteration:
                continue
            pending.append((mach, gen, req))
        while pending:
            self.stats["waves"] += 1
            recv = [(m, r[1]) for m, _g, r in pending if r[0] == "recv"]
            iss = [(m, r[1]) for m, _g, r in pending if r[0] == "issuer"]
            results: Dict[int, object] = {}
            if recv:
                results.update(self._run_receiver(recv))
            if iss:
                results.update(self._run_issuer(iss))
            nxt = []
            for mach, gen, _req in pending:
                try:
                    req = gen.send(results[id(mach)])
                except StopIteration:
                    continue
                nxt.append((mach, gen, req))
            pending = nxt

    # -- the cluster tick ----------------------------------------------------

    def step_all(self, machines, net_send) -> None:
        """One fused tick for the whole cluster.

        Sends are buffered per machine during the waves and flushed in mid
        order afterwards, reproducing the sequential loop's global send
        sequence exactly (the network draws RNG per send)."""
        self.stats["ticks"] += 1
        for mach in machines:
            if mach._engine is not self:
                self.adopt(mach)
        buffers: List[List[Tuple[int, int, object]]] = []
        saved = []
        try:
            for mach in machines:
                buf: List[Tuple[int, int, object]] = []
                buffers.append(buf)
                saved.append(mach._send)
                mach._send = (lambda src, dst, payload, _b=buf:
                              _b.append((src, dst, payload)))
            self.drive([(mach, mach._tick_gen()) for mach in machines])
        finally:
            for mach, fn in zip(machines, saved):
                mach._send = fn
        for buf in buffers:
            for src, dst, payload in buf:
                net_send(src, dst, payload)
