"""PaxosRegistry — the paper's replicated RMW-KVS as the training fleet's
coordination service.

This is where the paper's contribution plugs into the framework: a
leaderless, majority-replicated register that stays available through any
minority of node failures *without an election timeout* (§1) — exactly the
property a 1000+-node training control plane needs.

Facade API (synchronous; drives the replicated cluster to completion):

  * ``cas / faa / swap / fetch`` — consensus RMWs (exactly-once; §4-§8)
  * ``write / read``            — ABD fast paths via carstamps (§10-§11)

plus the four coordination patterns the trainer uses:

  * checkpoint commits   (CAS on ``ckpt/<run>/latest``)
  * data-shard cursors   (FAA leases — each batch handed out exactly once)
  * membership epochs    (CAS; readers use the 25x-cheaper ABD read)
  * straggler backup     (CAS grant — first executor wins, losers discard)

In production each trainer node embeds a replica and the transport is the
datacenter network; here the cluster runs in-process on the simulator,
which preserves the asynchrony model (delays/drops/crashes) for testing.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, Optional, Tuple

from repro_torch.core.node import ProtocolConfig, ReqKind, Request
from repro_torch.core.sim import Cluster, NetConfig
from repro_torch.core.types import RmwOp


class PaxosRegistry:
    def __init__(self, n_machines: int = 5, *, all_aboard: bool = True,
                 net: Optional[NetConfig] = None, sessions: int = 8,
                 machine_cls: Optional[type] = None,
                 reconfig: bool = False, shards: int = 1):
        """``machine_cls`` selects the replica implementation — pass
        :class:`repro_torch.serve.paxos.BatchedMachine` to serve every
        coordination op through the batched two-engine path.
        ``reconfig=True`` governs membership by the config-register view
        (live :meth:`add_replica` / :meth:`remove_replica`).
        ``shards`` splits every replica's state plane into that many
        lane blocks (forwarded to the machine class); session picks then
        steer across shard rows — see :meth:`_pick`."""
        if shards > 1 and machine_cls is None:
            raise ValueError(
                "shards > 1 needs a shard-aware machine_cls "
                "(repro_torch.serve.paxos.BatchedMachine)")
        self.shards = max(1, int(shards))
        if machine_cls is None:
            kw = {}
        elif self.shards > 1:
            kw = {"machine_cls": functools.partial(machine_cls,
                                                   shards=self.shards)}
        else:
            kw = {"machine_cls": machine_cls}
        self.cluster = Cluster(
            ProtocolConfig(n_machines=n_machines,
                           sessions_per_machine=sessions,
                           all_aboard=all_aboard, reconfig=reconfig),
            net or NetConfig(seed=0), **kw)
        self._rr = itertools.count()
        self._keys: Dict[str, int] = {}
        # name -> key starts at 1: key 0 is the reserved config register
        self._next_key = itertools.count(1)

    # -- key namespace ---------------------------------------------------------

    def key(self, name: str) -> int:
        if name not in self._keys:
            self._keys[name] = next(self._next_key)
        return self._keys[name]

    # -- driving -----------------------------------------------------------------

    def _run(self, mid: int, sess: int, req: Request):
        tag = self.cluster.submit(mid, sess, req)
        for _ in range(200_000):
            self.cluster.step()
            done = [c for (m, s, c) in self.cluster.completions
                    if c.tag == tag]
            if done:
                return done[0]
        raise TimeoutError("coordination op did not complete (majority up?)")

    def _pick(self) -> Tuple[int, int]:
        cfg = self.cluster.cfg
        members = self.cluster.active_view.members
        spp = cfg.sessions_per_machine
        # session -> shard steering: session lanes are block-partitioned
        # over shard rows, so walk the shard blocks round-robin — two
        # consecutive coordination ops land on distinct issuer shard rows
        # (spreads fused-issuer occupancy across the mesh).  Unsharded
        # (or non-divisible) this degenerates to the classic j % spp walk.
        shards = self.shards if spp % self.shards == 0 else 1
        width = spp // shards
        for _ in range(len(members)):
            i = next(self._rr)
            mid = members[i % len(members)]
            m = (self.cluster.machines[mid]
                 if mid < len(self.cluster.machines) else None)
            if m is not None and m.alive and not m.retired and not m.syncing:
                j = i // len(members)
                sess = (j % shards) * width + (j // shards) % width
                return mid, sess
        raise RuntimeError("no live machines")

    # -- RMW API -------------------------------------------------------------------

    def cas(self, name: str, expect: int, new: int) -> Tuple[bool, int]:
        """Compare-and-swap; returns (won, previous value)."""
        mid, sess = self._pick()
        c = self._run(mid, sess, Request(ReqKind.RMW, self.key(name),
                                         op=RmwOp.CAS, arg1=expect,
                                         arg2=new))
        return c.value == expect, c.value

    def faa(self, name: str, delta: int = 1) -> int:
        """Fetch-and-add; returns the pre-increment value."""
        mid, sess = self._pick()
        c = self._run(mid, sess, Request(ReqKind.RMW, self.key(name),
                                         op=RmwOp.FAA, arg1=delta))
        return c.value

    def swap(self, name: str, new: int) -> int:
        mid, sess = self._pick()
        c = self._run(mid, sess, Request(ReqKind.RMW, self.key(name),
                                         op=RmwOp.SWAP, arg1=new))
        return c.value

    def fetch(self, name: str) -> int:
        """Consensus read (identity RMW) — linearizes against helpers."""
        mid, sess = self._pick()
        c = self._run(mid, sess, Request(ReqKind.RMW, self.key(name),
                                         op=RmwOp.FETCH))
        return c.value

    # -- ABD fast paths ---------------------------------------------------------------

    def write(self, name: str, value: int) -> None:
        mid, sess = self._pick()
        self._run(mid, sess, Request(ReqKind.WRITE, self.key(name),
                                     value=value))

    def read(self, name: str) -> int:
        mid, sess = self._pick()
        return self._run(mid, sess, Request(ReqKind.READ,
                                            self.key(name))).value

    # -- fault injection (tests / drills) ------------------------------------------------

    def crash(self, mid: int) -> None:
        self.cluster.crash(mid)

    def restart(self, mid: int) -> None:
        self.cluster.restart(mid)

    # -- live reconfiguration (requires reconfig=True) -----------------------

    def add_replica(self, mid: Optional[int] = None) -> int:
        """Grow the membership by one replica (CP-decided view change +
        snapshot catch-up); returns the joined machine id."""
        return self.cluster.join(mid)

    def remove_replica(self, mid: int) -> None:
        """Shrink the membership by one replica (the machine retires once
        it installs the new view; traffic to it is fenced)."""
        self.cluster.leave(mid)

    # -- coordination patterns -------------------------------------------------------------

    def commit_checkpoint(self, run: str, step: int) -> bool:
        """Advance ckpt/<run>/latest to ``step`` iff it is newer (CAS loop).
        Exactly-once: a restarted trainer can never double-commit."""
        key = f"ckpt/{run}/latest"
        while True:
            cur = self.fetch(key)
            if cur >= step:
                return False
            won, _ = self.cas(key, cur, step)
            if won:
                return True

    def latest_checkpoint(self, run: str) -> int:
        return self.read(f"ckpt/{run}/latest")

    def claim_shard(self, run: str) -> int:
        """Exactly-once data-shard lease (FAA cursor)."""
        return self.faa(f"data/{run}/cursor")

    def join_membership(self, run: str, node_bit: int) -> int:
        """Set our bit in the membership word; returns the new epoch word."""
        key = f"member/{run}"
        while True:
            cur = self.fetch(key)
            new = cur | (1 << node_bit)
            if new == cur:
                return cur
            won, _ = self.cas(key, cur, new)
            if won:
                return new

    def leave_membership(self, run: str, node_bit: int) -> int:
        key = f"member/{run}"
        while True:
            cur = self.fetch(key)
            new = cur & ~(1 << node_bit)
            if new == cur:
                return cur
            won, _ = self.cas(key, cur, new)
            if won:
                return new

    def membership(self, run: str) -> int:
        return self.read(f"member/{run}")

    def claim_backup(self, run: str, step: int, node: int) -> bool:
        """Straggler mitigation: first of the competing executors to CAS
        the step's grant wins; the loser discards its work."""
        won, _ = self.cas(f"backup/{run}/{step}", 0, node + 1)
        return won
