"""The reconfiguration controller: view changes as CAS RMWs on the register.

``ReconfigController`` is deployment tooling, not protocol: it reads the
config register with a FETCH RMW, validates the requested membership
delta, and races a CAS (expected = the raw value it read) through the
ordinary proposer path of a member machine.  The register's own
linearizability totally orders concurrent view changes — a lost CAS just
re-reads and retries, exactly like any contended RMW client.

An RMW completion carries the register's *pre-state* (§2: RMWs return
the value read), so ``completion.value == expected`` is precisely "our
CAS won".  The fencing, round restarts and catch-up the new view implies
all happen inside the machines (``Machine._install_view`` /
``begin_catchup``) — the controller only spawns joiner processes
(``Cluster.add_machine``) and issues the register ops.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

from repro_torch.core.node import ReqKind
from repro_torch.core.types import CONFIG_KEY, RmwOp, View

from .views import validate_transition


class ReconfigController:
    """Drives membership changes for one :class:`~repro_torch.core.sim.Cluster`."""

    def __init__(self, cluster):
        if not cluster.cfg.reconfig:
            raise ValueError("cluster was built with reconfig=False: "
                             "membership is fixed by ProtocolConfig")
        self.cluster = cluster

    # -- issuing register RMWs through a member ------------------------------

    def _issuers(self, exclude: Sequence[int] = ()) -> Tuple[int, ...]:
        """Members able to issue a register RMW right now, preferred
        order (excluding e.g. the machine being removed)."""
        cl = self.cluster
        out = []
        for mid in cl.active_view.members:
            if mid in exclude or mid >= len(cl.machines):
                continue
            m = cl.machines[mid]
            if m.alive and not m.retired and not m.syncing:
                out.append(mid)
        if not out:
            raise RuntimeError("no live member can issue the view change")
        return tuple(out)

    def _run_rmw(self, mid: int, op: RmwOp, arg1: int, arg2: int,
                 max_ticks: int):
        """Submit one RMW on the config register and step the cluster
        (load and all) until it completes; returns the Completion or None
        on timeout (issuer crashed / partitioned away)."""
        cl = self.cluster
        sess = cl.cfg.sessions_per_machine - 1
        tag = cl.rmw(mid, sess, CONFIG_KEY, op, arg1=arg1, arg2=arg2)
        for _ in range(max_ticks):
            cl.step()
            for m, s, c in reversed(cl.completions):
                if c.tag == tag:
                    return c
            if not cl.machines[mid].alive or cl.machines[mid].retired:
                return None
        return None

    def _register_op(self, op: RmwOp, arg1: int, arg2: int, *,
                     exclude: Sequence[int] = (),
                     max_ticks: int = 200_000):
        """Run a register RMW, failing over across member issuers."""
        for mid in self._issuers(exclude):
            c = self._run_rmw(mid, op, arg1, arg2, max_ticks)
            if c is not None:
                return c
        raise RuntimeError(
            f"config-register {op.name} did not complete on any member")

    # -- public API ----------------------------------------------------------

    def current(self, *, exclude: Sequence[int] = (),
                max_ticks: int = 200_000) -> Tuple[int, View]:
        """Read the register: returns ``(raw value, decoded view)`` (raw 0
        = never written, decoded as the initial view)."""
        c = self._register_op(RmwOp.FETCH, 0, 0, exclude=exclude,
                              max_ticks=max_ticks)
        raw = c.value
        view = View.decode(raw) or View.initial(self.cluster.cfg.n_machines)
        return raw, view

    def propose(self, new_members: Iterable[int], *,
                exclude: Sequence[int] = (),
                max_ticks: int = 200_000) -> View:
        """CAS the register to a view with ``new_members``; retries lost
        races until the transition is applied (or made redundant)."""
        wanted = tuple(sorted(set(new_members)))
        while True:
            raw, cur = self.current(exclude=exclude, max_ticks=max_ticks)
            if cur.members == wanted:
                return cur                       # someone beat us to it
            new = validate_transition(cur, wanted)
            c = self._register_op(RmwOp.CAS, raw, new.encode(),
                                  exclude=exclude, max_ticks=max_ticks)
            if c.value == raw:                   # pre-state matched: we won
                return new
            # lost the race: re-read and re-validate against the winner

    def join(self, mid: Optional[int] = None, *,
             max_ticks: int = 200_000) -> int:
        """Add machine ``mid`` (default: lowest free id) to the membership.

        Spawn-first order: the joiner process starts in catch-up mode
        (snapshot via JOIN_REQ/SYNC, the view-exempt plane) while the view
        change races through the register, so by the time members start
        routing to it, it can vote.
        """
        cl = self.cluster
        cur = cl.active_view
        if mid is None:
            free = [i for i in range(cl.cfg.capacity)
                    if i not in cur.members]
            if not free:
                raise RuntimeError("no free machine id to join")
            mid = free[0]
        validate_transition(cur, cur.members + (mid,))
        cl.add_machine(mid, syncing=True)
        self.propose(set(cur.members) | {mid}, max_ticks=max_ticks)
        return mid

    def leave(self, mid: int, *, max_ticks: int = 200_000) -> None:
        """Remove machine ``mid`` from the membership.

        The leaver is excluded from issuing its own removal: its sessions
        are parked the moment it installs the new view, which would strand
        the very CAS that created it.
        """
        cur = self.cluster.active_view
        if mid not in cur.members:
            return
        self.propose(set(cur.members) - {mid}, exclude=(mid,),
                     max_ticks=max_ticks)
