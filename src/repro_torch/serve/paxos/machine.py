"""BatchedMachine: a replica whose tick is a stream of fused engine waves.

Drop-in replacement for the scalar :class:`repro_torch.core.node.Machine`
(``submit`` / ``deliver`` / ``step`` / ``crash``, stats, trace taps,
``Cluster(machine_cls=BatchedMachine)``), but the protocol hot paths run
batched on the cluster's device-resident plane stacks
(:mod:`.cluster_engine`):

* every inbound wire **message** is applied by the fused receiver step over
  this machine's row of the stacked :class:`~repro_torch.core.vector.KVTable`
  planes (one lane per key), replies coming back as
  :class:`~repro_torch.core.vector.ReplyBatch` row views;
* every steered **reply** is folded and arbitrated by the fused issuer step
  over this machine's row of the stacked ProposerTable (one lane per
  session), decisions coming back as
  :class:`~repro_torch.core.proposer_vector.ActionBatch` row views.

Both steps run the hand-written CUDA kernels (``paxos_apply``,
``paxos_propose``) when the engine's device is a GPU and their plain
PyTorch versions when the caller asked for ``device="cpu"``; there is no
switch between the two besides the device.  Live reconfiguration
(``cfg.reconfig``) runs as on the scalar machine: control-plane messages
(VIEW, SYNC, JOIN_REQ) and fenced payloads are intercepted on the host
after the pending engine runs flush (:meth:`_fenced_or_control`), and a
snapshot reads or merges this machine's whole KV row as columns
(:mod:`repro_torch.reconfig.catchup`).

The machine no longer calls an engine directly: its tick is the generator
:meth:`_tick_gen`, which *yields* batch requests and is resumed with the
fused outputs.  Driven standalone (:meth:`step`) the machine runs one
fused call per batch on a private engine; driven by :meth:`ClusterEngine.step_all
<repro_torch.serve.paxos.cluster_engine.ClusterEngine.step_all>` the same
generator interleaves with every other machine's, one fused receiver call
plus one fused issuer call per wave for the whole cluster.

Host decisions (KV-coupled: grabbing the pair, accept-value computation,
local commits, back-off/retry/inspection timers, FIFO probing) reuse the
scalar machine's code verbatim, resolved through the bridge: they check out
scalar ``KVPair`` views of single lanes and the bridge scatters them back
before the next engine step.  See the package docstring
(:mod:`repro_torch.serve.paxos`) for the full tick anatomy and the equivalence
argument.

The ingest side uses :class:`~.scheduler.IngestScheduler` in strict-order
mode, so the batched cluster is completion-for-completion identical to the
scalar cluster on any seeded schedule — the differential acceptance bar
this subsystem is tested against (``tests/test_torch_serve.py`` on the
CPU, ``chip_smoke.py`` on the card).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.handlers import get_kv
from repro_torch.core.lanes import _COMMIT_KINDS
from repro_torch.core.node import Machine, ProtocolConfig, ReqKind
from repro_torch.core.proposer import (
    ABD_PAUSED, AbdPhase, AbdRound, Decision, Phase, RmwRound,
)
from repro_torch.core.types import (
    Carstamp, HelpFlag, Msg, MsgKind, Reply, RmwId, TS, Tally, View,
)

from repro_torch.device import DeviceLike, resolve_device

from . import bridge
from .cluster_engine import ClusterEngine
from .scheduler import DEFAULT_BATCH_TARGET, IngestScheduler


class BatchedMachine(Machine):
    """One simulated server, ticking as fused-engine waves."""

    # round events feed the live issuer lanes, trace tap or not
    _wants_round_events = True

    def __init__(self, mid: int, cfg: ProtocolConfig, send, now,
                 incarnation: int = 0, view: Optional[View] = None, *,
                 device: DeviceLike = None,
                 batch_target: Optional[int] = None,
                 engine: Optional[ClusterEngine] = None, shards: int = 1):
        super().__init__(mid, cfg, send, now, incarnation, view=view)
        self.device = resolve_device(device)
        self.shards = max(1, int(shards))
        self.batch_target = (DEFAULT_BATCH_TARGET if batch_target is None
                             else batch_target)
        # Engine binding: row `mid` of the (shared or private) plane
        # stacks.  A standalone machine owns a private engine; Cluster
        # adoption (ClusterEngine.adopt) migrates the rows into the shared
        # stacks without touching this machine's code.
        if engine is None:
            engine = ClusterEngine(cfg, mid + 1, shards=self.shards,
                                   device=self.device)
        self._engine = engine
        self._mi = mid
        # authoritative receiver state = this machine's row of the stacked
        # KV planes, checked out through the bridge
        self.kvs = bridge.KVBridge(stack=engine.kv, mi=self._mi)
        # session→shard steering rides the lid table: the shard map names
        # which ProposerTable shard block each session lane folds into
        self.steering = bridge.SteeringTable(
            cfg.sessions_per_machine, mid,
            shard_map=(engine.sess_shard_map()
                       if engine.tab_shards > 1 else None))
        engine.adopt(self)
        # message ingest: strict order keeps the batched execution
        # oracle-exact (see scheduler docstring); one persistent instance
        # per machine so its stats survive as serve-path observability
        self.ingest = IngestScheduler(strict_order=True,
                                      batch_target=self.batch_target)
        # local synthetic replies (§4.6 implicit acks, §5/§8.4 self-notes)
        # queued for the next issuer step — always the first fold of a fresh
        # round, so with majority >= 2 they can never decide alone
        self._notes: Deque[Tuple[int, Reply]] = deque()
        self.engine_stats = {"receiver_batches": 0, "receiver_lanes": 0,
                             "issuer_batches": 0, "issuer_lanes": 0,
                             "receiver_shard_lanes": [0] * self.shards}

    @classmethod
    def attach_engine(cls, machines) -> ClusterEngine:
        """Build one shared :class:`ClusterEngine` for a whole cluster and
        adopt every machine's rows into its stacked planes.  ``sim.Cluster``
        duck-types on this hook: when the machine class provides it, the
        cluster tick becomes one fused ``step_all`` instead of N
        sequential ``step()`` calls."""
        first = machines[0]
        eng = ClusterEngine(first.cfg, len(machines), shards=first.shards,
                            device=first.device)
        for m in machines:
            eng.adopt(m)
        return eng

    def _lane_views(self, sess: int) -> Dict[str, np.ndarray]:
        """This machine's row of the stacked ProposerTable (field ->
        per-session lane views) for a host write to lane ``sess`` alone:
        only that lane re-uploads before the next fused step."""
        return self._engine.tab.write_lane_views(self._mi, sess)

    @property
    def lanes_ro(self) -> Dict[str, np.ndarray]:
        """Read-only lane views: same rows, but marks nothing for
        re-upload — pure-read decision loaders must not force the engine
        to re-ship unchanged ProposerTable lanes next wave."""
        return self._engine.tab.read_views(self._mi)

    @property
    def _commit_need(self) -> int:
        # reads the active view so a view change resizes the commit-ack
        # quorum like every other tally (§8.7)
        return (self.view.quorum() - 1
                if self.cfg.commit_ack_quorum_is_majority else 1)

    # =================================================================
    # worker loop: the tick generator (driven solo or cluster-fused)
    # =================================================================

    # control-plane kinds are host-intercepted before the engines
    _CONTROL_KINDS = (MsgKind.VIEW, MsgKind.SYNC, MsgKind.JOIN_REQ)

    def _fenced_or_control(self, payload) -> bool:
        """Exactly the consume-predicate of ``Machine._admit`` — evaluated
        *before* batching so pending engine runs can be flushed first (a
        snapshot served or a view installed mid-run would otherwise see
        lane state the scalar machine, which applies the earlier inbox
        messages immediately, has already advanced past)."""
        if not self.cfg.reconfig:
            return False
        if isinstance(payload, Msg) and payload.kind in self._CONTROL_KINDS:
            return True
        if self.retired or self.syncing:
            return True
        return payload.epoch != self.view.epoch

    def step(self) -> None:
        """Standalone tick: drive this machine's generator alone (one
        fused call per batch).  Under a Cluster the
        engine drives every machine's generator together instead."""
        self._engine.drive([(self, self._tick_gen())])

    def _tick_gen(self):
        if not self.alive:
            return
        if self.retired:
            self.inbox.clear()
            return
        if self.syncing:
            while self.inbox:
                self._admit(self.inbox.popleft())
            if self.syncing:
                self._drive_catchup()
            return
        out_replies: List[Tuple[int, Reply]] = []
        # Process the inbox as alternating message/reply runs: messages and
        # replies cross-couple only through the KV store + registry (a
        # commit changes what a decision's host action sees and vice versa),
        # so a run boundary is a flush boundary — within a run, batching is
        # free under the conflict rules.
        run_msgs: List[Msg] = []
        run_reps: List[Reply] = []
        while self.inbox:
            payload = self.inbox.popleft()
            if self._fenced_or_control(payload):
                # flush before the host intercept so engine state is
                # current when a snapshot is served or a view installs
                # (runs never span an install boundary, which is what
                # keeps reply-epoch stamping at flush time scalar-exact)
                if run_reps:
                    yield from self._issuer_flush(run_reps)
                    run_reps = []
                if run_msgs:
                    yield from self._receiver_flush(run_msgs, out_replies)
                    run_msgs = []
                self._admit(payload)
                continue
            if isinstance(payload, Msg):
                if run_reps:
                    yield from self._issuer_flush(run_reps)
                    run_reps = []
                run_msgs.append(payload)
            else:
                if run_msgs:
                    yield from self._receiver_flush(run_msgs, out_replies)
                    run_msgs = []
                run_reps.append(payload)
        if run_reps:
            yield from self._issuer_flush(run_reps)
        if run_msgs:
            yield from self._receiver_flush(run_msgs, out_replies)
        # receiver replies go out after the whole inbox, in arrival order —
        # same send sequence as the scalar worker loop (§3.1.3 step 3)
        for dst, rep in out_replies:
            self._send(self.mid, dst, rep)
        for le in self.entries:
            if le.active():
                self._inspect(le)
        for ab in self.abd:
            if ab.phase != AbdPhase.IDLE:
                self._inspect_abd(ab)
        for sess in range(self.cfg.sessions_per_machine):
            if self.session_idle(sess) and self.fifos[sess]:
                self._start(sess, self.fifos[sess].popleft())
        if self._notes:
            # fold round-start self-notes from inspection/probe now, so the
            # tally state entering the next tick matches the scalar machine
            yield from self._issuer_flush([])
        self._poll_config_register()

    # =================================================================
    # receiver half: one fused-step request per conflict-free batch
    # =================================================================

    def _receiver_flush(self, run: List[Msg],
                        out: List[Tuple[int, Reply]]):
        # per-item bookkeeping hoisted out of the admit loop: one _now()
        # per run (sim time is constant within a tick), one trace-tap
        # lookup, one lane-growth ensure() for the run's max key, and the
        # scheduler's counters batched via offer_many
        now = self._now()
        last_heard = self.last_heard
        trace = self.msg_trace
        bump = self.bump
        max_key = -1
        for msg in run:
            last_heard[msg.src] = now
            bump(f"recv_{msg.kind.name.lower()}")
            if trace is not None:
                trace.append(msg.clone())
            if msg.key > max_key:
                max_key = msg.key
        if max_key >= 0:
            self.kvs.ensure(max_key)
        self.ingest.offer_many(run)
        if self.shards > 1:
            # one emission pass yields the batch AND its per-shard
            # sub-batches (disjoint plane blocks); the wave still runs as
            # one fused call spanning shards
            drained = self.ingest.drain_sharded(self.kvs.shard_map)
        else:
            drained = ((batch, None) for batch in self.ingest.drain())
        for batch, per_shard in drained:
            if per_shard is not None:
                shard_stat = self.engine_stats["receiver_shard_lanes"]
                for s, sub in enumerate(per_shard):
                    if sub:
                        shard_stat[s] += len(sub)
            # rep_np: field -> this machine's per-key reply row views
            rep_np = yield ("recv", batch)
            for msg in batch:
                rep = bridge.reply_from_lanes(rep_np, msg, src=self.mid)
                # runs never span a view install (the tick flushes before
                # any control-plane intercept), so stamping at flush time
                # matches the scalar machine's at-handling-time epoch
                rep.epoch = self.view.epoch
                if msg.kind in _COMMIT_KINDS:
                    self._record_commit(msg.key, msg.log_no, msg.rmw_id,
                                        msg.value, msg.base_ts,
                                        get_kv(self.kvs, msg.key),
                                        val_log=msg.val_log)
                bump(f"rep_{rep.opcode.name.lower()}")
                out.append((msg.src, rep))
            self.engine_stats["receiver_batches"] += 1
            self.engine_stats["receiver_lanes"] += len(batch)

    # =================================================================
    # issuer half: one fused-step request per conflict-free reply batch
    # =================================================================

    def _issuer_flush(self, run: List[Reply]):
        for rep in run:
            self.last_heard[rep.src] = self._now()
        stream = deque(run)
        while stream or self._notes:
            batch: List[Tuple[int, Reply]] = []
            lanes_in = set()
            is_notes = bool(self._notes)
            if is_notes:
                # queued self-notes are older than any still-unfolded
                # network reply of this run (they were created by an
                # earlier dispatch/round start) — fold them first
                while self._notes and self._notes[0][0] not in lanes_in:
                    lane, rep = self._notes.popleft()
                    batch.append((lane, rep))
                    lanes_in.add(lane)
            else:
                while stream:
                    rep = stream[0]
                    lane = self.steering.lane_of(rep.lid)
                    if lane is None:           # unroutable lid: drop, like
                        stream.popleft()       # the scalar sess-range check
                        continue
                    if lane in lanes_in:
                        break                  # per-session order barrier
                    stream.popleft()
                    batch.append((lane, rep))
                    lanes_in.add(lane)
            if batch:
                # notes were already traced at _note_local time (mirroring
                # the scalar machine, which traces before folding)
                yield from self._issuer_batch(batch,
                                              trace_replies=not is_notes)

    def _issuer_batch(self, batch: List[Tuple[int, Reply]],
                      trace_replies: bool = True):
        # act: field -> this machine's per-session ActionBatch row views;
        # the fused step already absorbed the new ProposerTable row
        act = yield ("issuer", batch)
        self.engine_stats["issuer_batches"] += 1
        self.engine_stats["issuer_lanes"] += len(batch)
        # Trace + dispatch per lane, in arrival order.  The reply trace and
        # its decision trace must stay adjacent (reply, then decision) —
        # the replay harness relies on every decision being recorded before
        # any later reply that could flush it, exactly as the scalar
        # machine (which decides inline) naturally orders them.  Decisions
        # themselves are pure per-lane — the engine already computed them —
        # but their host actions touch the shared KV store, so dispatch
        # order must match scalar arrival order too.
        for lane, rep in batch:
            if trace_replies:
                self._trace_reply(lane, rep)
            d = Decision(int(act["decision"][lane]))
            if d != Decision.WAIT:
                self._dispatch_decision(lane, d, act)

    # -- decision dispatch: ActionBatch lane -> scalar host action ----------

    def _dispatch_decision(self, sess: int, d: Decision,
                           act: Dict[str, np.ndarray]) -> None:
        le = self.entries[sess]
        ab = self.abd[sess]
        payload = bridge.action_payload(act, sess, d)
        if d in (Decision.LEARNED, Decision.LEARNED_NO_BCAST):
            self._trace_decision(sess, d)
            self._on_learned_committed(
                le, no_bcast=d == Decision.LEARNED_NO_BCAST)
        elif d == Decision.LOG_TOO_LOW:
            self._trace_decision(sess, d, payload)
            self._apply_log_too_low(le, bridge.log_too_low_reply(act, sess))
        elif d == Decision.RETRY:
            self._trace_decision(sess, d, payload)
            if int(act["sh_has"][sess]):
                le.retry_version = max(le.retry_version,
                                       int(act["ts_v"][sess]) + 1)
            if le.all_aboard:
                self.bump("all_aboard_fallbacks")
            self._enter_retry(le)
        elif d == Decision.LOCAL_ACCEPT:
            self._trace_decision(sess, d)
            self._load_fresh_tally(le, sess)
            self._local_accept_own(le)
        elif d in (Decision.HELP, Decision.HELP_SELF):
            self._trace_decision(sess, d, payload)
            self._begin_help(le, bridge.lower_acc_reply(act, sess))
        elif d == Decision.RECOMMIT:
            self._trace_decision(sess, d)
            self._apply_recommit(le)
        elif d == Decision.RETRY_LOG_TOO_HIGH:
            self._trace_decision(sess, d)
            le.log_too_high_counter += 1
            self._enter_retry(le)
        elif d == Decision.COMMIT_BCAST:
            le.all_acked = int(act["has_value"][sess]) == 0  # §8.6 thin
            self._trace_decision(sess, d, payload)
            self._apply_commit_bcast(
                le, helping=le.helping_flag == HelpFlag.HELPING)
        elif d == Decision.STOP_HELP:
            self._trace_decision(sess, d)
            self._stop_helping(le)
        elif d == Decision.COMMIT_DONE:
            self._finish_commit(le)
        elif d == Decision.ABD_W2:
            self._trace_decision(sess, d, payload)
            ab.max_base = TS(int(act["base_v"][sess]),
                             int(act["base_m"][sess]))
            self._write_phase2(ab)
        elif d == Decision.ABD_W_DONE:
            self._trace_decision(sess, d)
            self._complete_abd(ab, ReqKind.WRITE, ab.value,
                               Carstamp(ab.max_base, 0))
        elif d == Decision.ABD_R_DONE:
            self._trace_decision(sess, d)
            self._load_best(ab, sess)
            self._complete_abd(ab, ReqKind.READ, ab.best_value, ab.best_cs)
        elif d == Decision.ABD_R_WB:
            self._trace_decision(sess, d, payload)
            ab.best_log_no = int(act["log_no"][sess])
            ab.best_rmw_id = RmwId(int(act["rmw_cnt"][sess]),
                                   int(act["rmw_sess"][sess]))
            ab.best_value = int(act["value"][sess])
            ab.best_cs = Carstamp(TS(int(act["base_v"][sess]),
                                     int(act["base_m"][sess])),
                                  int(act["val_log"][sess]))
            self._read_write_back(ab)
        elif d == Decision.ABD_RC_DONE:
            self._trace_decision(sess, d)
            self._complete_abd(ab, ReqKind.READ, ab.best_value, ab.best_cs)
        else:                                       # pragma: no cover
            raise AssertionError(f"engine emitted unknown decision {d!r}")

    def _load_fresh_tally(self, le, sess: int) -> None:
        """§10.3: LOCAL_ACCEPT's accept-value computation needs the
        freshest Ack-base-TS-stale payload — it lives in the fr_* planes."""
        lanes = self.lanes_ro
        t = Tally()
        if int(lanes["fr_has"][sess]):
            t.fresh_value = int(lanes["fr_val"][sess])
            t.fresh_cs = Carstamp(TS(int(lanes["fr_base_v"][sess]),
                                     int(lanes["fr_base_m"][sess])),
                                  int(lanes["fr_log"][sess]))
        le.tally = t

    def _load_best(self, ab, sess: int) -> None:
        """§11: ABD_R_DONE completes with the best-carstamp fold state."""
        lanes = self.lanes_ro
        ab.best_value = int(lanes["best_val"][sess])
        ab.best_cs = Carstamp(TS(int(lanes["best_base_v"][sess]),
                                 int(lanes["best_base_m"][sess])),
                              int(lanes["best_vlog"][sess]))
        ab.best_log_no = int(lanes["best_log"][sess])
        ab.best_rmw_id = RmwId(int(lanes["best_cnt"][sess]),
                               int(lanes["best_sess"][sess]))

    # =================================================================
    # issuer-lane maintenance hooks (round loads, pauses, local notes)
    # =================================================================

    def _note_rmw_round(self, ev: RmwRound) -> None:
        super()._note_rmw_round(ev)
        bridge.load_rmw_round(self._lane_views(ev.sess), ev)
        self.steering.register(ev.sess, ev.lid)

    def _note_abd_round(self, ev: AbdRound) -> None:
        super()._note_abd_round(ev)
        bridge.load_abd_round(self._lane_views(ev.sess), ev)
        self.steering.register(ev.sess, ev.lid, abd=True)

    def _trace_pause(self, sess: int, abd: int = 0) -> None:
        super()._trace_pause(sess, abd)
        # host-initiated round abandonment (timeout retry, stop-helping):
        # park the lane so stragglers for the dead round cannot decide
        if abd:
            self._lane_views(sess)["abd_phase"][sess] = ABD_PAUSED
        else:
            self._lane_views(sess)["phase"][sess] = int(Phase.PAUSED)

    def _note_local(self, le, rep: Reply) -> None:
        # scalar: trace + fold into le.tally.  Batched: trace now, fold via
        # the engine at the next issuer flush (still before any network
        # reply of the same round — those arrive a tick later at best).
        self._trace_reply(le.sess, rep)
        self._notes.append((le.sess, rep))

    def crash(self) -> None:
        super().crash()
        self._notes.clear()
        # crash-stop hygiene: offered-but-undrained ingest (e.g. a
        # drain_sharded generator abandoned mid-wave) dies with the inbox,
        # and a dead machine must not report stale backlog/aging gauges
        self.ingest.reset()

    # =================================================================
    # live reconfiguration hooks
    # =================================================================

    def _install_view(self, view: View) -> bool:
        installed = super()._install_view(view)
        if installed:
            # lid routing survives a view change (lids are machine-local),
            # but the steering table tracks the epoch for observability —
            # and, sharded, re-checks that no live lane's session→shard
            # steering moved (a foreign-shard move raises loudly)
            self.steering.remap(
                self.view.epoch,
                shard_map=(self._engine.sess_shard_map()
                           if self._engine.tab_shards > 1 else None))
        return installed

    def _retire(self) -> None:
        super()._retire()
        # parked lanes must not fold queued self-notes later
        self._notes.clear()
