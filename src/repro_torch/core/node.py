"""A replica machine: worker loop + proposer-side state machine (§3.1.3–§9).

One :class:`Machine` models one server. The paper runs 20–30 worker threads,
each owning many sessions; threads never share protocol state (per-key
parallelism), so a single event-driven worker with S sessions is
behaviour-equivalent — thread-level concurrency is reintroduced by the
vectorized engine (see ``core/vector.py`` / ``kernels/paxos_apply``), which is
the accelerator-native analogue of the paper's many-core scaling.

The worker loop (§3.1.3) per iteration: (1) poll remote messages and act on
them, (2) inspect active Local-entries, (3) send enqueued messages, (4) probe
client FIFOs for idle sessions.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from . import handlers, proposer
from .handlers import Registry, commit_to_kv, get_kv
from .proposer import (
    AbdEntry, AbdPhase, AbdRound, Decision, DecisionEvent, PauseEvent, Phase,
    ReplyEvent, RmwRound,
)
from .types import (
    ALL_ABOARD_VERSION, CONFIG_KEY, Carstamp, FIRST_PROPOSE_VERSION, HelpFlag,
    KVPair, KVState, LEState, LocalEntry, MAX_MEMBERS, Msg, MsgKind, Rep,
    Reply, RmwId, RmwOp, TS, TS_ZERO, View, apply_rmw,
)

# Restart-incarnation bound.  Both halves of the rmw-id namespace assume it:
# counters carry `incarnation << 24` in their high bits (int32 engine lanes)
# and the registry is striped per incarnation (`ProtocolConfig.num_gsess`).
MAX_INCARNATIONS = 128

# Live reconfiguration's join/leave controller and snapshot catch-up
# (repro.reconfig) are not ported yet.
RECONFIG_NOT_PORTED = ("live reconfiguration (join / leave / snapshot "
                       "catch-up) is not ported to repro_torch yet (ROADMAP, "
                       "Queue 1 item 1: checkpoint/store.py + reconfig/)")


@dataclasses.dataclass
class ProtocolConfig:
    """Deployment knobs (paper defaults in comments)."""

    n_machines: int = 5                  # 3–7 (§3)
    sessions_per_machine: int = 8        # paper: workers × sessions = 800–2400
    backoff_threshold: int = 6           # §5 no-progress inspections before steal/help
    retransmit_threshold: int = 24       # inspections before a stalled round retries
    log_too_high_threshold: int = 4      # §8.7 consecutive nacks before re-commit
    all_aboard: bool = False             # §9
    all_aboard_timeout: int = 8          # §9.2 all-aboard-time-out-counter limit
    suspect_timeout: float = 50.0        # §9.2 note: skip all-aboard if a peer is quiet
    commit_ack_quorum_is_majority: bool = True   # §8.7 (one ack would also do)
    # live reconfiguration: when True, membership is governed by the View in
    # the config register (CONFIG_KEY) instead of n_machines, machines fence
    # cross-epoch traffic, and global-session/bitmap capacity is provisioned
    # for max_machines so members can join beyond the initial n_machines.
    reconfig: bool = False
    max_machines: int = MAX_MEMBERS

    @property
    def capacity(self) -> int:
        """Machine-id capacity: how many mids state tables must cover."""
        return self.max_machines if self.reconfig else self.n_machines

    @property
    def majority(self) -> int:
        return View.quorum_of(self.n_machines)

    @property
    def base_gsess(self) -> int:
        """Global-session slots for one incarnation of the whole fleet."""
        return self.capacity * self.sessions_per_machine

    @property
    def num_gsess(self) -> int:
        # One registry stripe per incarnation.  The registry is a pure
        # high-water mark (committed[gsess] >= counter), so a single gsess
        # must never span incarnations: the first commit of a restarted
        # machine would otherwise vouch for the old incarnation's in-flight
        # rmw-ids, leaving possibly-unchosen ACCEPTED entries that every
        # helper abandons (RMW_ID_COMMITTED nack -> STOP_HELP livelock).
        return MAX_INCARNATIONS * self.base_gsess


# ---------------------------------------------------------------------------
# Client requests / completions
# ---------------------------------------------------------------------------

class ReqKind(enum.IntEnum):
    RMW = 0
    WRITE = 1
    READ = 2


@dataclasses.dataclass
class Request:
    kind: ReqKind
    key: int
    op: RmwOp = RmwOp.FAA
    arg1: int = 0
    arg2: int = 0
    value: int = 0                       # for writes
    tag: int = 0                         # opaque client tag


@dataclasses.dataclass
class Completion:
    tag: int
    kind: ReqKind
    key: int
    value: int                           # RMW: value read (pre-state); READ: value
    carstamp: Carstamp
    rmw_id: RmwId = dataclasses.field(default_factory=lambda: RmwId(0, -1))


# ABD per-session entries (§10–§11) live in repro_torch.core.proposer (AbdEntry /
# AbdPhase are re-exported here for compatibility): the issuer-side tally
# transitions are pure and shared with the batched proposer engine.


class Machine:
    def __init__(self, mid: int, cfg: ProtocolConfig,
                 send: Callable[[int, int, object], None],
                 now: Callable[[], float], incarnation: int = 0,
                 view: Optional[View] = None):
        if not 0 <= mid < cfg.capacity:
            raise ValueError(f"mid {mid} outside capacity {cfg.capacity}")
        self.mid = mid
        self.cfg = cfg
        self.incarnation = incarnation
        self._send = send                # (src, dst, payload) -> network
        self._now = now
        # the active membership view; all quorum arithmetic reads from it
        # (with reconfig off it is just the constant initial view)
        self.view = view if view is not None else View.initial(cfg.n_machines)
        self.syncing = False             # joiner waiting for a SYNC snapshot
        self.retired = False             # removed from the active view
        self._join_timer = 0
        self._join_rr = 0
        self.kvs: Dict[int, KVPair] = {}
        self.registry = Registry(cfg.num_gsess)
        # Each incarnation issues under its own gsess stripe: the registry
        # high-water of a previous life must never vouch for this one's
        # counters, nor vice versa (see ProtocolConfig.num_gsess).
        self.entries: List[LocalEntry] = [
            LocalEntry(sess=s, gsess=(incarnation * cfg.base_gsess
                                      + mid * cfg.sessions_per_machine + s))
            for s in range(cfg.sessions_per_machine)
        ]
        self.abd: List[AbdEntry] = [AbdEntry(sess=s)
                                    for s in range(cfg.sessions_per_machine)]
        # rmw-id counters carry the session *incarnation* in their high bits:
        # a restarted machine (fresh volatile state) must never reuse an
        # rmw-id, or the registry would treat its new RMWs as committed.
        # The shift keeps counters inside int32 — rmw-ids live in int32
        # lanes of both SIMD engines (KVTable/ProposerTable planes), so a
        # 1<<32 incarnation stride would silently wrap there.  Fail loudly
        # at the boundary instead: 128 << 24 is the first overflow.
        if not 0 <= incarnation < MAX_INCARNATIONS:
            raise ValueError(
                f"incarnation {incarnation} out of range "
                f"[0, {MAX_INCARNATIONS}): the 1<<24 rmw-id stride would "
                f"overflow the engines' int32 lanes — rejoin as a new "
                f"member instead")
        self.rmw_counters = [incarnation << 24] * cfg.sessions_per_machine
        self.inbox: Deque[object] = deque()
        self.fifos: List[Deque[Request]] = [deque() for _ in
                                            range(cfg.sessions_per_machine)]
        self.completions: List[Tuple[int, Completion]] = []   # (sess, completion)
        self.last_heard = [now()] * cfg.capacity
        self.alive = True
        self._lid_counter = 1
        # Per-machine monotonic Lamport clock for ABD write base-TSes: keeps
        # base-TS unique across concurrent sessions of the same machine
        # (machine-id alone only tie-breaks across machines).
        self.write_clock = 0
        self.stats: Dict[str, int] = {}
        # commit log per key for the invariant checkers: key -> log_no -> record
        self.commit_log: Dict[int, Dict[int, Tuple[RmwId, int, TS]]] = {}
        # every phase-2 write this machine ever issued (key, base-TS, value):
        # the linearizability checker needs "ghost" writes whose issuer died
        # before completion but whose installs were observed.
        self.write_log: List[Tuple[int, TS, int]] = []
        # receiver-side message tap: when a list, every protocol message is
        # appended (in processing order) before it is applied — the input of
        # the differential trace-replay harness (repro_torch.core.replay).
        self.msg_trace: Optional[List[Msg]] = None
        # issuer-side event tap (round starts, steered replies, decisions,
        # pauses — see repro_torch.core.proposer): the input+oracle of the
        # differential *proposer* replay (repro_torch.core.replay).
        self.issuer_trace: Optional[List[object]] = None
        # observability tap (repro_torch.obs.FlightRecorder): None = off, zero
        # cost beyond these `is not None` branches.  Per-session open
        # spans live here (LocalEntry/AbdEntry objects are replaced per
        # op, so the span rides the machine, keyed by session).
        self.obs = None
        self._obs_rmw: List[Optional[object]] = (
            [None] * cfg.sessions_per_machine)
        self._obs_abd: List[Optional[object]] = (
            [None] * cfg.sessions_per_machine)

    # -- infrastructure ------------------------------------------------------

    def _trace_reply(self, sess: int, rep: Reply) -> None:
        if self.issuer_trace is not None:
            self.issuer_trace.append(
                ReplyEvent(sess, dataclasses.replace(rep)))

    def _trace_pause(self, sess: int, abd: int = 0) -> None:
        if self.issuer_trace is not None:
            self.issuer_trace.append(PauseEvent(sess, abd))

    def _trace_decision(self, sess: int, d: Decision,
                        payload: Optional[dict] = None) -> None:
        if self.issuer_trace is not None:
            self.issuer_trace.append(DecisionEvent(sess, d, payload))

    def bump(self, stat: str, n: int = 1) -> None:
        self.stats[stat] = self.stats.get(stat, 0) + n

    def _new_lid(self, sess: int) -> int:
        self._lid_counter += 1
        return (self._lid_counter << 16) | (sess & 0xFFFF)

    def _broadcast(self, msg: Msg) -> None:
        # `msg` is the template: stamp it once, then hand each destination
        # a lightweight clone (Msg.clone skips __init__ — per-destination
        # dataclasses.replace was a measurable slice of the per-item host
        # path; see benchmarks/bench_protocol.py host_path lane)
        msg.epoch = self.view.epoch
        mid = self.mid
        send = self._send
        sent = 0
        for dst in self.view.members:
            if dst != mid:
                send(mid, dst, msg.clone())
                sent += 1
        self.bump(f"sent_{msg.kind.name.lower()}", sent)

    def submit(self, sess: int, req: Request) -> None:
        self.fifos[sess].append(req)

    def session_idle(self, sess: int) -> bool:
        return (self.entries[sess].state == LEState.INVALID
                and self.abd[sess].phase == AbdPhase.IDLE)

    # -- worker loop (§3.1.3) --------------------------------------------------

    def step(self) -> None:
        if not self.alive:
            return
        if self.retired:
            # removed from the view: consume (and ignore) leftover traffic
            self.inbox.clear()
            return
        if self.syncing:
            # a joiner only speaks the catch-up plane until its SYNC lands
            while self.inbox:
                self._admit(self.inbox.popleft())
            if self.syncing:
                self._drive_catchup()
            return
        out_replies: List[Tuple[int, Reply]] = []
        while self.inbox:
            payload = self.inbox.popleft()
            if self._admit(payload):
                continue
            if isinstance(payload, Msg):
                rep = self._handle_msg(payload)
                if rep is not None:
                    rep.src = self.mid
                    rep.epoch = self.view.epoch
                    out_replies.append((payload.src, rep))
            else:
                self._handle_reply(payload)
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
        self._poll_config_register()

    def deliver(self, payload: object) -> None:
        if self.alive:
            self.inbox.append(payload)

    def crash(self) -> None:
        self.alive = False
        self.inbox.clear()
        if self.obs is not None:
            self.obs.machine_crash(self.mid, self._now(),
                                   self._obs_rmw + self._obs_abd)
            self._obs_rmw = [None] * self.cfg.sessions_per_machine
            self._obs_abd = [None] * self.cfg.sessions_per_machine

    # -- live reconfiguration: epoch fencing + view install --------------------
    #
    # (see the epoch-fencing rule next to the wire-kind definitions in
    # repro_torch.core.types)

    def _admit(self, payload) -> bool:
        """Epoch fence + control-plane dispatch.  True = consumed/dropped
        here; False = a current-view protocol payload for the handlers."""
        if not self.cfg.reconfig:
            return False
        if isinstance(payload, Msg):
            kind = payload.kind
            if kind == MsgKind.VIEW:
                if not self.retired:
                    v = View.decode(payload.value)
                    if v is not None:
                        self._install_view(v)
                return True
            if kind == MsgKind.SYNC:
                if not self.retired:
                    self._install_sync(payload)
                return True
            if kind == MsgKind.JOIN_REQ:
                if (not self.retired and not self.syncing
                        and payload.epoch <= self.view.epoch):
                    self._serve_sync(payload.src)
                else:
                    self.bump("join_req_deferred")
                return True
        if self.retired or self.syncing:
            self.bump("fenced_parked")
            return True
        if payload.epoch != self.view.epoch:
            if payload.epoch < self.view.epoch:
                self.bump("fenced_stale")
                if isinstance(payload, Msg):
                    # teach the laggard the committed view
                    self._send(self.mid, payload.src, self._view_notice())
            else:
                self.bump("fenced_ahead")
            return True
        return False

    def _view_notice(self) -> Msg:
        return Msg(MsgKind.VIEW, self.mid, value=self.view.encode(),
                   epoch=self.view.epoch)

    def _poll_config_register(self) -> None:
        """End-of-tick view poll: a commit to the config register that
        landed this tick (receiver or issuer side) takes effect here."""
        if not self.cfg.reconfig:
            return
        kv = self.kvs.get(CONFIG_KEY)
        if kv is None:
            return
        v = View.decode(kv.value)
        if v is not None:
            self._install_view(v)

    def _install_view(self, view: View) -> bool:
        """Adopt a committed view: fence the old epoch, restart every
        in-flight round so no quorum mixes replies across views, and
        announce the view to old+new members (once per epoch)."""
        if view.epoch <= self.view.epoch:
            return False
        old = self.view
        self.view = view
        self.bump("view_installs")
        if self.mid not in view.members:
            self._retire()
        elif not self.syncing:
            self._restart_rounds()
        notice = self._view_notice()
        for dst in sorted(set(old.members) | set(view.members)):
            if dst != self.mid:
                self._send(self.mid, dst, dataclasses.replace(notice))
        return True

    def _retire(self) -> None:
        """We were removed from the view: park every session and go quiet.
        In-flight client ops on this machine never complete (their clients
        would re-submit to a member)."""
        self.retired = True
        self.bump("view_retired")
        for le in self.entries:
            if le.active():
                self._trace_pause(le.sess)
                self.entries[le.sess] = LocalEntry(sess=le.sess,
                                                   gsess=le.gsess)
        for ab in self.abd:
            if ab.phase != AbdPhase.IDLE:
                self._trace_pause(ab.sess, abd=1)
                ab.phase = AbdPhase.IDLE
        for fifo in self.fifos:
            fifo.clear()
        self.inbox.clear()

    def _restart_rounds(self) -> None:
        """Quorum sizes and tallies are per-view: every round gathering
        replies restarts under the new view.  Decided state (accepted
        values, chosen base-TSes, commit payloads) is preserved — only the
        reply bookkeeping is discarded, which is always safe."""
        for le in self.entries:
            if le.state in (LEState.PROPOSED, LEState.ACCEPTED):
                if le.helping_flag == HelpFlag.HELPING:
                    self._stop_helping(le)
                else:
                    self._enter_retry(le)
            elif le.state == LEState.COMMITTED:
                # the value is decided; re-broadcast the commit so its ack
                # quorum is counted against the new members
                self._bcast_commits(le, from_help=le.commit_from_help)
        for ab in self.abd:
            self._restart_abd(ab)

    def _restart_abd(self, ab: AbdEntry) -> None:
        """Restart an in-flight ABD round for a new view.  Query phases may
        restart from scratch (nothing installed yet); phase-2 rounds keep
        their chosen base-TS / best carstamp (see ``_inspect_abd``: a write
        must never re-query after installs were issued) and only reset the
        ack tally under a fresh lid."""
        if ab.phase == AbdPhase.IDLE:
            return
        if ab.phase == AbdPhase.W_QUERY:
            self._trace_pause(ab.sess, abd=1)
            self._start_write(ab.sess, Request(ReqKind.WRITE, ab.key,
                                               value=ab.value, tag=ab.tag))
        elif ab.phase == AbdPhase.R_QUERY:
            self._trace_pause(ab.sess, abd=1)
            self._start_read(ab.sess, Request(ReqKind.READ, ab.key,
                                              tag=ab.tag))
        elif ab.phase == AbdPhase.W_WRITE:
            ab.ackers = set()
            ab.lid = self._new_lid(ab.sess)
            ab.round_age = 0
            self._trace_abd_round(ab)
            self._broadcast(Msg(MsgKind.WRITE, self.mid, key=ab.key,
                                value=ab.value, base_ts=ab.max_base,
                                lid=ab.lid))
        elif ab.phase == AbdPhase.R_COMMIT:
            ab.ackers = set()
            ab.lid = self._new_lid(ab.sess)
            ab.round_age = 0
            self._trace_abd_round(ab)
            self._broadcast(Msg(MsgKind.READ_COMMIT, self.mid, key=ab.key,
                                log_no=ab.best_log_no, rmw_id=ab.best_rmw_id,
                                value=ab.best_value, base_ts=ab.best_cs.base,
                                val_log=ab.best_cs.log_no, lid=ab.lid))

    # -- joiner catch-up (snapshot + replay; repro_torch.reconfig.catchup) -----------

    def begin_catchup(self) -> None:
        """Enter the syncing state: speak only the catch-up plane until a
        member's SYNC snapshot is installed."""
        self.syncing = True
        self._join_timer = 0
        self._join_rr = 0

    def _drive_catchup(self) -> None:
        if self._join_timer <= 0:
            donors = [m for m in self.view.members if m != self.mid]
            if donors:
                dst = donors[self._join_rr % len(donors)]
                self._join_rr += 1
                self.bump("join_reqs_sent")
                self._send(self.mid, dst,
                           Msg(MsgKind.JOIN_REQ, self.mid,
                               epoch=self.view.epoch))
            self._join_timer = self.cfg.retransmit_threshold
        else:
            self._join_timer -= 1

    def _serve_sync(self, dst: int) -> None:
        """Answer a JOIN_REQ with a snapshot of our committed state."""
        raise NotImplementedError(
            f"Machine._serve_sync: {RECONFIG_NOT_PORTED}")

    def _install_sync(self, msg: Msg) -> None:
        if not self.syncing:
            self.bump("sync_duplicate")
            return
        raise NotImplementedError(
            f"Machine._install_sync: {RECONFIG_NOT_PORTED}")

    # -- receiver side ---------------------------------------------------------

    def _handle_msg(self, msg: Msg) -> Optional[Reply]:
        self.last_heard[msg.src] = self._now()
        kv = get_kv(self.kvs, msg.key)
        self.bump(f"recv_{msg.kind.name.lower()}")
        if self.msg_trace is not None:
            self.msg_trace.append(dataclasses.replace(msg))
        rep = handlers.apply_msg(kv, msg, self.registry)
        if msg.kind in (MsgKind.COMMIT, MsgKind.READ_COMMIT):
            self._record_commit(msg.key, msg.log_no, msg.rmw_id,
                                msg.value, msg.base_ts, kv,
                                val_log=msg.val_log)
        self.bump(f"rep_{rep.opcode.name.lower()}")
        return rep

    def _record_commit(self, key: int, log_no: int, rmw_id: RmwId,
                       value: Optional[int], base_ts: TS, kv: KVPair,
                       val_log: Optional[int] = None) -> None:
        """Commit-log bookkeeping for the safety checkers.

        ``value`` is the slot's decided value only when the carried carstamp
        log part matches the slot (``val_log == log_no``); a Log-too-low
        payload or a read write-back may instead carry a *newer ABD write's*
        value (``val_log`` 0) riding on the last committed rmw-id — those
        teach us the slot->rmw-id mapping but not the slot's value.
        """
        if log_no <= 0:
            return
        if val_log is not None and val_log != log_no:
            return
        if value is None:
            # thin commit: record only if we could resolve the value
            if not (kv.last_committed_log_no >= log_no):
                return
            value = kv.value if kv.val_log == log_no else None
            if value is None:
                return
        self.commit_log.setdefault(key, {})[log_no] = (rmw_id, value, base_ts)

    # -- reply steering (§3.1.2, lids) ------------------------------------------

    def _handle_reply(self, rep: Reply) -> None:
        self.last_heard[rep.src] = self._now()
        sess = rep.lid & 0xFFFF
        if sess >= self.cfg.sessions_per_machine:
            return
        self._trace_reply(sess, rep)
        if rep.kind in (MsgKind.WRITE_QUERY_REPLY, MsgKind.WRITE_ACK,
                        MsgKind.READ_QUERY_REPLY):
            self._abd_reply(self.abd[sess], rep)
            return
        if rep.kind == MsgKind.COMMIT_ACK:
            # commit acks may belong to an RMW commit or a read write-back
            le = self.entries[sess]
            if (le.active() and le.lid == rep.lid
                    and le.state == LEState.COMMITTED):
                le.tally.note(rep)
                self._check_commit_acks(le)
            elif self.abd[sess].lid == rep.lid:
                self._abd_reply(self.abd[sess], rep)
            return
        le = self.entries[sess]
        if not le.active() or le.lid != rep.lid:
            self.bump("stale_reply")
            return
        le.tally.note(rep)
        if rep.kind == MsgKind.PROP_REPLY and le.state == LEState.PROPOSED:
            self._check_propose_replies(le)
        elif rep.kind == MsgKind.ACC_REPLY and le.state == LEState.ACCEPTED:
            self._check_accept_replies(le)

    # -- starting work -----------------------------------------------------------

    def _start(self, sess: int, req: Request) -> None:
        if req.kind == ReqKind.RMW:
            le = self.entries[sess]
            self.rmw_counters[sess] += 1
            if self.rmw_counters[sess] >= (self.incarnation + 1) << 24:
                # the counter half of the rmw-id space is 24 bits per
                # incarnation (engines' int32 lanes); crossing into the
                # next incarnation's stride would let a future restart
                # reissue committed rmw-ids — fail loudly instead
                raise RuntimeError(
                    f"session {sess} exhausted its 1<<24 rmw-id space for "
                    f"incarnation {self.incarnation}")
            fresh = LocalEntry(sess=sess, gsess=le.gsess)
            fresh.key, fresh.op, fresh.arg1, fresh.arg2 = (
                req.key, req.op, req.arg1, req.arg2)
            fresh.rmw_id = RmwId(self.rmw_counters[sess], le.gsess)
            fresh.state = LEState.NEEDS_KV
            fresh.tag = req.tag
            self.entries[sess] = fresh
            self.bump("rmw_started")
            if self.obs is not None:
                self._obs_rmw[sess] = self.obs.op_begin(
                    self.mid, sess, "rmw", req.key, req.tag, self._now())
            self._try_grab(fresh, first_attempt=True)
        elif req.kind == ReqKind.WRITE:
            self._start_write(sess, req)
        else:
            self._start_read(sess, req)

    # -- grabbing the local KV-pair (§4.1) + back-off (§5) ------------------------

    def _try_grab(self, le: LocalEntry, first_attempt: bool = False) -> None:
        if self.registry.is_registered(le.rmw_id):
            # Our RMW got helped to completion while we were waiting.
            self._on_learned_committed(le, no_bcast=False)
            return
        kv = get_kv(self.kvs, le.key)
        if kv.state == KVState.INVALID:
            le.log_no = kv.working_log()
            if (first_attempt and self.cfg.all_aboard
                    and self._all_responsive()):
                self._start_all_aboard(le, kv)
                return
            le.ts = TS(max(FIRST_PROPOSE_VERSION, le.retry_version), self.mid)
            kv.state = KVState.PROPOSED
            kv.log_no = le.log_no
            kv.proposed_ts = le.ts
            kv.rmw_id = le.rmw_id
            self._bcast_proposes(le, local_ack=True)
            return
        if (kv.state == KVState.PROPOSED and kv.rmw_id == le.rmw_id
                and kv.log_no == kv.working_log()):
            # The pair is still ours (e.g. an aborted help left it PROPOSED).
            le.log_no = kv.log_no
            le.ts = TS(max(kv.proposed_ts.version + 1, FIRST_PROPOSE_VERSION,
                           le.retry_version), self.mid)
            kv.proposed_ts = le.ts
            self._bcast_proposes(le, local_ack=True)
            return
        # Busy: back off (§5). Track whether the holder makes progress.
        snapshot = (kv.state, kv.log_no, kv.last_committed_log_no,
                    kv.proposed_ts, kv.accepted_ts, kv.rmw_id)
        if snapshot == le.kv_snapshot:
            le.back_off_counter += 1
        else:
            le.kv_snapshot = snapshot
            le.back_off_counter = 0
        # Exponential back-off with machine-id stagger: repeated steals grow
        # the no-progress window so a threshold shorter than a round latency
        # cannot produce mutual stealing forever.
        threshold = (self.cfg.backoff_threshold
                     * (1 << min(le.steal_count, 5)) + self.mid)
        if le.back_off_counter < threshold:
            return
        le.back_off_counter = 0
        le.steal_count += 1
        self.bump("backoff_expired")
        if kv.state == KVState.PROPOSED:
            # Steal (§5): the holder looks dead; overwrite with a higher TS.
            le.log_no = kv.log_no
            le.ts = TS(max(kv.proposed_ts.version + 1, FIRST_PROPOSE_VERSION,
                           le.retry_version), self.mid)
            kv.proposed_ts = le.ts
            kv.rmw_id = le.rmw_id
            self.bump("steals")
            if self.obs is not None:
                self.obs.rmw_steal(self._obs_rmw[le.sess], self._now())
            self._bcast_proposes(le, local_ack=True)
        else:
            # Accepted entries can NEVER be stolen — help them (§5/§6):
            # act as if the local KVS sent us a Seen-lower-acc.
            le.log_no = kv.log_no
            le.ts = TS(max(kv.proposed_ts.version + 1, FIRST_PROPOSE_VERSION,
                           le.retry_version), self.mid)
            kv.proposed_ts = le.ts
            le.helping_flag = HelpFlag.PROPOSE_LOCALLY_ACCEPTED
            self.bump("help_after_wait")
            if self.obs is not None:
                self.obs.rmw_help(self._obs_rmw[le.sess], self._now(),
                                  "help_after_wait")
            self._bcast_proposes(le, local_ack=False)
            self._note_local(le, Reply(MsgKind.PROP_REPLY, self.mid,
                                       Rep.SEEN_LOWER_ACC, le.lid, key=le.key,
                                       ts=kv.accepted_ts, rmw_id=kv.rmw_id,
                                       value=kv.accepted_value,
                                       base_ts=kv.acc_base_ts,
                                       val_log=kv.log_no))

    def _all_responsive(self) -> bool:
        """§9.2 final note: skip All-aboard if any peer has been quiet."""
        now = self._now()
        return all(now - self.last_heard[m] <= self.cfg.suspect_timeout
                   for m in self.view.members if m != self.mid)

    def _note_local(self, le: LocalEntry, rep: Reply) -> None:
        """A synthetic local reply (§4.6 implicit ack, §5/§8.4 self-notes):
        traced like any steered reply, then folded into the tally."""
        self._trace_reply(le.sess, rep)
        le.tally.note(rep)

    # Machine subclasses that keep live issuer lanes (the batched serve
    # machine) set this True so round events are built even when the trace
    # tap is off; the scalar machine skips the construction entirely.
    _wants_round_events = False

    def _trace_rmw_round(self, le: LocalEntry, phase: Phase, *, ts: TS,
                         log_no: int, rmw_id: RmwId, value: Optional[int],
                         base_ts: TS, val_log: int, aboard: bool = False,
                         helping: bool = False) -> None:
        if self.issuer_trace is None and not self._wants_round_events:
            return
        self._note_rmw_round(RmwRound(
            sess=le.sess, phase=phase, lid=le.lid, key=le.key, ts=ts,
            log_no=log_no, rmw_id=rmw_id,
            value=0 if value is None else value,
            has_value=0 if value is None else 1,
            base_ts=base_ts, val_log=val_log, aboard=int(aboard),
            helping=int(helping), lth_counter=le.log_too_high_counter))

    def _note_rmw_round(self, ev: RmwRound) -> None:
        """Round-start hook: every propose/accept/commit broadcast reloads
        the session's issuer lane.  The scalar machine only records it for
        the differential replay; the batched machine (serve/paxos) overrides
        this to reload its live ProposerTable lane."""
        if self.issuer_trace is not None:
            self.issuer_trace.append(ev)

    def _bcast_proposes(self, le: LocalEntry, local_ack: bool) -> None:
        if self.obs is not None:
            # a propose round means the op is on the classic CP machinery:
            # the §9 fast path never proposes
            self.obs.rmw_classic(self._obs_rmw[le.sess], self._now())
        le.state = LEState.PROPOSED
        le.lid = self._new_lid(le.sess)
        le.round_age = 0
        le.all_aboard = False
        le.tally.reset(le.lid, self.view.n)
        kv = get_kv(self.kvs, le.key)
        self._trace_rmw_round(le, Phase.PROPOSED, ts=le.ts, log_no=le.log_no,
                              rmw_id=le.rmw_id, value=0, base_ts=kv.base_ts,
                              val_log=kv.val_log)
        self._broadcast(Msg(MsgKind.PROPOSE, self.mid, key=le.key, ts=le.ts,
                            log_no=le.log_no, rmw_id=le.rmw_id,
                            base_ts=kv.base_ts, val_log=kv.val_log,
                            lid=le.lid))
        if local_ack:
            # The local KVS's reply (we already hold the pair): a plain Ack.
            self._note_local(le, Reply(MsgKind.PROP_REPLY, self.mid, Rep.ACK,
                                       le.lid, key=le.key))

    # -- All-aboard fast path (§9) -------------------------------------------------

    def _start_all_aboard(self, le: LocalEntry, kv: KVPair) -> None:
        le.ts = TS(ALL_ABOARD_VERSION, self.mid)
        kv.state = KVState.ACCEPTED
        kv.log_no = le.log_no
        kv.proposed_ts = le.ts
        kv.rmw_id = le.rmw_id
        self._compute_accept_values(le, kv)
        le.all_aboard_timeout_counter = 0
        self.bump("all_aboard_attempts")
        if self.obs is not None:
            self.obs.rmw_aboard(self._obs_rmw[le.sess], self._now())
        self._bcast_accepts(le, value=le.accepted_value, rmw_id=le.rmw_id,
                            base_ts=le.base_ts, aboard=True)

    # -- local accept (§8.5) --------------------------------------------------------

    def _compute_accept_values(self, le: LocalEntry, kv: KVPair) -> None:
        """Decide value-to-read / value-to-write and the base-TS (§10.1):
        the freshest of the local KV value and any Ack-base-TS-stale payload.

        §10.1 invariant: an RMW selects its (value, base-TS) at its *first*
        local accept for a slot; every re-accept in the same slot (retry,
        helping-myself, §8.3 fastpath) must reuse them.  Recomputing is
        unsound: the pre-state can change (an ABD write landing locally, a
        fresher Ack-base-TS-stale payload) while the original accept may
        already be decided via a majority we did not observe — the same slot
        would then commit two different values.
        """
        if le.accepted_log_no == le.log_no and le.base_ts_looked_up:
            kv.accepted_ts = le.ts
            kv.accepted_value = le.accepted_value
            kv.acc_base_ts = le.base_ts
            return
        pre_value, pre_cs = kv.value, kv.carstamp
        if le.tally.fresh_value is not None and le.tally.fresh_cs > pre_cs:
            pre_value, pre_cs = le.tally.fresh_value, le.tally.fresh_cs
        le.value_to_read = pre_value
        le.base_ts = pre_cs.base
        le.accepted_value = apply_rmw(le.op, pre_value, le.arg1, le.arg2)
        le.accepted_log_no = le.log_no
        kv.accepted_ts = le.ts
        kv.accepted_value = le.accepted_value
        kv.acc_base_ts = le.base_ts
        le.base_ts_looked_up = True

    def _local_accept_own(self, le: LocalEntry) -> bool:
        """§8.5 'not helping' (also the §6 majority-acks path when the pair
        was locally accepted for someone else: PROPOSE_LOCALLY_ACCEPTED)."""
        if self.registry.is_registered(le.rmw_id):
            self._on_learned_committed(le, no_bcast=False)
            return False
        kv = get_kv(self.kvs, le.key)
        ok = (kv.log_no == le.log_no and kv.proposed_ts == le.ts
              and (kv.rmw_id == le.rmw_id
                   or le.helping_flag == HelpFlag.PROPOSE_LOCALLY_ACCEPTED)
              and kv.state in (KVState.PROPOSED, KVState.ACCEPTED))
        if not ok:
            le.helping_flag = HelpFlag.NOT_HELPING
            le.state = LEState.NEEDS_KV
            return False
        kv.state = KVState.ACCEPTED
        kv.rmw_id = le.rmw_id
        le.helping_flag = HelpFlag.NOT_HELPING
        self._compute_accept_values(le, kv)
        self._bcast_accepts(le, value=le.accepted_value, rmw_id=le.rmw_id,
                            base_ts=le.base_ts)
        return True

    def _local_accept_help(self, le: LocalEntry) -> bool:
        """§8.5 'helping': the four legal cases, else stop helping."""
        kv = get_kv(self.kvs, le.key)
        h = le.help
        case1 = (kv.state == KVState.PROPOSED and kv.log_no == le.log_no
                 and kv.proposed_ts == le.ts)
        case2 = (kv.state == KVState.INVALID
                 and kv.last_committed_log_no == le.log_no - 1)
        case34 = (kv.state == KVState.ACCEPTED and kv.log_no == le.log_no
                  and kv.proposed_ts == le.ts and h.acc_ts >= kv.accepted_ts)
        if not (case1 or case2 or case34):
            le.helping_flag = HelpFlag.NOT_HELPING
            le.state = LEState.NEEDS_KV
            self.bump("help_aborted")
            return False
        kv.state = KVState.ACCEPTED
        kv.log_no = le.log_no
        kv.proposed_ts = le.ts
        kv.accepted_ts = le.ts           # Paxos helping rule: OUR TS (§6)
        kv.accepted_value = h.value
        kv.acc_base_ts = h.base_ts
        kv.rmw_id = h.rmw_id
        self.bump("helps")
        if self.obs is not None:
            self.obs.rmw_help(self._obs_rmw[le.sess], self._now())
        self._bcast_accepts(le, value=h.value, rmw_id=h.rmw_id,
                            base_ts=h.base_ts)
        return True

    def _bcast_accepts(self, le: LocalEntry, *, value: int, rmw_id: RmwId,
                       base_ts: TS, aboard: bool = False) -> None:
        le.state = LEState.ACCEPTED
        le.lid = self._new_lid(le.sess)
        le.round_age = 0
        le.all_aboard = aboard
        le.tally.reset(le.lid, self.view.n)
        self._trace_rmw_round(le, Phase.ACCEPTED, ts=le.ts, log_no=le.log_no,
                              rmw_id=rmw_id, value=value, base_ts=base_ts,
                              val_log=le.log_no, aboard=aboard,
                              helping=le.helping_flag == HelpFlag.HELPING)
        self._broadcast(Msg(MsgKind.ACCEPT, self.mid, key=le.key, ts=le.ts,
                            log_no=le.log_no, rmw_id=rmw_id, value=value,
                            base_ts=base_ts, val_log=le.log_no, lid=le.lid))
        # Local accept already happened -> implicit local Ack (§4.6).
        self._note_local(le, Reply(MsgKind.ACC_REPLY, self.mid, Rep.ACK,
                                   le.lid, key=le.key))

    # -- propose replies (§4.3) -----------------------------------------------------

    # decision payload builders are shared with the replay shadow:
    _retry_payload = staticmethod(proposer.retry_payload)
    _ltl_payload = staticmethod(proposer.log_too_low_payload)
    _help_payload = staticmethod(proposer.lower_acc_payload)

    def _check_propose_replies(self, le: LocalEntry) -> None:
        t = le.tally
        d, payload = proposer.decide_propose(
            t, majority=self.view.quorum(), own_rmw_id=le.rmw_id,
            log_too_high_counter=le.log_too_high_counter,
            log_too_high_threshold=self.cfg.log_too_high_threshold)
        if d == Decision.WAIT:
            # Majority of replies but no decision (e.g. mixed acks below
            # quorum): wait for stragglers; the retransmit timer resolves
            # true losses.
            return
        if d in (Decision.LEARNED, Decision.LEARNED_NO_BCAST):
            self._trace_decision(le.sess, d)
            self._on_learned_committed(
                le, no_bcast=d == Decision.LEARNED_NO_BCAST)
        elif d == Decision.LOG_TOO_LOW:
            self._trace_decision(le.sess, d, self._ltl_payload(payload))
            self._apply_log_too_low(le, payload)
        elif d == Decision.RETRY:
            self._trace_decision(le.sess, d, self._retry_payload(t))
            le.retry_version = max(le.retry_version, t.seen_higher.version + 1)
            self._enter_retry(le)
        elif d == Decision.LOCAL_ACCEPT:
            self._trace_decision(le.sess, d)
            self._local_accept_own(le)
        elif d in (Decision.HELP, Decision.HELP_SELF):
            self._trace_decision(le.sess, d, self._help_payload(payload))
            self._begin_help(le, payload)
        elif d == Decision.RECOMMIT:
            self._trace_decision(le.sess, d)
            self._apply_recommit(le)
        elif d == Decision.RETRY_LOG_TOO_HIGH:
            self._trace_decision(le.sess, d)
            le.log_too_high_counter += 1
            self._enter_retry(le)

    def _apply_recommit(self, le: LocalEntry) -> None:
        """§8.7: the previous slot's commit may have been lost with its
        issuer; re-broadcast it from our local last-committed state."""
        le.log_too_high_counter = 0
        kv = get_kv(self.kvs, le.key)
        le.help.rmw_id = kv.last_committed_rmw_id
        le.help.value = kv.value
        le.help.base_ts = kv.base_ts
        le.help.log_no = kv.last_committed_log_no
        le.help.val_log = kv.val_log
        le.state = LEState.BCAST_COMMITS_FROM_HELP
        le.all_acked = False
        self.bump("log_too_high_recommit")

    def _begin_help(self, le: LocalEntry, rep: Reply) -> None:
        """§6: help the accept with the highest accepted-TS."""
        if rep.rmw_id == le.rmw_id:
            # Helping myself (§8.4): act as if a majority of acks arrived,
            # re-accepting our own previously-computed value at our new TS.
            kv = get_kv(self.kvs, le.key)
            ok = (kv.state == KVState.ACCEPTED and kv.log_no == le.log_no
                  and kv.rmw_id == le.rmw_id and kv.proposed_ts == le.ts)
            if not ok:
                le.helping_flag = HelpFlag.NOT_HELPING
                le.state = LEState.NEEDS_KV
                return
            le.helping_flag = HelpFlag.NOT_HELPING
            kv.accepted_ts = le.ts
            le.accepted_value = kv.accepted_value
            le.base_ts = kv.acc_base_ts
            le.accepted_log_no = le.log_no
            self.bump("helped_self")
            self._bcast_accepts(le, value=kv.accepted_value, rmw_id=le.rmw_id,
                                base_ts=kv.acc_base_ts)
            return
        le.helping_flag = HelpFlag.HELPING
        le.help.rmw_id = rep.rmw_id
        le.help.value = rep.value
        le.help.base_ts = rep.base_ts
        le.help.acc_ts = rep.ts
        le.help.log_no = le.log_no
        le.help.val_log = le.log_no
        self._local_accept_help(le)

    # -- accept replies (§4.6, §9.2) ---------------------------------------------------

    def _commit_bcast_payload(self, le: LocalEntry, helping: bool,
                              all_acked: bool) -> dict:
        if helping:
            log_no, rmw_id = le.help.log_no, le.help.rmw_id
            value, base_ts, val_log = (le.help.value, le.help.base_ts,
                                       le.help.val_log)
        else:
            log_no, rmw_id = le.accepted_log_no, le.rmw_id
            value, base_ts, val_log = (le.accepted_value, le.base_ts,
                                       le.accepted_log_no)
        return {"log_no": log_no, "rmw_cnt": rmw_id.counter,
                "rmw_sess": rmw_id.gsess,
                "value": 0 if all_acked else value,
                "has_value": 0 if all_acked else 1,
                "base_v": base_ts.version, "base_m": base_ts.mid,
                "val_log": val_log}

    def _check_accept_replies(self, le: LocalEntry) -> None:
        t = le.tally
        helping = le.helping_flag == HelpFlag.HELPING
        d, payload = proposer.decide_accept(
            t, n_machines=self.view.all_aboard_quorum(),
            majority=self.view.quorum(), helping=helping,
            all_aboard=le.all_aboard)
        if d == Decision.WAIT:
            # majority replied, only acks but below the required quorum
            # (all-aboard waiting for everyone): handled by inspection
            # timeouts.
            return
        if d == Decision.STOP_HELP:
            # h-RMW already committed (§8.5), or any nack cancels help (§4.6)
            self._trace_decision(le.sess, d)
            self._stop_helping(le)
        elif d in (Decision.LEARNED, Decision.LEARNED_NO_BCAST):
            self._trace_decision(le.sess, d)
            self._on_learned_committed(
                le, no_bcast=d == Decision.LEARNED_NO_BCAST)
        elif d == Decision.LOG_TOO_LOW:
            self._trace_decision(le.sess, d, self._ltl_payload(payload))
            self._apply_log_too_low(le, payload)
        elif d == Decision.COMMIT_BCAST:
            le.all_acked = t.acks >= self.view.all_aboard_quorum()
            self._trace_decision(le.sess, d, self._commit_bcast_payload(
                le, helping, le.all_acked))
            self._apply_commit_bcast(le, helping)
        elif d == Decision.RETRY:
            self._trace_decision(le.sess, d, self._retry_payload(t))
            if t.seen_higher is not None:
                le.retry_version = max(le.retry_version,
                                       t.seen_higher.version + 1)
            if le.all_aboard:
                self.bump("all_aboard_fallbacks")
                if self.obs is not None:
                    self.obs.op_event(self._obs_rmw[le.sess], self._now(),
                                      "all_aboard_fallback")
            self._enter_retry(le)

    def _apply_commit_bcast(self, le: LocalEntry, helping: bool) -> None:
        """Accept quorum reached (``le.all_acked`` already set): schedule
        the commit broadcast for the next inspection."""
        if le.all_aboard and le.all_acked:
            self.bump("all_aboard_successes")
        le.state = (LEState.BCAST_COMMITS_FROM_HELP if helping
                    else LEState.BCAST_COMMITS)
        le.round_age = 0

    def _stop_helping(self, le: LocalEntry) -> None:
        self._trace_pause(le.sess)
        le.helping_flag = HelpFlag.NOT_HELPING
        le.state = LEState.NEEDS_KV
        le.back_off_counter = 0
        le.kv_snapshot = ()

    # -- shared outcomes ------------------------------------------------------------

    def _on_learned_committed(self, le: LocalEntry, no_bcast: bool) -> None:
        """Rmw-id-committed handling (§8.1): our RMW is already committed
        (it was helped). Commit it locally from the Local-entry's accepted
        value — §7.2.2 proves this is the value it committed with."""
        assert le.accepted_log_no > 0, \
            "an RMW can only be helped after it was locally accepted (§7.2.2)"
        kv = get_kv(self.kvs, le.key)
        # §8.1 release optimization: drop a pair grabbed for a later slot.
        if (le.accepted_log_no < le.log_no and kv.state == KVState.PROPOSED
                and kv.rmw_id == le.rmw_id and kv.log_no == le.log_no):
            kv.state = KVState.INVALID
        commit_to_kv(kv, self.registry, log_no=le.accepted_log_no,
                     rmw_id=le.rmw_id, value=le.accepted_value,
                     base_ts=le.base_ts, val_log=le.accepted_log_no)
        self._record_commit(le.key, le.accepted_log_no, le.rmw_id,
                            le.accepted_value, le.base_ts, kv)
        self.bump("learned_committed")
        if self.obs is not None:
            # helped to completion: by definition not the §9 fast path
            self.obs.rmw_classic(self._obs_rmw[le.sess], self._now(),
                                 "learned_committed")
        if no_bcast:
            self._complete_rmw(le)
        else:
            le.help.rmw_id = le.rmw_id
            le.help.value = le.accepted_value
            le.help.base_ts = le.base_ts
            le.help.log_no = le.accepted_log_no
            le.help.val_log = le.accepted_log_no
            le.all_acked = False
            le.state = LEState.BCAST_COMMITS_FROM_HELP
            le.helping_flag = HelpFlag.NOT_HELPING
            le.round_age = 0

    def _apply_log_too_low(self, le: LocalEntry, rep: Reply) -> None:
        """§8.2: someone else used our slot; commit their RMW locally and
        start over from scratch at a later slot."""
        kv = get_kv(self.kvs, le.key)
        commit_to_kv(kv, self.registry, log_no=rep.log_no, rmw_id=rep.rmw_id,
                     value=rep.value, base_ts=rep.base_ts, val_log=rep.val_log)
        self._record_commit(le.key, rep.log_no, rep.rmw_id, rep.value,
                            rep.base_ts, kv, val_log=rep.val_log)
        if le.helping_flag == HelpFlag.HELPING:
            self._stop_helping(le)
            return
        le.helping_flag = HelpFlag.NOT_HELPING
        le.state = LEState.NEEDS_KV
        le.back_off_counter = 0
        le.kv_snapshot = ()
        le.log_too_high_counter = 0
        le.retry_version = 0             # fresh slot, fresh TS (§8.2)
        le.retry_count = 0               # conflict resolved: reset back-off
        le.round_age = 0

    # -- retry (§8.4) -----------------------------------------------------------------

    def _enter_retry(self, le: LocalEntry) -> None:
        """Enter RETRY_WITH_HIGHER_TS with exponential back-off + stagger.

        Dueling proposers bumping TSes every inspection is the classic CP
        livelock; waiting 2^k inspections (k = consecutive retries, capped)
        plus a machine-id stagger guarantees one of them eventually runs a
        full round uncontended.
        """
        self._trace_pause(le.sess)
        if self.obs is not None:
            self.obs.rmw_retry(self._obs_rmw[le.sess], self._now())
        le.state = LEState.RETRY_WITH_HIGHER_TS
        le.round_age = 0
        le.retry_count += 1
        le.wait = min(1 << min(le.retry_count, 6), 64) + self.mid

    def _retry(self, le: LocalEntry) -> None:
        if self.registry.is_registered(le.rmw_id):
            self._on_learned_committed(le, no_bcast=False)
            return
        kv = get_kv(self.kvs, le.key)
        new_version = max(le.ts.version + 1, le.retry_version,
                          FIRST_PROPOSE_VERSION)
        le.retry_version = new_version
        if (kv.state == KVState.PROPOSED and kv.rmw_id == le.rmw_id
                and kv.log_no == le.log_no):
            le.ts = TS(new_version, self.mid)
            kv.proposed_ts = le.ts
            self._bcast_proposes(le, local_ack=True)
            return
        if kv.state == KVState.INVALID:
            le.log_no = kv.working_log()
            le.ts = TS(new_version, self.mid)
            kv.state = KVState.PROPOSED
            kv.log_no = le.log_no
            kv.proposed_ts = le.ts
            kv.rmw_id = le.rmw_id
            self._bcast_proposes(le, local_ack=True)
            return
        if (kv.state == KVState.ACCEPTED and kv.rmw_id == le.rmw_id
                and kv.log_no == le.log_no):
            # "Helping myself" (§8.4): propose while staying Accepted.
            le.ts = TS(max(new_version, kv.proposed_ts.version + 1), self.mid)
            le.retry_version = le.ts.version
            kv.proposed_ts = le.ts
            le.helping_flag = HelpFlag.PROPOSE_LOCALLY_ACCEPTED
            self._bcast_proposes(le, local_ack=False)
            self._note_local(le, Reply(MsgKind.PROP_REPLY, self.mid,
                                       Rep.SEEN_LOWER_ACC, le.lid, key=le.key,
                                       ts=kv.accepted_ts, rmw_id=kv.rmw_id,
                                       value=kv.accepted_value,
                                       base_ts=kv.acc_base_ts,
                                       val_log=kv.log_no))
            return
        le.state = LEState.NEEDS_KV
        le.back_off_counter = 0
        le.kv_snapshot = ()

    # -- commits (§4.7, §8.6, §8.7) ------------------------------------------------------

    def _bcast_commits(self, le: LocalEntry, from_help: bool) -> None:
        if from_help:
            log_no, rmw_id = le.help.log_no, le.help.rmw_id
            value, base_ts, val_log = (le.help.value, le.help.base_ts,
                                       le.help.val_log)
        else:
            log_no, rmw_id = le.accepted_log_no, le.rmw_id
            value, base_ts, val_log = (le.accepted_value, le.base_ts,
                                       le.accepted_log_no)
        wire_value = None if le.all_acked else value   # §8.6 thin commit
        le.state = LEState.COMMITTED
        le.commit_from_help = from_help
        le.lid = self._new_lid(le.sess)
        le.round_age = 0
        le.tally.reset(le.lid, self.view.n - 1)
        self._trace_rmw_round(le, Phase.COMMITTED, ts=TS_ZERO, log_no=log_no,
                              rmw_id=rmw_id, value=wire_value,
                              base_ts=base_ts, val_log=val_log)
        self._broadcast(Msg(MsgKind.COMMIT, self.mid, key=le.key,
                            log_no=log_no, rmw_id=rmw_id, value=wire_value,
                            base_ts=base_ts, val_log=val_log, lid=le.lid))
        if le.all_acked:
            self.bump("thin_commits")

    def _check_commit_acks(self, le: LocalEntry) -> None:
        # §8.7: apply the commit locally only after (a majority of) acks.
        d = proposer.decide_commit(
            le.tally, majority=self.view.quorum(),
            quorum_is_majority=self.cfg.commit_ack_quorum_is_majority)
        if d == Decision.WAIT:
            return
        self._finish_commit(le, d)

    def _finish_commit(self, le: LocalEntry,
                       d: Decision = Decision.COMMIT_DONE) -> None:
        """Commit-ack quorum reached: apply the commit locally (§8.7)."""
        self._trace_decision(le.sess, d)
        kv = get_kv(self.kvs, le.key)
        if not le.commit_from_help:
            commit_to_kv(kv, self.registry, log_no=le.accepted_log_no,
                         rmw_id=le.rmw_id, value=le.accepted_value,
                         base_ts=le.base_ts, val_log=le.accepted_log_no)
            self._record_commit(le.key, le.accepted_log_no, le.rmw_id,
                                le.accepted_value, le.base_ts, kv)
            self._complete_rmw(le)
            return
        # committed on behalf of help (or a §8.7 re-commit)
        commit_to_kv(kv, self.registry, log_no=le.help.log_no,
                     rmw_id=le.help.rmw_id, value=le.help.value,
                     base_ts=le.help.base_ts, val_log=le.help.val_log)
        self._record_commit(le.key, le.help.log_no, le.help.rmw_id,
                            le.help.value, le.help.base_ts, kv,
                            val_log=le.help.val_log)
        if le.help.rmw_id == le.rmw_id:
            # we ended up helping ourselves: the session is done (§6)
            self._complete_rmw(le)
            return
        le.helping_flag = HelpFlag.NOT_HELPING
        le.help = type(le.help)()
        le.state = LEState.NEEDS_KV
        le.back_off_counter = 0
        le.kv_snapshot = ()
        le.round_age = 0

    def _complete_rmw(self, le: LocalEntry) -> None:
        self.bump("rmw_completed")
        comp = Completion(tag=getattr(le, "tag", 0), kind=ReqKind.RMW,
                          key=le.key, value=le.value_to_read,
                          carstamp=Carstamp(le.base_ts, le.accepted_log_no),
                          rmw_id=le.rmw_id)
        self.completions.append((le.sess, comp))
        self.entries[le.sess] = LocalEntry(sess=le.sess, gsess=le.gsess)
        if self.obs is not None:
            self.obs.rmw_end(self._obs_rmw[le.sess], self._now())
            self._obs_rmw[le.sess] = None

    # -- inspection (worker loop step 2) ----------------------------------------------

    def _inspect(self, le: LocalEntry) -> None:
        if le.wait > 0 and le.state in (LEState.NEEDS_KV,
                                        LEState.RETRY_WITH_HIGHER_TS):
            le.wait -= 1
            return
        if le.state == LEState.NEEDS_KV:
            self._try_grab(le)
        elif le.state == LEState.RETRY_WITH_HIGHER_TS:
            self._retry(le)
        elif le.state == LEState.BCAST_COMMITS:
            self._bcast_commits(le, from_help=False)
        elif le.state == LEState.BCAST_COMMITS_FROM_HELP:
            self._bcast_commits(le, from_help=True)
        elif le.state in (LEState.PROPOSED, LEState.ACCEPTED,
                          LEState.COMMITTED):
            le.round_age += 1
            if self.obs is not None:
                self.obs.quorum_wait(self._obs_rmw[le.sess])
            if le.state == LEState.ACCEPTED and le.all_aboard:
                le.all_aboard_timeout_counter += 1
                if (le.all_aboard_timeout_counter
                        >= self.cfg.all_aboard_timeout):
                    # §9.2: don't wait forever for the last ack — run CP.
                    self.bump("all_aboard_timeouts")
                    if self.obs is not None:
                        self.obs.op_event(self._obs_rmw[le.sess],
                                          self._now(), "all_aboard_timeout")
                    self._enter_retry(le)
                    return
            if le.round_age >= self.cfg.retransmit_threshold:
                # A round stalled (drops / crashed peers). Retrying with a
                # higher TS is always safe and regains liveness.
                self.bump("round_timeouts")
                le.round_age = 0
                if le.state == LEState.COMMITTED:
                    self._bcast_commits(le, from_help=le.commit_from_help)
                elif le.helping_flag == HelpFlag.HELPING:
                    self._stop_helping(le)
                else:
                    self._enter_retry(le)

    # =================================================================
    # ABD writes (§10) and reads (§11)
    # =================================================================

    def _trace_abd_round(self, ab: AbdEntry, *, rep_bits: int = 0,
                         store_bits: int = 0) -> None:
        if self.issuer_trace is None and not self._wants_round_events:
            return
        self._note_abd_round(AbdRound(
            sess=ab.sess, phase=ab.phase, lid=ab.lid, key=ab.key,
            value=(ab.best_value if ab.phase in (AbdPhase.R_QUERY,
                                                 AbdPhase.R_COMMIT)
                   else ab.value),
            base_ts=(ab.best_cs.base if ab.phase in (AbdPhase.R_QUERY,
                                                     AbdPhase.R_COMMIT)
                     else ab.max_base),
            val_log=ab.best_cs.log_no,
            sent_base_ts=ab.sent_cs.base, sent_val_log=ab.sent_cs.log_no,
            log_no=ab.best_log_no, rmw_id=ab.best_rmw_id,
            rep_bits=rep_bits, store_bits=store_bits))

    def _note_abd_round(self, ev: AbdRound) -> None:
        """ABD phase-start hook — see :meth:`_note_rmw_round`."""
        if self.issuer_trace is not None:
            self.issuer_trace.append(ev)

    def _start_write(self, sess: int, req: Request) -> None:
        ab = self.abd[sess]
        ab.__init__(sess=sess)
        ab.phase = AbdPhase.W_QUERY
        ab.key, ab.value, ab.tag = req.key, req.value, req.tag
        ab.lid = self._new_lid(sess)
        kv = get_kv(self.kvs, req.key)
        ab.max_base = kv.base_ts
        ab.repliers = {self.mid}                     # local reply
        self.bump("writes_started")
        if self.obs is not None:
            self._obs_abd[sess] = self.obs.op_begin(
                self.mid, sess, "write", req.key, req.tag, self._now())
        self._trace_abd_round(ab, rep_bits=1 << self.mid)
        self._broadcast(Msg(MsgKind.WRITE_QUERY, self.mid, key=req.key,
                            lid=ab.lid))

    def _start_read(self, sess: int, req: Request) -> None:
        ab = self.abd[sess]
        ab.__init__(sess=sess)
        ab.phase = AbdPhase.R_QUERY
        ab.key, ab.tag = req.key, req.tag
        ab.lid = self._new_lid(sess)
        kv = get_kv(self.kvs, req.key)
        ab.sent_cs = kv.carstamp
        ab.best_cs = kv.carstamp
        ab.best_value = kv.value
        ab.best_log_no = kv.last_committed_log_no
        ab.best_rmw_id = kv.last_committed_rmw_id
        ab.repliers = {self.mid}
        ab.storers = {self.mid}                      # we store it ourselves
        self.bump("reads_started")
        if self.obs is not None:
            self._obs_abd[sess] = self.obs.op_begin(
                self.mid, sess, "read", req.key, req.tag, self._now())
        self._trace_abd_round(ab, rep_bits=1 << self.mid,
                              store_bits=1 << self.mid)
        self._broadcast(Msg(MsgKind.READ_QUERY, self.mid, key=req.key,
                            base_ts=kv.base_ts, val_log=kv.val_log,
                            lid=ab.lid))

    def _abd_reply(self, ab: AbdEntry, rep: Reply) -> None:
        # Fold + decide via the pure issuer transitions (§10–§11 quorums),
        # shared with the batched engine in repro_torch.core.proposer_vector.
        if not proposer.abd_fold(ab, rep):
            return
        d = proposer.decide_abd(ab, majority=self.view.quorum())
        if d == Decision.WAIT:
            return
        if d == Decision.ABD_W2:
            self._trace_decision(ab.sess, d, {
                "key": ab.key, "value": ab.value,
                "base_v": ab.max_base.version, "base_m": ab.max_base.mid})
            self._write_phase2(ab)
        elif d == Decision.ABD_W_DONE:
            self._trace_decision(ab.sess, d)
            self._complete_abd(ab, ReqKind.WRITE, ab.value,
                               Carstamp(ab.max_base, 0))
        elif d == Decision.ABD_R_DONE:
            self._trace_decision(ab.sess, d)
            self._complete_abd(ab, ReqKind.READ, ab.best_value, ab.best_cs)
        elif d == Decision.ABD_R_WB:
            self._trace_decision(ab.sess, d, {
                "key": ab.key, "log_no": ab.best_log_no,
                "rmw_cnt": ab.best_rmw_id.counter,
                "rmw_sess": ab.best_rmw_id.gsess, "value": ab.best_value,
                "base_v": ab.best_cs.base.version,
                "base_m": ab.best_cs.base.mid,
                "val_log": ab.best_cs.log_no})
            self._read_write_back(ab)                # §11 commit round
        elif d == Decision.ABD_RC_DONE:
            self._trace_decision(ab.sess, d)
            self._complete_abd(ab, ReqKind.READ, ab.best_value, ab.best_cs)

    def _write_phase2(self, ab: AbdEntry) -> None:
        if self.obs is not None:
            self.obs.op_event(self._obs_abd[ab.sess], self._now(),
                              "write_phase2")
        ab.phase = AbdPhase.W_WRITE
        ab.ackers = set()
        ab.lid = self._new_lid(ab.sess)
        self.write_clock = max(self.write_clock + 1, ab.max_base.version + 1)
        ab.max_base = TS(self.write_clock, self.mid)
        self.write_log.append((ab.key, ab.max_base, ab.value))
        self._trace_abd_round(ab)
        kv = get_kv(self.kvs, ab.key)
        msg = Msg(MsgKind.WRITE, self.mid, key=ab.key, value=ab.value,
                  base_ts=ab.max_base, lid=ab.lid)
        handlers.on_write(kv, msg)                   # local apply
        self._broadcast(msg)

    def _read_write_back(self, ab: AbdEntry) -> None:
        """§11: not certain a majority stores the value we are about to read
        — broadcast a (Paxos) commit for it first. Commits can be acked by
        every node regardless of its Paxos state."""
        ab.phase = AbdPhase.R_COMMIT
        ab.ackers = set()
        ab.lid = self._new_lid(ab.sess)
        self.bump("read_write_backs")
        if self.obs is not None:
            self.obs.op_event(self._obs_abd[ab.sess], self._now(),
                              "read_write_back")
        self._trace_abd_round(ab)
        kv = get_kv(self.kvs, ab.key)
        msg = Msg(MsgKind.READ_COMMIT, self.mid, key=ab.key,
                  log_no=ab.best_log_no, rmw_id=ab.best_rmw_id,
                  value=ab.best_value, base_ts=ab.best_cs.base,
                  val_log=ab.best_cs.log_no, lid=ab.lid)
        handlers.on_commit(kv, msg, self.registry)   # local apply
        self._record_commit(ab.key, ab.best_log_no, ab.best_rmw_id,
                            ab.best_value, ab.best_cs.base, kv,
                            val_log=ab.best_cs.log_no)
        self._broadcast(msg)

    def _complete_abd(self, ab: AbdEntry, kind: ReqKind, value: int,
                      cs: Carstamp) -> None:
        self.bump("writes_completed" if kind == ReqKind.WRITE
                  else "reads_completed")
        self.completions.append(
            (ab.sess, Completion(tag=ab.tag, kind=kind, key=ab.key,
                                 value=value, carstamp=cs)))
        ab.phase = AbdPhase.IDLE
        if self.obs is not None:
            self.obs.abd_end(self._obs_abd[ab.sess], self._now())
            self._obs_abd[ab.sess] = None

    def _inspect_abd(self, ab: AbdEntry) -> None:
        """Liveness: retransmit the *current phase's* message verbatim.

        Never restart an ABD op from scratch — a write whose phase-2 message
        partially installed must keep its chosen base-TS; re-querying would
        install the same client write at a second, higher carstamp, erasing
        any RMW serialized between the two installs.  Retransmission with
        the same lid/TS is idempotent at every receiver.
        """
        ab.round_age += 1
        if self.obs is not None:
            self.obs.quorum_wait(self._obs_abd[ab.sess])
        if ab.round_age < self.cfg.retransmit_threshold:
            return
        ab.round_age = 0
        self.bump("abd_retransmits")
        if self.obs is not None:
            self.obs.op_event(self._obs_abd[ab.sess], self._now(),
                              "abd_retransmit")
        if ab.phase == AbdPhase.W_QUERY:
            self._broadcast(Msg(MsgKind.WRITE_QUERY, self.mid, key=ab.key,
                                lid=ab.lid))
        elif ab.phase == AbdPhase.W_WRITE:
            self._broadcast(Msg(MsgKind.WRITE, self.mid, key=ab.key,
                                value=ab.value, base_ts=ab.max_base,
                                lid=ab.lid))
        elif ab.phase == AbdPhase.R_QUERY:
            self._broadcast(Msg(MsgKind.READ_QUERY, self.mid, key=ab.key,
                                base_ts=ab.sent_cs.base,
                                val_log=ab.sent_cs.log_no, lid=ab.lid))
        elif ab.phase == AbdPhase.R_COMMIT:
            self._broadcast(Msg(MsgKind.READ_COMMIT, self.mid, key=ab.key,
                                log_no=ab.best_log_no, rmw_id=ab.best_rmw_id,
                                value=ab.best_value, base_ts=ab.best_cs.base,
                                val_log=ab.best_cs.log_no, lid=ab.lid))
