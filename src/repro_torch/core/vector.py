"""Vectorized (SIMD) receiver engine in PyTorch — the plain version of the
``paxos_apply`` CUDA kernel.

Port of ``repro.core.vector``: the receiver-side hot loop ("apply one
message per key to the KV-pair metadata table and emit replies") as a
branch-free select network over struct-of-arrays int32 planes.  Every
function here is the same network as the reference, line for line, written
in ``torch`` ops, so the two agree bit for bit on the same planes
(``tests/test_torch_vector.py``).  :func:`apply_batch` is the plain
version that the CUDA kernel (``csrc/paxos_apply.cu``) is held against on
the card, and the path the kernel's wrapper takes for CPU tensors.

The message vocabulary, the conflict-free-batch contract and the
machine-axis batching property are those of the reference module: lanes
are independent, a ``NOOP`` message lane leaves its KV lane bit-identical,
and stacking N machines' tables as ``(M, K)`` planes flattened to
``(M*K,)`` lanes runs N replica steps in one call.  The per-session
registry gather/scatter lives outside the lane-parallel core
(``is_registered`` is a precomputed bool input lane; commit registrations
come back as a mask for :func:`repro_torch.kernels.paxos_apply.ops.
scatter_register`).

Dtypes follow the reference: every plane is int32, the predicates are
bool.  ``~`` on a bool tensor is logical NOT and on an int32 plane is
bitwise NOT, exactly as in ``jnp``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..device import DeviceLike, int32_planes, resolve_device
from .types import KVState, MsgKind, Rep

# message kinds in the vector engine: the RMW path ...
NOOP, PROPOSE, ACCEPT, COMMIT = 0, 1, 2, 3
# ... and the ABD path (§10–§11)
WRITE_QUERY, WRITE, READ_QUERY, READ_COMMIT = 4, 5, 6, 7

# wire MsgKind -> vector lane kind, for every receiver-side message
VEC_KIND = {
    MsgKind.PROPOSE: PROPOSE,
    MsgKind.ACCEPT: ACCEPT,
    MsgKind.COMMIT: COMMIT,
    MsgKind.WRITE_QUERY: WRITE_QUERY,
    MsgKind.WRITE: WRITE,
    MsgKind.READ_QUERY: READ_QUERY,
    MsgKind.READ_COMMIT: READ_COMMIT,
}

# vector lane kind -> reply MsgKind emitted on that lane
REPLY_KIND = {
    PROPOSE: MsgKind.PROP_REPLY,
    ACCEPT: MsgKind.ACC_REPLY,
    COMMIT: MsgKind.COMMIT_ACK,
    WRITE_QUERY: MsgKind.WRITE_QUERY_REPLY,
    WRITE: MsgKind.WRITE_ACK,
    READ_QUERY: MsgKind.READ_QUERY_REPLY,
    READ_COMMIT: MsgKind.COMMIT_ACK,
}

I32 = torch.int32


def _from_numpy(cls, planes, device: DeviceLike):
    return cls(*int32_planes(planes, len(cls._fields), device).unbind(0))


class KVTable(NamedTuple):
    """Struct-of-arrays KV-pair metadata (§3.1.1), one lane per key."""

    state: torch.Tensor         # KVState: 0 invalid / 1 proposed / 2 accepted
    log_no: torch.Tensor
    last_log: torch.Tensor      # last-committed-log-no
    prop_v: torch.Tensor        # proposed-TS (version, machine)
    prop_m: torch.Tensor
    acc_v: torch.Tensor         # accepted-TS
    acc_m: torch.Tensor
    acc_val: torch.Tensor       # accepted-value
    acc_base_v: torch.Tensor    # acc-base-TS (§10.3)
    acc_base_m: torch.Tensor
    rmw_cnt: torch.Tensor       # rmw-id working on log_no
    rmw_sess: torch.Tensor
    value: torch.Tensor
    base_v: torch.Tensor        # carstamp base of `value`
    base_m: torch.Tensor
    val_log: torch.Tensor       # carstamp log part of `value`
    last_rmw_cnt: torch.Tensor  # last-committed rmw-id
    last_rmw_sess: torch.Tensor

    @staticmethod
    def create(n_keys: int, device: DeviceLike = None) -> "KVTable":
        z = torch.zeros((n_keys,), dtype=I32, device=resolve_device(device))
        return KVTable(*([z] * 18))

    @staticmethod
    def fresh(n_keys: int, device: DeviceLike = None) -> "KVTable":
        """All-default table matching ``KVPair()`` field defaults exactly
        (TS_ZERO mids and RMW_ID_NONE sessions are ``-1``, not ``0``)."""
        dev = resolve_device(device)
        z = torch.zeros((n_keys,), dtype=I32, device=dev)
        neg = torch.full((n_keys,), -1, dtype=I32, device=dev)
        return KVTable(
            state=z, log_no=z, last_log=z,
            prop_v=z, prop_m=neg, acc_v=z, acc_m=neg, acc_val=z,
            acc_base_v=z, acc_base_m=neg,
            rmw_cnt=z, rmw_sess=neg,
            value=z, base_v=z, base_m=neg, val_log=z,
            last_rmw_cnt=z, last_rmw_sess=neg,
        )

    @classmethod
    def from_numpy(cls, planes, device: DeviceLike = None) -> "KVTable":
        """Planes from numpy: a stacked ``(18, ...)`` array or the
        reference's NamedTuple of arrays (copied to ``device``)."""
        return _from_numpy(cls, planes, device)


class MsgBatch(NamedTuple):
    """One message per key lane (``kind = NOOP`` for idle lanes)."""

    kind: torch.Tensor
    ts_v: torch.Tensor
    ts_m: torch.Tensor
    log_no: torch.Tensor
    rmw_cnt: torch.Tensor
    rmw_sess: torch.Tensor
    value: torch.Tensor
    base_v: torch.Tensor
    base_m: torch.Tensor
    val_log: torch.Tensor
    has_value: torch.Tensor     # 0 for §8.6 thin commits

    @staticmethod
    def noop(n_keys: int, device: DeviceLike = None) -> "MsgBatch":
        dev = resolve_device(device)
        z = torch.zeros((n_keys,), dtype=I32, device=dev)
        return MsgBatch(z, z, z, z, z, z, z, z, z, z,
                        torch.ones((n_keys,), dtype=I32, device=dev))

    @classmethod
    def from_numpy(cls, planes, device: DeviceLike = None) -> "MsgBatch":
        return _from_numpy(cls, planes, device)


class ReplyBatch(NamedTuple):
    """Reply lanes (kind + opcode + payloads, presence per opcode)."""

    kind: torch.Tensor          # reply MsgKind (REPLY_KIND), -1 for NOOP lanes
    opcode: torch.Tensor        # Rep value, or -1 for NOOP lanes
    ts_v: torch.Tensor          # Seen-higher-*: blocking proposed-TS
    ts_m: torch.Tensor
    log_no: torch.Tensor        # Log-too-low: last committed log-no
    rmw_cnt: torch.Tensor
    rmw_sess: torch.Tensor
    value: torch.Tensor
    base_v: torch.Tensor
    base_m: torch.Tensor
    val_log: torch.Tensor

    @classmethod
    def from_numpy(cls, planes, device: DeviceLike = None) -> "ReplyBatch":
        return _from_numpy(cls, planes, device)


# -- TS / carstamp lattice helpers (lexicographic int pairs) -----------------

def ts_lt(av, am, bv, bm):
    return (av < bv) | ((av == bv) & (am < bm))


def ts_gt(av, am, bv, bm):
    return ts_lt(bv, bm, av, am)


def ts_ge(av, am, bv, bm):
    return ~ts_lt(av, am, bv, bm)


def cs_gt(abase_v, abase_m, alog, bbase_v, bbase_m, blog):
    """Carstamp (base-TS, log) lexicographic greater-than (§10)."""
    base_eq = (abase_v == bbase_v) & (abase_m == bbase_m)
    return ts_gt(abase_v, abase_m, bbase_v, bbase_m) | (base_eq & (alog > blog))


def popcount8(x):
    """Branch-free population count of the low 8 bits of int32 bitmasks
    (per-machine reply bitmaps, n_machines <= 7, §3)."""
    total = x & 1
    for i in range(1, 8):
        total = total + ((x >> i) & 1)
    return total


def _where(c, a, b):
    """``jnp.where`` with int32 results: a Python-int pair becomes an
    int32 plane (torch would otherwise pick int64)."""
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        a = torch.full(c.shape, a, dtype=I32, device=c.device)
    return torch.where(c, a, b)


# ---------------------------------------------------------------------------
# The fused receiver step (mirrors handlers.on_propose/on_accept/on_commit)
# ---------------------------------------------------------------------------

def apply_batch(kv: KVTable, msg: MsgBatch,
                is_registered: torch.Tensor
                ) -> Tuple[KVTable, ReplyBatch, torch.Tensor]:
    """Apply one conflict-free message batch to the KV table.

    Returns ``(new_table, replies, register_mask)`` where ``register_mask``
    (bool) marks lanes whose (rmw_cnt, rmw_sess) must be registered by the
    caller (commit lanes only — the registry is a gather/scatter
    structure).  ``is_registered`` is a bool plane.
    """
    is_prop_msg = msg.kind == PROPOSE
    is_acc_msg = msg.kind == ACCEPT
    # §11 read write-backs are commits on the receiver (handlers.apply_msg)
    is_commit = (msg.kind == COMMIT) | (msg.kind == READ_COMMIT)
    is_wq = msg.kind == WRITE_QUERY
    is_w = msg.kind == WRITE
    is_rq = msg.kind == READ_QUERY
    active = msg.kind != NOOP
    pa = is_prop_msg | is_acc_msg           # propose-or-accept path

    # ---- common prefix: rmw-id + log window checks (§4.2) -----------------
    registered = pa & is_registered
    committed_no_bcast = registered & (kv.last_log >= msg.log_no)
    r_rmw_committed = registered & ~committed_no_bcast
    not_reg = pa & ~registered
    r_log_too_low = not_reg & (msg.log_no <= kv.last_log)
    r_log_too_high = not_reg & ~r_log_too_low & (msg.log_no > kv.last_log + 1)
    in_window = not_reg & ~r_log_too_low & ~r_log_too_high

    st_prop = kv.state == int(KVState.PROPOSED)
    st_acc = kv.state == int(KVState.ACCEPTED)

    # proposed-TS comparison: proposes block on >=, accepts only on > (§4.5)
    prop_blocks_prop = ts_ge(kv.prop_v, kv.prop_m, msg.ts_v, msg.ts_m)
    prop_blocks_acc = ts_gt(kv.prop_v, kv.prop_m, msg.ts_v, msg.ts_m)

    # ---- propose path (§4.2, §8.3, §10.3) ---------------------------------
    p = in_window & is_prop_msg
    p_seen_higher_prop = p & st_prop & prop_blocks_prop
    p_seen_higher_acc = p & st_acc & prop_blocks_prop
    same_rmw = (kv.rmw_cnt == msg.rmw_cnt) & (kv.rmw_sess == msg.rmw_sess)
    # §8.3 fastpath: same rmw accepted with both TSes lower -> plain Ack
    p_fast = (p & st_acc & ~prop_blocks_prop & same_rmw
              & ts_lt(kv.acc_v, kv.acc_m, msg.ts_v, msg.ts_m))
    p_seen_lower_acc = p & st_acc & ~prop_blocks_prop & ~p_fast
    p_ack_fresh = p & ~st_prop & ~st_acc                      # INVALID
    p_ack_prop = p & st_prop & ~prop_blocks_prop              # lower propose
    p_ack = p_ack_fresh | p_ack_prop | p_fast
    # §10.3: ack carrying a stale base-TS ships the fresher local value
    base_stale = cs_gt(kv.base_v, kv.base_m, kv.val_log,
                       msg.base_v, msg.base_m, msg.val_log)
    p_ack_stale = p_ack & base_stale

    # ---- accept path (§4.5) ------------------------------------------------
    a = in_window & is_acc_msg
    a_seen_higher_prop = a & st_prop & prop_blocks_acc
    # All-aboard epoch conflict (first-accept-wins within version 2): a
    # propose-less accept must not displace a different RMW's propose-less
    # acceptance.
    a_aboard_conflict = (a & (msg.ts_v == 2) & st_acc & (kv.acc_v == 2)
                         & ~same_rmw & ~prop_blocks_acc)
    a_seen_higher_acc = (a & st_acc & prop_blocks_acc) | a_aboard_conflict
    a_ack = a & ~(a_seen_higher_prop | a_seen_higher_acc)

    # ---- commit path (§4.7, §8.6 thin commits) -----------------------------
    c = is_commit
    thin = c & (msg.has_value == 0)
    thin_resolvable = (thin & st_acc & same_rmw & (kv.log_no == msg.log_no))
    c_value = _where(thin, kv.acc_val, msg.value)
    c_base_v = _where(thin, kv.acc_base_v, msg.base_v)
    c_base_m = _where(thin, kv.acc_base_m, msg.base_m)
    c_has_value = c & (~thin | thin_resolvable)
    # log bookkeeping always advances; value install is carstamp-gated
    c_log_adv = c & (msg.log_no > kv.last_log)
    c_install = c_has_value & cs_gt(c_base_v, c_base_m, msg.val_log,
                                    kv.base_v, kv.base_m, kv.val_log)
    c_release = c & (kv.state != int(KVState.INVALID)) \
        & (kv.log_no <= msg.log_no)

    # ---- ABD write lane (§10): install iff carstamp (base, 0) is newer ----
    w_install = is_w & cs_gt(msg.base_v, msg.base_m, 0,
                             kv.base_v, kv.base_m, kv.val_log)

    # ---- ABD read-query lane (§11): three-way carstamp comparison ----------
    rq_low = is_rq & cs_gt(kv.base_v, kv.base_m, kv.val_log,
                           msg.base_v, msg.base_m, msg.val_log)
    rq_eq = (is_rq & (msg.base_v == kv.base_v) & (msg.base_m == kv.base_m)
             & (msg.val_log == kv.val_log))
    rq_high = is_rq & ~rq_low & ~rq_eq

    # ---- new KV state -------------------------------------------------------
    # propose acks (non-fast) grab/overwrite the pair as PROPOSED
    grab = p_ack_fresh | p_ack_prop
    adv_prop_ts = grab | p_seen_lower_acc | p_fast | a_ack
    new_state = kv.state
    new_state = _where(grab, int(KVState.PROPOSED), new_state)
    new_state = _where(a_ack, int(KVState.ACCEPTED), new_state)
    new_state = _where(c_release, int(KVState.INVALID), new_state)

    new_log_no = _where(grab | a_ack, msg.log_no, kv.log_no)
    new_prop_v = _where(adv_prop_ts, msg.ts_v, kv.prop_v)
    new_prop_m = _where(adv_prop_ts, msg.ts_m, kv.prop_m)
    new_acc_v = _where(a_ack, msg.ts_v, kv.acc_v)
    new_acc_m = _where(a_ack, msg.ts_m, kv.acc_m)
    # releasing the slot clears the round TSes (mirrors commit_to_kv; the
    # unresolvable-thin-commit branch releases *without* clearing)
    clr = c_release & c_has_value
    new_prop_v = _where(clr, 0, new_prop_v)
    new_prop_m = _where(clr, -1, new_prop_m)
    new_acc_v = _where(clr, 0, new_acc_v)
    new_acc_m = _where(clr, -1, new_acc_m)
    new_acc_val = _where(a_ack, msg.value, kv.acc_val)
    new_acc_base_v = _where(a_ack, msg.base_v, kv.acc_base_v)
    new_acc_base_m = _where(a_ack, msg.base_m, kv.acc_base_m)
    new_rmw_cnt = _where(grab | a_ack, msg.rmw_cnt, kv.rmw_cnt)
    new_rmw_sess = _where(grab | a_ack, msg.rmw_sess, kv.rmw_sess)

    new_value = _where(c_install, c_value, kv.value)
    new_base_v = _where(c_install, c_base_v, kv.base_v)
    new_base_m = _where(c_install, c_base_m, kv.base_m)
    new_val_log = _where(c_install, msg.val_log, kv.val_log)
    # ABD writes land at carstamp (msg base-TS, 0), regardless of msg.val_log
    new_value = _where(w_install, msg.value, new_value)
    new_base_v = _where(w_install, msg.base_v, new_base_v)
    new_base_m = _where(w_install, msg.base_m, new_base_m)
    new_val_log = _where(w_install, 0, new_val_log)
    new_last_log = _where(c_log_adv, msg.log_no, kv.last_log)
    new_last_rmw_cnt = _where(c_log_adv, msg.rmw_cnt, kv.last_rmw_cnt)
    new_last_rmw_sess = _where(c_log_adv, msg.rmw_sess, kv.last_rmw_sess)

    new_kv = KVTable(
        state=new_state, log_no=new_log_no, last_log=new_last_log,
        prop_v=new_prop_v, prop_m=new_prop_m,
        acc_v=new_acc_v, acc_m=new_acc_m, acc_val=new_acc_val,
        acc_base_v=new_acc_base_v, acc_base_m=new_acc_base_m,
        rmw_cnt=new_rmw_cnt, rmw_sess=new_rmw_sess,
        value=new_value, base_v=new_base_v, base_m=new_base_m,
        val_log=new_val_log,
        last_rmw_cnt=new_last_rmw_cnt, last_rmw_sess=new_last_rmw_sess,
    )

    # ---- replies ------------------------------------------------------------
    op = torch.full_like(msg.kind, -1)
    op = _where(r_rmw_committed, int(Rep.RMW_ID_COMMITTED), op)
    op = _where(committed_no_bcast, int(Rep.RMW_ID_COMMITTED_NO_BCAST), op)
    op = _where(r_log_too_low, int(Rep.LOG_TOO_LOW), op)
    op = _where(r_log_too_high, int(Rep.LOG_TOO_HIGH), op)
    op = _where(p_seen_higher_prop | a_seen_higher_prop,
                int(Rep.SEEN_HIGHER_PROP), op)
    op = _where(p_seen_higher_acc | a_seen_higher_acc,
                int(Rep.SEEN_HIGHER_ACC), op)
    op = _where(p_seen_lower_acc, int(Rep.SEEN_LOWER_ACC), op)
    op = _where(p_ack | a_ack, int(Rep.ACK), op)
    op = _where(p_ack_stale, int(Rep.ACK_BASE_TS_STALE), op)
    op = _where(c | is_wq | is_w, int(Rep.ACK), op)
    op = _where(rq_low, int(Rep.CARSTAMP_TOO_LOW), op)
    op = _where(rq_eq, int(Rep.CARSTAMP_EQUAL), op)
    op = _where(rq_high, int(Rep.CARSTAMP_TOO_HIGH), op)
    op = _where(~active, -1, op)

    rep_kind = torch.full_like(msg.kind, -1)
    for lane_kind, reply_kind in REPLY_KIND.items():
        rep_kind = _where(msg.kind == lane_kind, int(reply_kind), rep_kind)

    seen_higher = (p_seen_higher_prop | p_seen_higher_acc
                   | a_seen_higher_prop | a_seen_higher_acc)
    rep_ts_v = _where(seen_higher, kv.prop_v,
                      _where(p_seen_lower_acc, kv.acc_v, 0))
    rep_ts_m = _where(seen_higher, kv.prop_m,
                      _where(p_seen_lower_acc, kv.acc_m, 0))
    # Carstamp-too-low (§11) ships the same local-value payload group as
    # Log-too-low / Ack-base-TS-stale, plus the last-committed rmw-id/log-no
    # the reader needs for its write-back commit.
    local_val = r_log_too_low | p_ack_stale | rq_low
    rep_log = _where(r_log_too_low | rq_low, kv.last_log, 0)
    rep_rmw_cnt = _where(r_log_too_low | rq_low, kv.last_rmw_cnt,
                         _where(p_seen_lower_acc, kv.rmw_cnt, 0))
    rep_rmw_sess = _where(r_log_too_low | rq_low, kv.last_rmw_sess,
                          _where(p_seen_lower_acc, kv.rmw_sess, -1))
    rep_value = _where(local_val, kv.value,
                       _where(p_seen_lower_acc, kv.acc_val, 0))
    # Write-query replies (§10 round 1) carry the local base-TS alone.
    rep_base_v = _where(local_val | is_wq, kv.base_v,
                        _where(p_seen_lower_acc, kv.acc_base_v, 0))
    rep_base_m = _where(local_val | is_wq, kv.base_m,
                        _where(p_seen_lower_acc, kv.acc_base_m, 0))
    rep_val_log = _where(local_val, kv.val_log,
                         _where(p_seen_lower_acc, msg.log_no, 0))

    replies = ReplyBatch(
        kind=rep_kind, opcode=op, ts_v=rep_ts_v, ts_m=rep_ts_m,
        log_no=rep_log, rmw_cnt=rep_rmw_cnt, rmw_sess=rep_rmw_sess,
        value=rep_value, base_v=rep_base_v, base_m=rep_base_m,
        val_log=rep_val_log,
    )
    register_mask = c & (msg.rmw_sess >= 0)
    return new_kv, replies, register_mask
