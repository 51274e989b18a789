"""Issuer engine: the port's proposer_core / paxos_propose / issuer_step
against the JAX reference's, plane for plane, on the CPU.

Random ProposerTables and steered replies are drawn with numpy so that
lids and phases line up often enough to reach every decision (idle lanes
with ``kind = -1`` mixed in), and the same planes go through
``repro.core.proposer_vector.proposer_core`` /
``repro.kernels.paxos_propose.ops.issuer_step(use_kernel=False)`` and
their ``repro_torch`` counterparts, chained over several steps so the
folds reach deep tally states.  Tolerance 0: every plane equal, int32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import proposer_vector as ref_pv
from repro.kernels.paxos_propose import ops as ref_ops
from repro_torch.core import proposer_vector as pv
from repro_torch.core.proposer import Decision
from repro_torch.kernels.paxos_propose import ops
from torch_threads import one_thread  # noqa: F401 (autouse)

INT32_MAX = np.iinfo(np.int32).max

# reply kinds that steer (plus -1 idle and a receiver-side kind, inert)
REPLY_KINDS = np.array([-1, -1, 0, 3, 4, 5, 7, 9, 11], np.int32)
ABD_PHASES = np.array([0, 1, 2, 3, 4, 9], np.int32)


def random_table(rng, n):
    t = {}
    for f, default in pv._TABLE_FIELDS:
        t[f] = rng.integers(-1, 5, n, dtype=np.int32)
    t["phase"] = rng.integers(0, 5, n, dtype=np.int32)
    t["abd_phase"] = rng.choice(ABD_PHASES, n)
    for f in ("lid", "abd_lid"):
        t[f] = rng.integers(0, 2, n, dtype=np.int32)
    for f in ("rep_bits", "ack_bits", "abd_rep_bits", "abd_ack_bits",
              "abd_store_bits"):
        t[f] = rng.integers(0, 256, n, dtype=np.int32) \
            * (rng.random(n) < 0.5)
    for f in ("aboard", "helping", "rmw_flag", "rmw_nb_flag", "lth_flag",
              "sh_has", "ltl_has", "la_has", "fr_has"):
        t[f] = (rng.random(n) < 0.25).astype(np.int32)
    t["lth_counter"] = rng.choice(
        np.array([0, 1, 2, 3, INT32_MAX], np.int32), n)
    return np.stack([t[f] for f in pv.ProposerTable._fields])


def random_replies(rng, n):
    r = {f: rng.integers(-1, 6, n, dtype=np.int32)
         for f in pv.IssuerReplyBatch._fields}
    r["kind"] = rng.choice(REPLY_KINDS, n)
    r["opcode"] = rng.integers(0, 12, n, dtype=np.int32)
    r["src"] = rng.integers(-1, 9, n, dtype=np.int32)
    r["lid"] = rng.integers(0, 2, n, dtype=np.int32)
    return np.stack([r[f] for f in pv.IssuerReplyBatch._fields])


def random_params(rng, n):
    n_machines = rng.choice(np.array([3, 5, 7], np.int32), n)
    majority = n_machines // 2 + 1
    commit_need = np.where(rng.random(n) < 0.5, 1, majority - 1)
    lth = rng.integers(1, 5, n, dtype=np.int32)
    return np.stack([n_machines, majority, commit_need, lth]).astype(
        np.int32)


def _assert_equal(names, got, want, what):
    for f, a, b in zip(names, got, want):
        assert a.dtype == torch.int32, f"{what} {f} dtype {a.dtype}"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{what} field {f}")


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 64), (2, 4000)])
def test_proposer_core_matches_reference_per_lane_params(seed, n):
    rng = np.random.default_rng(seed)
    tab = random_table(rng, n)
    decisions = set()
    for _ in range(6):
        rep = random_replies(rng, n)
        par = random_params(rng, n)
        want_t, want_a = ref_pv.proposer_core(
            ref_pv.ProposerTable(*jnp.asarray(tab)),
            ref_pv.IssuerReplyBatch(*jnp.asarray(rep)), *jnp.asarray(par))
        got_t, got_a = pv.proposer_core(
            pv.ProposerTable.from_numpy(tab, device="cpu"),
            pv.IssuerReplyBatch.from_numpy(rep, device="cpu"),
            *torch.from_numpy(par))
        _assert_equal(pv.ProposerTable._fields, got_t, want_t, "table")
        _assert_equal(pv.ActionBatch._fields, got_a, want_a, "action")
        decisions.update(got_a.decision.tolist())
        tab = np.stack([np.asarray(p) for p in want_t])
    if n >= 4000:
        # the draw reaches most of the decision cascade
        assert len(decisions) >= 12, sorted(decisions)


@pytest.mark.parametrize("seed", [3, 4])
def test_proposer_step_with_int_quorums_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 2000
    tab, rep = random_table(rng, n), random_replies(rng, n)
    kw = dict(n_machines=5, majority=3, commit_need=2,
              log_too_high_threshold=3)
    want_t, want_a = ref_pv.proposer_step(
        ref_pv.ProposerTable(*jnp.asarray(tab)),
        ref_pv.IssuerReplyBatch(*jnp.asarray(rep)), **kw)
    got_t, got_a = pv.proposer_step(
        pv.ProposerTable.from_numpy(tab, device="cpu"),
        pv.IssuerReplyBatch.from_numpy(rep, device="cpu"), **kw)
    _assert_equal(pv.ProposerTable._fields, got_t, want_t, "table")
    _assert_equal(pv.ActionBatch._fields, got_a, want_a, "action")


@pytest.mark.parametrize("seed,per_lane", [(5, False), (6, True)])
def test_issuer_step_matches_reference(seed, per_lane):
    rng = np.random.default_rng(seed)
    n = 1000
    tab, rep = random_table(rng, n), random_replies(rng, n)
    if per_lane:
        p = random_params(rng, n)
        ref_kw = dict(zip(("n_machines", "majority", "commit_need",
                           "log_too_high_threshold"), jnp.asarray(p)))
        kw = dict(zip(ref_kw, torch.from_numpy(p)))
    else:
        kw = ref_kw = dict(n_machines=3, majority=2, commit_need=1,
                           log_too_high_threshold=2)
    want_t, want_a = ref_ops.issuer_step(
        ref_pv.ProposerTable(*jnp.asarray(tab)),
        ref_pv.IssuerReplyBatch(*jnp.asarray(rep)), use_kernel=False,
        **ref_kw)
    got_t, got_a = ops.issuer_step(
        pv.ProposerTable.from_numpy(tab, device="cpu"),
        pv.IssuerReplyBatch.from_numpy(rep, device="cpu"), **kw)
    _assert_equal(pv.ProposerTable._fields, got_t, want_t, "table")
    _assert_equal(pv.ActionBatch._fields, got_a, want_a, "action")


def test_fused_layout_per_machine_params_matches_reference():
    """paxos_propose over packed (F, M·S) lanes with a (4, M) parameter
    block equals the reference's fused jnp path: proposer_core over
    (F, M, S) planes with (4, M, 1) parameters."""
    rng = np.random.default_rng(7)
    m, s = 5, 40
    tab = random_table(rng, m * s)
    rep = random_replies(rng, m * s)
    par = random_params(rng, m)
    want_t, want_a = ref_pv.proposer_core(
        ref_pv.ProposerTable(*jnp.asarray(tab.reshape(-1, m, s))),
        ref_pv.IssuerReplyBatch(*jnp.asarray(rep.reshape(-1, m, s))),
        *jnp.asarray(par[:, :, None]))
    before = ops.paxos_propose.launches
    got_t, got_a = ops.paxos_propose(torch.from_numpy(tab),
                                     torch.from_numpy(rep),
                                     torch.from_numpy(par), s)
    assert ops.paxos_propose.launches == before   # no kernel on the CPU
    np.testing.assert_array_equal(
        got_t.numpy(), np.stack([np.asarray(p) for p in want_t]).reshape(
            -1, m * s))
    np.testing.assert_array_equal(
        got_a.numpy(), np.stack([np.asarray(p) for p in want_a]).reshape(
            -1, m * s))


def test_lth_counter_wraps_like_int32():
    """``lth_counter + 1`` at INT32_MAX wraps negative in jnp int32, so the
    §8.7 threshold test fails (RETRY_LOG_TOO_HIGH, not RECOMMIT); the port
    and the kernel (through uint32) must agree."""
    n = 4
    tab = np.stack([np.full(n, v, np.int32) for _, v in pv._TABLE_FIELDS])
    f = {name: i for i, name in enumerate(pv.ProposerTable._fields)}
    tab[f["phase"]] = 1                  # PROPOSED
    tab[f["lth_flag"]] = 1
    tab[f["rep_bits"]] = 0b11            # two repliers already
    tab[f["lth_counter"]] = [0, 5, INT32_MAX, INT32_MAX - 1]
    rep = np.zeros((len(pv.IssuerReplyBatch._fields), n), np.int32)
    rep[0] = 3                           # PROP_REPLY
    rep[1] = 5                           # LOG_TOO_HIGH
    rep[2] = 2                           # third source -> majority of 5
    want = ref_pv.proposer_step(
        ref_pv.ProposerTable(*jnp.asarray(tab)),
        ref_pv.IssuerReplyBatch(*jnp.asarray(rep)), n_machines=5,
        majority=3, commit_need=2, log_too_high_threshold=3)
    got = pv.proposer_step(
        pv.ProposerTable.from_numpy(tab, device="cpu"),
        pv.IssuerReplyBatch.from_numpy(rep, device="cpu"), n_machines=5,
        majority=3, commit_need=2, log_too_high_threshold=3)
    np.testing.assert_array_equal(got[1].decision.numpy(),
                                  np.asarray(want[1].decision))
    assert got[1].decision.tolist() == [
        Decision.RETRY_LOG_TOO_HIGH, Decision.RECOMMIT,
        Decision.RETRY_LOG_TOO_HIGH, Decision.RECOMMIT]


def test_idle_lanes_untouched():
    rng = np.random.default_rng(8)
    n = 512
    tab = random_table(rng, n)
    got_t, got_a = pv.proposer_step(
        pv.ProposerTable.from_numpy(tab, device="cpu"),
        pv.IssuerReplyBatch.idle(n, device="cpu"), n_machines=5,
        majority=3, commit_need=2, log_too_high_threshold=3)
    np.testing.assert_array_equal(torch.stack(got_t).numpy(), tab)
    assert (got_a.decision.numpy() == int(Decision.WAIT)).all()
    assert (got_a.bcast_kind.numpy() == -1).all()


def test_fresh_table_matches_reference():
    _assert_equal(pv.ProposerTable._fields,
                  pv.ProposerTable.fresh(3, device="cpu"),
                  ref_pv.ProposerTable.fresh(3), "fresh")
