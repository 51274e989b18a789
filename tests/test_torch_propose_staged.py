"""The staged ``paxos_propose`` entry (a wave's lanes only, in place) on
the CPU, against the JAX reference's whole-stack issuer calls.

* The reference's recorded ``_fused_issuer_step`` calls (batched-smoke
  seeds: plain, all-aboard, crash/restart) are replayed with exactly the
  lanes whose reply is active (``kind >= 0``) staged: the whole table after
  the in-place call must equal the reference's, and the compact output
  its actions and changed planes at the staged lanes, bit for bit.
* Idle lanes keep their table at every staged count, staging every lane
  reproduces the whole-stack plain version, and the lane contract (one
  entry a lane, coordinates in range) is refused before anything runs.
* The engine's issuer wave goes through the staged entry only and leaves
  the table's host mirror equal to the device stack with nothing to pull.
"""

import functools

import numpy as np
import pytest
import torch

from repro.core.node import ProtocolConfig as RefProtocolConfig
from repro.core.sim import Cluster as RefCluster
from repro.core.sim import NetConfig as RefNetConfig
from repro.core.sim import workload as ref_workload
from repro.serve.paxos import BatchedMachine as RefBatchedMachine
from repro.serve.paxos import cluster_engine as ref_ce
from repro_torch.core import proposer_vector as pv
from repro_torch.core.node import Machine, ProtocolConfig
from repro_torch.core.sim import Cluster, NetConfig, completion_tuples, \
    workload
from repro_torch.kernels.paxos_propose import ops
from repro_torch.serve.paxos import BatchedMachine, cluster_engine
from torch_threads import one_thread  # noqa: F401 (autouse)

N_TAB = len(pv.ProposerTable._fields)


def _record_reference_issuer(monkeypatch, seed, aboard, crash):
    """The reference cluster's fused issuer calls on a faulty
    batched-smoke run: (tab, rep, params, want_tab, want_act) each."""
    calls = []
    orig = ref_ce._fused_issuer_step

    def rec(tab, rep, params, **kw):
        ins = (np.array(tab), np.array(rep), np.array(params))
        outs = orig(tab, rep, params, **kw)
        calls.append(ins + tuple(np.array(o) for o in outs))
        return outs

    monkeypatch.setattr(ref_ce, "_fused_issuer_step", rec)
    cfg = RefProtocolConfig(n_machines=5, sessions_per_machine=2,
                            all_aboard=aboard)
    net = RefNetConfig(seed=seed, drop_prob=0.06, dup_prob=0.05,
                       heavy_tail_prob=0.03, heavy_tail_extra=25.0)
    cl = RefCluster(cfg, net, machine_cls=RefBatchedMachine)
    ref_workload(cl, n_ops=18, keys=3, seed=seed, rmw_frac=0.45,
                 write_frac=0.3)
    if crash:
        cl.step(8)
        cl.network.deliver_due(cl.network.now + 1.0, cl.machines)
        cl.crash(4)
        cl.step(6)
        cl.restart(4)
    assert cl.run_until_quiet(max_ticks=120_000)
    return calls


def _staged(mi, lane, rep_cols):
    return torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [np.stack([mi, lane]).astype(np.int32), rep_cols]), np.int32))


@pytest.mark.parametrize("seed,aboard,crash", [(0, False, False),
                                               (1, True, False),
                                               (2, False, True)])
def test_staged_plain_matches_recorded_reference(monkeypatch, seed, aboard,
                                                 crash):
    calls = _record_reference_issuer(monkeypatch, seed, aboard, crash)
    assert calls
    staged_lanes = 0
    for i, (tab, rep, params, want_tab, want_act) in enumerate(calls):
        # the design rests on it: an idle lane's table is unchanged
        idle = rep[0] < 0
        np.testing.assert_array_equal(want_tab[:, idle], tab[:, idle],
                                      err_msg=f"issuer call {i} idle lanes")
        mi, lane = np.nonzero(~idle)
        staged = _staged(mi, lane, rep[:, mi, lane])
        m, s = tab.shape[1:]
        got_tab = torch.from_numpy(tab.astype(np.int32).reshape(N_TAB, -1))
        out = ops.paxos_propose_staged_plain(
            got_tab, staged,
            torch.from_numpy(np.ascontiguousarray(params[:, :, 0])), s)
        np.testing.assert_array_equal(got_tab.numpy().reshape(tab.shape),
                                      want_tab,
                                      err_msg=f"issuer call {i} table")
        np.testing.assert_array_equal(out[:ops.N_ACT].numpy(),
                                      want_act[:, mi, lane],
                                      err_msg=f"issuer call {i} actions")
        np.testing.assert_array_equal(
            out[ops.N_ACT:].numpy(),
            want_tab[ops.CHANGED_ROWS][:, mi, lane],
            err_msg=f"issuer call {i} changed planes")
        staged_lanes += len(mi)
    assert staged_lanes > 0


def _random_inputs(rng, m, s):
    """Tables, replies (a third idle) and mixed per-row parameters, in the
    ranges that reach every decision."""
    n = m * s
    tab = rng.integers(-1, 5, (N_TAB, n), dtype=np.int32)
    idx = {f: i for i, f in enumerate(pv.ProposerTable._fields)}
    tab[idx["phase"]] = rng.integers(0, 5, n)
    tab[idx["abd_phase"]] = rng.choice(np.array([0, 1, 2, 3, 4, 9]), n)
    for f in ("lid", "abd_lid"):
        tab[idx[f]] = rng.integers(0, 2, n)
    for f in ("rep_bits", "ack_bits", "abd_rep_bits", "abd_ack_bits",
              "abd_store_bits"):
        tab[idx[f]] = rng.integers(0, 256, n)
    rep = rng.integers(-1, 6, (ops.N_IREP, n), dtype=np.int32)
    rep[0] = rng.choice(np.array([-1, -1, -1, 3, 4, 5, 7, 9, 11]), n)
    rep[1] = rng.integers(0, 12, n)
    rep[2] = rng.integers(-1, 9, n)
    rep[3] = rng.integers(0, 2, n)
    n_machines = rng.choice(np.array([3, 5, 7]), m)
    majority = n_machines // 2 + 1
    params = np.stack([n_machines, majority,
                       np.where(rng.random(m) < 0.5, 1, majority - 1),
                       rng.integers(1, 5, m)]).astype(np.int32)
    return (torch.from_numpy(tab), torch.from_numpy(rep),
            torch.from_numpy(params))


def _stage(rng, rep, m, s, n_staged):
    idx = rng.permutation(m * s)[:n_staged]
    return idx, _staged(idx // s, idx % s, rep[:, idx].numpy())


@pytest.mark.parametrize("n_staged", (0, 1, 7, 65, 200))
def test_idle_lanes_untouched(n_staged):
    rng = np.random.default_rng(n_staged)
    m, s = 5, 40
    tab, rep, params = _random_inputs(rng, m, s)
    idx, staged = _stage(rng, rep, m, s, n_staged)
    got = tab.clone()
    out = ops.paxos_propose_staged(got, staged, params, s)
    assert out.shape == (ops.N_OUT, n_staged)
    unstaged = np.setdiff1d(np.arange(m * s), idx)
    assert torch.equal(got[:, unstaged], tab[:, unstaged])
    # and the staged lanes moved only the changed planes
    keep = [pv.ProposerTable._fields.index(f)
            for f in ops.PASS_THROUGH_FIELDS]
    assert torch.equal(got[keep], tab[keep])


@pytest.mark.parametrize("m,s", [(5, 40), (3, 67), (301, 1)])
def test_staging_every_lane_reproduces_the_whole_stack(m, s):
    rng = np.random.default_rng(m * s)
    tab, rep, params = _random_inputs(rng, m, s)
    idx, staged = _stage(rng, rep, m, s, m * s)
    assert torch.equal(ops.dense_replies(staged, m, s), rep)
    want_tab, want_act = ops.paxos_propose_plain(tab, rep, params, s)
    got = tab.clone()
    out = ops.paxos_propose_staged(got, staged, params, s)
    assert torch.equal(got, want_tab)
    assert torch.equal(out[:ops.N_ACT], want_act[:, idx])
    assert torch.equal(out[ops.N_ACT:], want_tab[ops.CHANGED_ROWS][:, idx])


@pytest.mark.parametrize("what,mi,lane", [
    ("twice", [1, 0, 1], [3, 2, 3]),
    ("outside", [0, 2], [0, 1]),          # row past M
    ("outside", [0, -1], [0, 1]),         # negative row
    ("outside", [0, 1], [4, 1]),          # lane past S
    ("outside", [0, 1], [0, -2]),         # negative lane
    ("twice", list(range(2)) * 40, [j % 4 for j in range(80)]),  # L > 64
])
def test_lane_contract_is_refused_before_the_step(what, mi, lane):
    rng = np.random.default_rng(3)
    tab, rep, params = _random_inputs(rng, 2, 4)
    n = len(mi)
    staged = _staged(np.array(mi), np.array(lane),
                     rep[:, np.arange(n) % 8].numpy())
    got = tab.clone()
    with pytest.raises(ValueError, match=what):
        ops.paxos_propose_staged(got, staged, params, 4)
    assert torch.equal(got, tab)
    with pytest.raises(ValueError, match=what):
        ops.check_coords(staged[:2].numpy(), 2, 4)


def test_wrapper_refuses_bad_buffers():
    rng = np.random.default_rng(4)
    tab, rep, params = _random_inputs(rng, 2, 4)
    _, staged = _stage(rng, rep, 2, 4, 3)
    with pytest.raises(ValueError, match="int32"):
        ops.paxos_propose_staged(tab.long(), staged, params, 4)
    with pytest.raises(ValueError, match="shape"):
        ops.paxos_propose_staged(tab, staged[1:].contiguous(), params, 4)
    with pytest.raises(ValueError, match="shape"):
        ops.paxos_propose_staged(tab, staged, params, 4,
                                 out=torch.empty((ops.N_OUT, 2),
                                                 dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ops.paxos_propose_staged(tab, staged.t().contiguous().t(), params, 4)
    with pytest.raises(ValueError, match="shape"):
        ops.paxos_propose_staged(tab, staged, params, 3)
    with pytest.raises(ValueError, match="host copy"):
        ops.paxos_propose_staged(tab, staged, params, 4,
                                 coords=staged[:2, :2].numpy())


def test_pass_through_planes_are_never_changed():
    """The kernel writes back only CHANGED_FIELDS: proposer_core must leave
    the other 21 planes alone on every lane, active or idle."""
    assert set(ops.CHANGED_FIELDS) | set(ops.PASS_THROUGH_FIELDS) \
        == set(pv.ProposerTable._fields)
    assert len(ops.CHANGED_FIELDS) == 44
    assert len(ops.PASS_THROUGH_FIELDS) == 21
    rng = np.random.default_rng(5)
    for _ in range(4):
        tab, rep, params = _random_inputs(rng, 4, 250)
        new_tab, _ = ops.paxos_propose_plain(tab, rep, params, 250)
        for f in ops.PASS_THROUGH_FIELDS:
            k = pv.ProposerTable._fields.index(f)
            assert torch.equal(new_tab[k], tab[k]), f


def _cluster(seed, machine_cls, **kw):
    cl = Cluster(ProtocolConfig(n_machines=3, sessions_per_machine=2),
                 NetConfig(seed=seed), machine_cls=machine_cls)
    workload(cl, n_ops=30, keys=4, seed=seed, rmw_frac=0.5, write_frac=0.3)
    assert cl.run_until_quiet(max_ticks=120_000)
    return cl


@pytest.mark.parametrize("shards", (1, 2))
def test_issuer_wave_is_staged_in_place(monkeypatch, shards):
    """Every issuer wave is one staged call (no whole-stack step), waits
    once, and leaves nothing for the table's pull to fetch."""
    def whole_stack(*a, **kw):
        raise AssertionError("the whole-stack issuer step ran")

    monkeypatch.setattr(cluster_engine, "_fused_issuer_step", whole_stack)
    monkeypatch.setattr(cluster_engine, "paxos_propose", whole_stack)
    calls = []
    staged = cluster_engine.paxos_propose_staged
    monkeypatch.setattr(cluster_engine, "paxos_propose_staged",
                        lambda *a, **kw: calls.append(a[1].shape[1])
                        or staged(*a, **kw))
    batched = _cluster(13, functools.partial(BatchedMachine, device="cpu",
                                             shards=shards))
    assert completion_tuples(batched) == completion_tuples(
        _cluster(13, Machine))
    eng = batched.engine
    st = eng.stats
    assert st["fused_issuer_calls"] == len(calls) > 0
    assert st["fused_issuer_lanes"] == sum(calls)
    assert st["issuer_wave_syncs"] == st["fused_issuer_calls"]
    assert eng.tab.d2h_bytes == 0 and not eng.tab.dev_fresh
    np.testing.assert_array_equal(eng.tab.host, eng.tab.push().numpy())


def test_absorb_in_place_refuses_racing_host_writes():
    stack = cluster_engine.PlaneStack(
        pv.ProposerTable._fields, pv.TABLE_DEFAULTS, 2, 4, device="cpu")
    stack.push()
    stack.write_lanes(1, np.array([2]),
                      np.zeros((N_TAB, 1), np.int32))
    with pytest.raises(RuntimeError, match="raced"):
        stack.absorb_in_place(ops.CHANGED_ROWS, np.array([0]),
                              np.array([0]),
                              np.zeros((ops.N_CHG, 1), np.int32))
