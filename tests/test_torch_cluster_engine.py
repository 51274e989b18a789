"""The torch ClusterEngine against the JAX reference's, on the CPU.

* Real fused-step inputs and outputs are recorded from the reference's
  ``BatchedMachine(use_kernel=False)`` cluster on batched-smoke seeds
  (plain, all-aboard, crash/restart), carried across with
  ``stacks_from_numpy``, and the port's fused steps must give the same
  planes.
* The no-donation contract: the same fused step run twice from one
  snapshot gives equal results and leaves its inputs untouched, and two
  lockstep clusters stay bit-identical tick for tick.
* Lane-granular coherence: after every tick the host mirror of each stack
  equals the device stack, so the staged-lanes-only transfers miss
  nothing.
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
from repro_torch.core.node import ProtocolConfig
from repro_torch.core.sim import Cluster, NetConfig, completion_tuples, \
    workload
from repro_torch.serve.paxos import BatchedMachine, cluster_engine, \
    stacks_from_numpy
from torch_threads import one_thread  # noqa: F401 (autouse)

CPU = functools.partial(BatchedMachine, device="cpu")
CFG = dict(n_machines=3, sessions_per_machine=2)


def _faulty(seed, cfg_cls, net_cls, aboard=False):
    cfg = cfg_cls(n_machines=5, sessions_per_machine=2, all_aboard=aboard)
    net = net_cls(seed=seed, drop_prob=0.06, dup_prob=0.05,
                  heavy_tail_prob=0.03, heavy_tail_extra=25.0)
    return cfg, net


def _record_reference(monkeypatch, seed, aboard=False, crash=False):
    recv, iss = [], []
    orig_r, orig_i = ref_ce._fused_receiver_step, ref_ce._fused_issuer_step

    def rec_r(kv, msgreg, **kw):
        ins = (np.array(kv), np.array(msgreg))     # copied before donation
        outs = orig_r(kv, msgreg, **kw)
        recv.append(ins + tuple(np.array(o) for o in outs))
        return outs

    def rec_i(tab, rep, params, **kw):
        ins = (np.array(tab), np.array(rep), np.array(params))
        outs = orig_i(tab, rep, params, **kw)
        iss.append(ins + tuple(np.array(o) for o in outs))
        return outs

    monkeypatch.setattr(ref_ce, "_fused_receiver_step", rec_r)
    monkeypatch.setattr(ref_ce, "_fused_issuer_step", rec_i)
    cfg, net = _faulty(seed, RefProtocolConfig, RefNetConfig, aboard)
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
    return recv, iss


@pytest.mark.parametrize("seed,aboard,crash", [(0, False, False),
                                               (1, True, False),
                                               (2, False, True)])
def test_fused_steps_match_recorded_reference(monkeypatch, seed, aboard,
                                              crash):
    recv, iss = _record_reference(monkeypatch, seed, aboard, crash)
    assert recv and iss
    for i, (kv, msgreg, want_kv, want_rep, want_mask) in enumerate(recv):
        kv_t, _ = stacks_from_numpy(kv, None, device="cpu")
        got_kv, got_rep, got_mask = cluster_engine._fused_receiver_step(
            kv_t, torch.from_numpy(msgreg))
        np.testing.assert_array_equal(got_kv.numpy(), want_kv,
                                      err_msg=f"receiver call {i} kv")
        np.testing.assert_array_equal(got_rep.numpy(), want_rep,
                                      err_msg=f"receiver call {i} replies")
        np.testing.assert_array_equal(got_mask.numpy() != 0, want_mask,
                                      err_msg=f"receiver call {i} mask")
    for i, (tab, rep, params, want_tab, want_act) in enumerate(iss):
        _, tab_t = stacks_from_numpy(None, tab, device="cpu")
        got_tab, got_act = cluster_engine._fused_issuer_step(
            tab_t, torch.from_numpy(rep),
            torch.from_numpy(np.ascontiguousarray(params[:, :, 0])))
        np.testing.assert_array_equal(got_tab.numpy(), want_tab,
                                      err_msg=f"issuer call {i} table")
        np.testing.assert_array_equal(got_act.numpy(), want_act,
                                      err_msg=f"issuer call {i} actions")


def _cluster(seed=11, **kw):
    cl = Cluster(ProtocolConfig(**CFG), NetConfig(seed=seed),
                 machine_cls=functools.partial(CPU, **kw))
    workload(cl, n_ops=24, keys=4, seed=seed, rmw_frac=0.5, write_frac=0.3)
    return cl


def _checkout(engine):
    engine.kv.pull()
    engine.tab.pull()
    return engine.kv.host.copy(), engine.tab.host.copy()


def test_same_tick_twice_from_one_snapshot():
    """Lockstep twins: every tick is the same tick run twice from
    bit-identical state; the planes must stay equal throughout."""
    a, b = _cluster(), _cluster()
    for tick in range(60):
        a.step()
        b.step()
        kv_a, tab_a = _checkout(a.engine)
        kv_b, tab_b = _checkout(b.engine)
        np.testing.assert_array_equal(kv_a, kv_b, err_msg=f"tick {tick} kv")
        np.testing.assert_array_equal(tab_a, tab_b,
                                      err_msg=f"tick {tick} tab")
    assert completion_tuples(a) == completion_tuples(b)
    assert a.engine.stats == b.engine.stats
    assert a.engine.stats["fused_receiver_calls"] > 0


def test_fused_step_twice_from_one_snapshot_leaves_inputs_intact():
    """With no donation the fused steps must not write their inputs: the
    same call twice from one snapshot gives equal outputs and the snapshot
    is unchanged."""
    cl = _cluster()
    for _ in range(15):
        cl.step()
    eng = cl.engine
    kv = eng.kv.push().clone()
    msgreg = torch.from_numpy(np.random.default_rng(0).integers(
        0, 8, (12,) + tuple(kv.shape[1:]), dtype=np.int32))
    tab = eng.tab.push().clone()
    rep = torch.from_numpy(np.random.default_rng(1).integers(
        -1, 12, (13,) + tuple(tab.shape[1:]), dtype=np.int32))
    snap = [t.clone() for t in (kv, msgreg, tab, rep)]
    r1 = cluster_engine._fused_receiver_step(kv, msgreg)
    r2 = cluster_engine._fused_receiver_step(kv, msgreg)
    i1 = cluster_engine._fused_issuer_step(tab, rep, eng._params())
    i2 = cluster_engine._fused_issuer_step(tab, rep, eng._params())
    for x, y in zip(r1 + i1, r2 + i2):
        assert torch.equal(x, y)
    for t, s in zip((kv, msgreg, tab, rep), snap):
        assert torch.equal(t, s)


@pytest.mark.parametrize("shards", (1, 2))
def test_host_mirror_tracks_device_stack_every_tick(shards):
    """Lane-granular transfers are exact: after each tick, a pull and a
    push, the host mirror of both stacks equals the device-resident stack,
    and a wave moves fewer bytes than a whole-stack round trip."""
    cl = _cluster(shards=shards)
    eng = cl.engine
    clean = 0
    for tick in range(50):
        cl.step()
        for stack in (eng.kv, eng.tab):
            what = f"tick {tick} {len(stack.fields)}-plane stack"
            stack.pull()                 # device -> host: staged lanes
            if not (stack.host_dirty or stack._dirty_lanes):
                # no host write pending: a lane the pull missed shows here
                np.testing.assert_array_equal(stack.host, stack.dev.numpy(),
                                              err_msg=what)
                clean += 1
            dev = stack.push()           # host -> device: written lanes
            np.testing.assert_array_equal(stack.host, dev.numpy(),
                                          err_msg=what)
    assert clean > 0
    tel = eng.telemetry()
    assert tel["waves"] > 0
    whole = (eng.kv.host.nbytes * (1 + 12 / 18 + 11 / 18)
             + eng.tab.host.nbytes * (1 + 13 / 65 + 14 / 65))
    assert tel["transfer_bytes"] / tel["waves"] < whole


def test_stacks_from_numpy_copies_and_checks_planes():
    kv = np.arange(18 * 2 * 3, dtype=np.int64).reshape(18, 2, 3)
    tab = np.zeros((65, 2, 4), np.int32)
    kv_t, tab_t = stacks_from_numpy(kv, tab, device="cpu")
    assert kv_t.dtype == tab_t.dtype == torch.int32
    np.testing.assert_array_equal(kv_t.numpy(), kv)
    tab[0, 0, 0] = 7
    assert tab_t[0, 0, 0] == 0                   # a copy, not a view
    with pytest.raises(ValueError, match="65 planes"):
        stacks_from_numpy(None, kv, device="cpu")


def test_engine_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Cluster(ProtocolConfig(**CFG), NetConfig(seed=0),
                machine_cls=BatchedMachine)
