"""The slice as a whole: the port's batched serve path on the CPU.

On the faulty batched-smoke workloads (drops, duplicates, heavy-tail
delays; plain, all-aboard, crash/restart mid-batch, and a 2-way sharded
plane) three clusters must complete the same operations in the same
order, tag for tag, value for value:

* the port's ``Cluster(machine_cls=partial(BatchedMachine, device="cpu"))``
  (the fused engine over the kernels' plain versions),
* the port's scalar ``Machine`` cluster,
* the reference's ``BatchedMachine(use_kernel=False)`` cluster.

``ReqKind`` is an IntEnum and TS / Carstamp / RmwId are NamedTuples, so
completion tuples compare across the two packages as they are.  The
port's safety checkers must be green on its batched cluster.
"""

import functools
import sys

import pytest

from repro.core.node import ProtocolConfig as RefProtocolConfig
from repro.core.sim import Cluster as RefCluster
from repro.core.sim import NetConfig as RefNetConfig
from repro.core.sim import completion_tuples as ref_completion_tuples
from repro.core.sim import workload as ref_workload
from repro.serve.paxos import BatchedMachine as RefBatchedMachine
from repro_torch.core import checkers
from repro_torch.core.node import Machine, ProtocolConfig
from repro_torch.core.sim import Cluster, NetConfig, completion_tuples, \
    workload
from repro_torch.serve.paxos import BatchedMachine

# seed -> (all_aboard, crash/restart mid-batch, shards)
CASES = {0: (False, False, 1), 1: (True, False, 1), 2: (False, True, 1),
         3: (False, False, 2)}


def run(seed, machine_cls, cluster_cls=Cluster, cfg_cls=ProtocolConfig,
        net_cls=NetConfig, workload_fn=workload):
    aboard, crash, _ = CASES[seed]
    cfg = cfg_cls(n_machines=5, sessions_per_machine=2, all_aboard=aboard)
    net = net_cls(seed=seed, drop_prob=0.06, dup_prob=0.05,
                  heavy_tail_prob=0.03, heavy_tail_extra=25.0)
    cl = cluster_cls(cfg, net, machine_cls=machine_cls)
    workload_fn(cl, n_ops=18, keys=3, seed=seed, rmw_frac=0.45,
                write_frac=0.3)
    if crash:
        cl.step(8)
        # deliver due traffic first so the crash lands with messages in
        # flight ("crash mid-batch": the inbox dies with the machine)
        cl.network.deliver_due(cl.network.now + 1.0, cl.machines)
        assert any(m.inbox for m in cl.machines)
        cl.crash(4)
        cl.step(6)
        cl.restart(4)
    assert cl.run_until_quiet(max_ticks=120_000)
    return cl


@pytest.mark.parametrize("seed", sorted(CASES))
def test_batched_cluster_identical_to_scalar_and_reference(seed):
    shards = CASES[seed][2]
    batched = run(seed, functools.partial(BatchedMachine, device="cpu",
                                          shards=shards))
    scalar = run(seed, Machine)
    ref_kw = {"shards": shards} if shards > 1 else {}
    reference = run(seed, functools.partial(RefBatchedMachine,
                                            use_kernel=False, **ref_kw),
                    RefCluster, RefProtocolConfig, RefNetConfig,
                    ref_workload)
    got = completion_tuples(batched)
    assert got, "the workload completed nothing"
    assert got == completion_tuples(scalar)
    assert got == ref_completion_tuples(reference)
    checkers.check_all(batched)
    tel = batched.engine.telemetry()
    assert tel["fused_receiver_calls"] > 0 and tel["fused_issuer_calls"] > 0
    assert tel["shards"] == shards
    assert batched.engine.kv.dev.device.type == "cpu"


def reconfig_run(machine_cls, sim_mod=None, cfg_cls=ProtocolConfig):
    """Join a replica under load, retire another, load the new view."""
    sim_mod = sim_mod or sys.modules[Cluster.__module__]
    cl = sim_mod.Cluster(cfg_cls(n_machines=3, sessions_per_machine=2,
                                 reconfig=True),
                         sim_mod.NetConfig(seed=4, drop_prob=0.06,
                                           dup_prob=0.05),
                         machine_cls=machine_cls)
    sim_mod.workload(cl, n_ops=12, keys=3, seed=1, key_base=1)
    cl.step(60)
    assert cl.join() == 3
    cl.leave(0)
    sim_mod.workload(cl, n_ops=12, keys=3, seed=2, key_base=1,
                     mids=cl.active_view.members)
    assert cl.run_until_quiet(max_ticks=120_000)
    return cl


def test_batched_cluster_with_reconfig_identical_to_scalar_and_reference():
    import repro.core.sim as ref_sim

    batched = reconfig_run(functools.partial(BatchedMachine, device="cpu"))
    scalar = reconfig_run(Machine)
    reference = reconfig_run(functools.partial(RefBatchedMachine,
                                               use_kernel=False),
                             ref_sim, RefProtocolConfig)
    got = completion_tuples(batched)
    assert got == completion_tuples(scalar)
    assert got == ref_completion_tuples(reference)
    checkers.check_all(batched)
    assert batched.active_view.members == (1, 2, 3)
    assert batched.machines[0].retired
    assert batched.machines[3].stats.get("sync_installed", 0) >= 1
    assert batched.engine.telemetry()["row_reloads"] > 0
