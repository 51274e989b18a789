"""The port's ``PaxosRegistry`` against the reference's, serving and
growing or shrinking its membership (live reconfiguration)."""

import pytest

from repro.coord.registry import PaxosRegistry as RefRegistry
from repro.core.sim import NetConfig as RefNetConfig
from repro_torch.coord.registry import PaxosRegistry
from repro_torch.core import checkers
from repro_torch.core.node import ProtocolConfig
from repro_torch.core.sim import Cluster, NetConfig
from torch_threads import one_thread  # noqa: F401 (autouse)


def _script(reg):
    """A fixed mix of coordination ops; returns every result and the
    machines' completion counts."""
    out = [reg.cas("route/7", 0, 1), reg.cas("route/7", 0, 2),
           reg.faa("data/run/cursor"), reg.faa("data/run/cursor", 5),
           reg.swap("lock", 9), reg.fetch("lock")]
    reg.write("epoch", 41)
    out.append(reg.read("epoch"))
    out.append(reg.commit_checkpoint("run", 100))
    out.append(reg.commit_checkpoint("run", 50))
    out.append(reg.latest_checkpoint("run"))
    out.append(reg.join_membership("run", 3))
    out.append(reg.claim_backup("run", 4, 2))
    out.append(reg.claim_backup("run", 4, 1))
    reg.crash(1)
    out.append(reg.faa("data/run/cursor"))
    reg.restart(1)
    out.append(reg.fetch("route/7"))
    return out, [len(m.completions) for m in reg.cluster.machines]


@pytest.mark.parametrize("aboard,seed", [(True, 0), (False, 3)])
def test_registry_matches_reference(aboard, seed):
    net = dict(seed=seed, drop_prob=0.05, dup_prob=0.05)
    got = _script(PaxosRegistry(n_machines=5, all_aboard=aboard,
                                net=NetConfig(**net)))
    want = _script(RefRegistry(n_machines=5, all_aboard=aboard,
                               net=RefNetConfig(**net)))
    assert got == want


def _membership_script(reg):
    """Serve, grow by one replica, shrink by another, serve again."""
    out = [reg.cas("route/1", 0, 5), reg.faa("ctr")]
    out.append(reg.add_replica())
    out.append(reg.cluster.active_view.members)
    out += [reg.faa("ctr"), reg.swap("lock", 3)]
    reg.remove_replica(1)
    out.append(reg.cluster.active_view.members)
    out.append(reg.cluster.machines[1].retired)
    out += [reg.fetch("route/1"), reg.faa("ctr"), reg.fetch("lock")]
    return out, [len(m.completions) for m in reg.cluster.machines]


@pytest.mark.parametrize("seed", [0, 5])
def test_add_and_remove_replica_match_reference(seed):
    net = dict(seed=seed, drop_prob=0.05, dup_prob=0.05)
    reg = PaxosRegistry(n_machines=3, reconfig=True, net=NetConfig(**net))
    got = _membership_script(reg)
    want = _membership_script(RefRegistry(n_machines=3, reconfig=True,
                                          net=RefNetConfig(**net)))
    assert got == want
    assert got[0][2] == 3 and got[0][3] == (0, 1, 2, 3)
    assert got[0][6] == (0, 2, 3) and got[0][7] and got[0][9] == 2
    checkers.check_all(reg.cluster)


def test_machine_serves_a_snapshot_to_a_joiner():
    cl = Cluster(ProtocolConfig(n_machines=3, reconfig=True),
                 NetConfig(seed=0))
    cl.rmw(0, 0, key=1)
    assert cl.run_until_quiet()
    cl.machines[0]._serve_sync(2)
    assert cl.machines[0].stats["syncs_served"] == 1
    assert cl.network.pending() == 1
