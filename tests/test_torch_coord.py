"""The port's ``PaxosRegistry`` against the reference's, and what the port
does where live reconfiguration is asked for (not ported yet)."""

import pytest

from repro.coord.registry import PaxosRegistry as RefRegistry
from repro.core.sim import NetConfig as RefNetConfig
from repro_torch.coord.registry import PaxosRegistry
from repro_torch.core.node import ProtocolConfig
from repro_torch.core.sim import Cluster, NetConfig


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


def test_reconfiguration_raises_not_implemented():
    reg = PaxosRegistry(n_machines=3, reconfig=True)
    assert reg.cas("route/1", 0, 5) == (True, 0)     # serving still works
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        reg.add_replica()
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        reg.remove_replica(2)
    cl = Cluster(ProtocolConfig(n_machines=3, reconfig=True),
                 NetConfig(seed=0))
    with pytest.raises(NotImplementedError, match="reconfig"):
        cl.machines[0]._serve_sync(1)
