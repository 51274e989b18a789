"""Live reconfiguration in the port: view changes through the config
register, epoch fencing and snapshot catch-up, against the reference.

* The reference's storm (3 -> 5 -> 4 members: two joins, a leave, a crash
  and restart, the workload in flight across the changes) gives the same
  completions on the reference's scalar cluster, the port's scalar cluster
  and the port's ``BatchedMachine`` cluster (also with 2-way sharded
  planes), and every checker is green.
* Snapshot files interchange: the reference's ``checkpoint.store`` reads
  what the port's writes and the other way round, whole or split into
  ``@shard`` lane blocks.  The reference stores int64 planes as int32
  (JAX's x64 is off); values are compared with ``np.array_equal``.
* The batched machine's catch-up reads and merges its KV row as whole
  columns; that path gives the same snapshot and the same merged planes as
  the per-key path it replaces.
"""

import collections
import functools
import random

import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.core import sim as ref_sim
from repro.core.node import Machine as RefMachine
from repro.core.node import ProtocolConfig as RefProtocolConfig
from repro.reconfig import catchup as ref_catchup
from repro_torch.checkpoint import store
from repro_torch.coord.registry import PaxosRegistry
from repro_torch.core import checkers, sim
from repro_torch.core.lanes import kv_to_lanes, lanes_to_kv
from repro_torch.core.node import Machine, ProtocolConfig
from repro_torch.core.types import TS, KVState
from repro_torch.reconfig import catchup
from repro_torch.serve.paxos import BatchedMachine
from torch_threads import one_thread  # noqa: F401 (autouse)

CPU_BATCHED = functools.partial(BatchedMachine, device="cpu")


def storm(sim_mod, cfg_cls, machine_cls, seed):
    """The reference's scripted storm (tests/test_reconfig.py ``_storm``)."""
    cfg = cfg_cls(n_machines=3, sessions_per_machine=2, reconfig=True)
    net = sim_mod.NetConfig(seed=seed, drop_prob=0.06, dup_prob=0.05,
                            heavy_tail_prob=0.03, heavy_tail_extra=25.0)
    cl = sim_mod.Cluster(cfg, net, machine_cls=machine_cls)
    sim_mod.workload(cl, n_ops=16, keys=3, seed=seed, rmw_frac=0.5,
                     write_frac=0.3, key_base=1)
    for _ in range(200):
        cl.step()
    cl.join()                                   # 3 -> 4
    cl.join()                                   # 4 -> 5
    sim_mod.workload(cl, n_ops=10, keys=3, seed=seed + 1, key_base=1,
                     mids=cl.active_view.members)
    cl.leave(1)                                 # 5 -> 4
    cl.crash(0)
    sim_mod.workload(cl, n_ops=8, keys=3, seed=seed + 2, key_base=1,
                     mids=[m for m in cl.active_view.members if m != 0])
    cl.restart(0)
    assert cl.run_until_quiet(max_ticks=120_000)
    return cl


@pytest.mark.parametrize("seed", [0, 2])
def test_storm_reference_scalar_port_scalar_port_batched(seed):
    ref = storm(ref_sim, RefProtocolConfig, RefMachine, seed)
    scalar = storm(sim, ProtocolConfig, Machine, seed)
    batched = storm(sim, ProtocolConfig, CPU_BATCHED, seed)
    want = ref_sim.completion_tuples(ref)
    assert want
    assert sim.completion_tuples(scalar) == want
    assert sim.completion_tuples(batched) == want
    for cl in (scalar, batched):
        checkers.check_all(cl)
        assert cl.stats()["view_epoch"] == 3
        assert cl.stats()["sync_installed"] >= 2
    assert batched.engine.telemetry()["row_reloads"] > 0


def test_storm_sharded_batched_equals_scalar():
    scalar = storm(sim, ProtocolConfig, Machine, 0)
    sharded = storm(sim, ProtocolConfig,
                    functools.partial(CPU_BATCHED, shards=2), 0)
    assert sim.completion_tuples(sharded) == sim.completion_tuples(scalar)
    checkers.check_all(sharded)
    assert sharded.engine.telemetry()["shards"] == 2


# ---------------------------------------------------------------------------
# snapshot files across the two packages
# ---------------------------------------------------------------------------

def loaded(sim_mod, cfg_cls, machine_cls, seed=3):
    cl = sim_mod.Cluster(cfg_cls(n_machines=3, sessions_per_machine=2,
                                 reconfig=True),
                         sim_mod.NetConfig(seed=seed),
                         machine_cls=machine_cls)
    sim_mod.workload(cl, n_ops=24, keys=4, seed=seed, rmw_frac=0.6,
                     write_frac=0.3, key_base=1)
    assert cl.run_until_quiet()
    return cl


def assert_same_planes(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("batched", [False, True])
def test_port_snapshot_file_restores_in_reference(tmp_path, batched, shards):
    cl = loaded(sim, ProtocolConfig, CPU_BATCHED if batched else Machine)
    snap = catchup.take_snapshot(cl.machines[0])
    assert any(k.startswith("lane_") for k in snap) == batched
    assert store.save(str(tmp_path), "snap", 1, snap, shards=shards)
    if shards > 1:
        names = np.load(tmp_path / "snap" / "step_00000001" / "shards.npz")
        assert "registry@shard3" in names.files
        assert ("kv_value@shard3" in names.files) == batched
    like = {k: np.zeros_like(v) for k, v in snap.items()}
    back, step = ref_store.restore(str(tmp_path), "snap", like, step=1)
    assert step == 1
    assert_same_planes(snap, back)
    mine, _ = store.restore(str(tmp_path), "snap", like, step=1)
    assert catchup.snapshot_equal(snap, mine)
    assert all(mine[k].dtype == snap[k].dtype for k in snap)


@pytest.mark.parametrize("shards", [1, 4])
def test_reference_snapshot_file_restores_in_port(tmp_path, shards):
    cl = loaded(ref_sim, RefProtocolConfig, RefMachine)
    snap = ref_catchup.take_snapshot(cl.machines[1])
    assert ref_store.save(str(tmp_path), "ref", 2, snap, shards=shards)
    like = {k: np.zeros_like(v) for k, v in snap.items()}
    back = catchup.load_snapshot(str(tmp_path), "ref", like, step=2)
    assert_same_planes(snap, back)
    # a port machine installs the reference's snapshot as the reference's
    # machine does
    port = Machine(7, ProtocolConfig(n_machines=3, sessions_per_machine=2,
                                     reconfig=True),
                   lambda *a: None, lambda: 0.0)
    refm = RefMachine(7, cl.cfg, lambda *a: None, lambda: 0.0)
    catchup.install_snapshot(port, back)
    ref_catchup.install_snapshot(refm, snap)
    assert port.commit_log == refm.commit_log
    assert port.registry.committed == refm.registry.committed
    assert {k: kv_to_lanes(v) for k, v in port.kvs.items()} == \
        {k: kv_to_lanes(v) for k, v in refm.kvs.items()}


NT = collections.namedtuple("NT", "a b")


def test_store_keys_follow_the_reference_tree_paths(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"z": [np.arange(4, dtype=np.int32), (np.float32(2.5), None)],
            "n": NT(a=rng.integers(0, 9, (2, 8)).astype(np.int32),
                    b={"y": np.ones(3, np.float32), "x": np.int32(7)}),
            "o": collections.OrderedDict([("q", np.zeros(2, np.int32)),
                                          ("b", np.ones(2, np.int32))]),
            "none": None}
    assert store._flatten(tree).keys() == ref_store._flatten(tree).keys()
    for k, v in ref_store._flatten(tree).items():
        assert np.array_equal(store._flatten(tree)[k], v)
    torch_tree = {"w": torch.arange(8, dtype=torch.int32).view(2, 4),
                  "n": NT(a=torch.zeros(4), b=None)}
    assert store.save(str(tmp_path), "t", 5, torch_tree, shards=2)
    back, step = store.restore(str(tmp_path), "t", torch_tree, step=5)
    assert step == 5 and isinstance(back["n"], NT) and back["n"].b is None
    assert torch.equal(back["w"], torch_tree["w"])
    assert back["n"].a.dtype == torch.float32
    assert store.save(str(tmp_path), "np", 1, tree, shards=2)
    back, _ = store.restore(str(tmp_path), "np", tree, step=1)
    assert list(back["o"]) == ["q", "b"]
    assert np.array_equal(back["n"].a, tree["n"].a)


def test_store_refuses_a_leaf_of_another_shape(tmp_path):
    assert store.save(str(tmp_path), "s", 1, {"w": np.zeros(4, np.int32)})
    with pytest.raises(ValueError, match="shape"):
        store.restore(str(tmp_path), "s", {"w": np.zeros(5, np.int32)},
                      step=1)
    with pytest.raises(KeyError):
        store.restore(str(tmp_path), "s", {"v": np.zeros(4, np.int32)},
                      step=1)


def test_store_commits_through_the_registry(tmp_path):
    reg = PaxosRegistry(n_machines=3)
    tree = {"w": np.arange(6, dtype=np.int32)}
    assert store.save(str(tmp_path), "run", 3, tree, registry=reg)
    assert not store.save(str(tmp_path), "run", 2, tree, registry=reg)
    back, step = store.restore(str(tmp_path), "run", tree, registry=reg)
    assert step == 3 and np.array_equal(back["w"], tree["w"])


# ---------------------------------------------------------------------------
# whole-row catch-up against the per-key path
# ---------------------------------------------------------------------------

def random_lanes(rng, n):
    """Random KV lanes over small ranges, so that ties in every compared
    field are common."""
    cols = {f: rng.integers(0, 4, n).astype(np.int32)
            for f in kv_to_lanes(lanes_to_kv(
                {f: np.zeros(1, np.int32) for f in catchup._KV_FIELDS}, 0))}
    cols["state"] = rng.integers(0, len(KVState), n).astype(np.int32)
    cols["base_m"] = rng.integers(-1, 3, n).astype(np.int32)
    return cols


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_column_merge_equals_per_pair_merge(seed):
    rng = np.random.default_rng(seed)
    n = 4000
    mine, theirs = random_lanes(rng, n), random_lanes(rng, n)
    got = catchup._merge_kv_columns(mine, theirs)
    for i in range(n):
        want = kv_to_lanes(catchup._merge_kv(lanes_to_kv(mine, i),
                                             lanes_to_kv(theirs, i)))
        assert {f: int(got[f][i]) for f in want} == want, i


def standalone(mid, cfg):
    m = CPU_BATCHED(mid, cfg, lambda *a: None, lambda: 0.0)
    m.kvs.ensure(63)
    return m


@pytest.mark.parametrize("seed", [0, 5])
def test_row_catchup_equals_per_key_catchup(seed):
    cl = loaded(sim, ProtocolConfig, CPU_BATCHED, seed=seed)
    donor = cl.machines[0]
    donor.kvs[2].value += 0           # a checked-out view rides along
    donor.kvs[3].value = 4242         # ... and one the row has not seen
    keys, cols = catchup._kv_columns(donor)
    keys_pk, cols_pk = catchup._kv_columns_per_key(donor)
    assert list(keys) == list(keys_pk)
    assert_same_planes(cols, cols_pk)
    assert cols["value"][3] == 4242
    snap = catchup.take_snapshot(donor)
    # two rejoiners with the same stale state: one merges per key, the
    # other as columns
    rng = np.random.default_rng(seed)
    stale = random_lanes(rng, 64)
    a, b = standalone(1, cl.cfg), standalone(1, cl.cfg)
    for m in (a, b):
        m.kvs._stack.write_lanes(0, np.arange(64), np.stack(
            [stale[f] for f in m.kvs._stack.fields]))
        m.kvs[5].log_no = 77          # checked-out, unflushed views: one
        pair = m.kvs[2]               # the merge keeps, one it replaces
        pair.value, pair.base_ts, pair.val_log = 999_999, TS(-1, -1), 0
    catchup._install_kv_per_key(a, snap)
    catchup._install_kv(b, snap)
    assert_same_planes(a.kvs.row_columns(), b.kvs.row_columns())
    assert b.kvs[2].value != 999_999 and b.kvs[5].log_no == 77
    a.kvs.flush()
    b.kvs.flush()
    assert np.array_equal(a.kvs._stack.host, b.kvs._stack.host)
    catchup.install_snapshot(b, snap)            # idempotent
    assert_same_planes(a.kvs.row_columns(), b.kvs.row_columns())


def test_random_storms_scalar_equals_batched():
    """A few seeded variations of the storm's membership script."""
    for seed in random.Random(7).sample(range(100), 2):
        a = storm(sim, ProtocolConfig, Machine, seed)
        b = storm(sim, ProtocolConfig, CPU_BATCHED, seed)
        assert sim.completion_tuples(a) == sim.completion_tuples(b)
