"""The port's serve path with its lane blocks over the ranks of a process
group, against the reference's own ``"shard"`` mesh, on the CPU.

The reference runs in one fresh subprocess with 4 XLA host devices
(``tests/torch_serve_mesh_ref.py``): its ``BatchedMachine(shards=S)``
places both plane stacks on a 1-D ``"shard"`` mesh of S devices.  The
port's side is S spawned ranks in a gloo group (``tests/torch_ranks.py``,
joined under a 120 s limit), each running the same cluster with
``BatchedMachine(shards=S, device="cpu")``, so each holds its lane block
of each divisible stack and the waves all-gather their compact outputs
(``tests/torch_mesh_ranks.py``).  Workloads: ``torch_mesh_ranks.WORKLOADS``
(tests/test_cluster_engine.py's at 2 and at 4 sessions, and a
crash/restart seed whose KV lanes grow).  Everything is exact: equal
completions, bit-equal planes.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.parallel import sharding as ref_sharding
from repro_torch.core import checkers, sim
from repro_torch.core.lanes import ShardMap
from repro_torch.core.node import ProtocolConfig
from repro_torch.parallel.sharding import MeshShape, named_sharding
from repro_torch.serve.paxos import BatchedMachine, cluster_engine

import torch_mesh_ranks
import torch_ranks
from torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300
SHARDS = (2, 4)
CASES = [(s, w) for s in SHARDS for w in torch_mesh_ranks.WORKLOADS]
IDS = [f"{w}-shards{s}" for s, w in CASES]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_mesh_ref") / "out.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_serve_mesh_ref.py"),
         str(out)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=REF_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{S: [each rank's results]} from one spawned group a shard count."""
    return {s: torch_ranks.run_ranks(
                torch_mesh_ranks.serve_rank, s,
                tmp_path_factory.mktemp(f"serve_ranks{s}"),
                list(torch_mesh_ranks.WORKLOADS))
            for s in SHARDS}


def _ref_stats(ref, s, w):
    return json.loads(str(ref[f"{w}/{s}/stats"]))


@pytest.mark.parametrize("s,w", CASES, ids=IDS)
def test_completions_equal_the_reference_mesh_and_scalar(port, ref, s, w):
    want = str(ref[f"{w}/{s}/completions"])
    assert want == str(ref[f"{w}/scalar/completions"])
    assert len(json.loads(want)) > 0
    for rank, r in enumerate(port[s]):
        res = r[w]
        assert res["mesh"] == (rank, s)
        got = res["completions"]
        if got != want:
            first = next((i for i, (a, b) in enumerate(zip(got, want))
                          if a != b), min(len(got), len(want)))
            pytest.fail(f"rank {rank}: completions differ at char {first}:"
                        f" {got[max(0, first - 40):first + 80]!r} against "
                        f"{want[max(0, first - 40):first + 80]!r}")


@pytest.mark.parametrize("s,w", CASES, ids=IDS)
def test_every_rank_mirror_is_the_reference_planes(port, ref, s, w):
    for rank, r in enumerate(port[s]):
        for tag in ("kv", "tab"):
            np.testing.assert_array_equal(
                r[w][tag].numpy(), ref[f"{w}/{s}/{tag}"],
                err_msg=f"rank {rank} {tag}")
    assert len({r[w]["mirror_digest"] for r in port[s]}) == 1


@pytest.mark.parametrize("s,w", CASES, ids=IDS)
def test_device_block_is_the_ranks_slice_of_the_mirror(port, ref, s, w):
    """The KV stack and a table of sessions S divides hold one lane block
    a rank (the reference's spec (None, None, "shard")); a table S does
    not divide is whole on every rank (its spec (None, None, None))."""
    for rank, r in enumerate(port[s]):
        res = r[w]
        for tag in ("kv", "tab"):
            spec = json.loads(str(ref[f"{w}/{s}/{tag}_spec"]))
            assert res[f"{tag}_spec"] == spec
            host = res[tag]
            n = host.shape[2]
            blk = (ShardMap(s, n).slice_of(rank) if spec[2] == "shard"
                   else slice(0, n))
            assert res[f"{tag}_block"] == (blk.start, blk.stop)
            assert torch.equal(res[f"{tag}_dev"], host[:, :, blk])


@pytest.mark.parametrize("s,w", CASES, ids=IDS)
def test_rank_lane_counters_sum_to_the_reference(port, ref, s, w):
    want = _ref_stats(ref, s, w)
    tels = [r[w]["telemetry"] for r in port[s]]
    tab_split = port[s][0][w]["tab_spec"][2] == "shard"
    for t in tels:
        for k in ("fused_receiver_calls", "fused_receiver_lanes",
                  "fused_issuer_calls", "fused_issuer_lanes",
                  "receiver_shard_lanes", "issuer_shard_lanes"):
            assert t[k] == want[k], k
        assert t["mesh_world"] == s
        # one gather a receiver wave, and one a split issuer wave
        assert t["mesh_gathers"] == t["fused_receiver_calls"] + (
            t["fused_issuer_calls"] if tab_split else 0)
        assert t["mesh_gather_bytes"] > 0
        assert t["rank_paxos_apply_calls"] <= t["fused_receiver_calls"]
    assert sum(t["rank_receiver_lanes"] for t in tels) \
        == want["fused_receiver_lanes"]
    # a rank's receiver lanes are its shard's: the reference's per-shard
    # count at the same S
    assert [t["rank_receiver_lanes"] for t in tels] \
        == want["receiver_shard_lanes"]
    iss = [t["rank_issuer_lanes"] for t in tels]
    if tab_split:
        assert sum(iss) == want["fused_issuer_lanes"]
        assert iss == want["issuer_shard_lanes"]
    else:
        assert iss == [want["fused_issuer_lanes"]] * s
        assert all(t["rank_paxos_propose_calls"]
                   == t["fused_issuer_calls"] for t in tels)


def test_one_gloo_group_a_process_and_a_wrong_world_raises(port):
    for s in SHARDS:
        for r in port[s]:
            # every machine's private engine and the shared one, over three
            # clusters: one dist.new_group call in all
            assert r["new_groups"] == ["gloo"]
            assert str(s) in r["wrong_world"] and str(2 * s) in \
                r["wrong_world"]
            assert r["unsharded_is_none"]


@pytest.mark.parametrize("w", list(torch_mesh_ranks.WORKLOADS))
def test_without_a_group_the_engine_has_no_mesh(ref, w):
    """No process group in this process: one device tensor holds every
    block, no collective runs, and the run is the reference's."""
    cl = torch_mesh_ranks.run_workload(
        sim, ProtocolConfig, w,
        functools.partial(BatchedMachine, shards=4, device="cpu"))
    checkers.check_all(cl)
    eng = cl.engine
    assert eng.mesh is None
    assert cluster_engine._shard_mesh(4) is None
    for tag in ("kv", "tab"):
        st = getattr(eng, tag)
        assert st.device_sharding() is None and not st.lane_sharded
        assert tuple(st.dev.shape) == st.host.shape
        assert st.block == slice(0, st.n_lanes)
        np.testing.assert_array_equal(st.host, st.dev.numpy())
        np.testing.assert_array_equal(st.host, ref[f"{w}/4/{tag}"])
    tel = eng.telemetry()
    assert tel["mesh_world"] == 1 and tel["mesh_gathers"] == 0
    assert tel["rank_receiver_lanes"] == tel["fused_receiver_lanes"]
    assert torch_mesh_ranks.completions_json(sim.completion_tuples(cl)) \
        == str(ref[f"{w}/4/completions"])


def test_named_sharding_matches_the_reference():
    ref_mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("shard",))
    for logical in [("plane_fields", "machines", "lanes"),
                    ("lanes",), ("machines", None)]:
        want = tuple(ref_sharding.named_sharding(ref_mesh, *logical).spec)
        got = named_sharding(MeshShape(("shard",), (1,)), *logical)
        assert got.spec == want
        assert named_sharding(MeshShape(("shard",), (4,)), *logical).spec \
            == want
