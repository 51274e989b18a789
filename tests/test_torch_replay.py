"""The port's differential replay (``repro_torch.core.replay``) on the CPU:
receiver, fused, sharded and bucketing.

Each test of ``tests/test_replay.py`` has a counterpart here on the same
seeds and parameters, run with ``device="cpu"`` (the kernels' plain
versions).  Where the reference test ran one replay, the port's stats dict
must **equal** the reference's on the same seed: the reference side passes
``use_kernel=False``, the jnp oracle (its Pallas path does not trace on
the installed JAX).  Both packages' simulators produce the same schedule
on a seed, so equal stats mean the same messages, batches, waves and
kinds were replayed, and each replay held its engine to the scalar
handlers along the way.

Beyond the counterparts: one case at 4096 keys x 64 sessions, which
stages about a hundred lanes a wave through the resident message stack
and compares the final planes on whole stacks; and mutation cases, where
a wrapper around the replay's ``paxos_apply`` (or ``replica_step``) flips
one reply lane, one KV lane no message touched, or one register-mask
lane, and the replay must raise ``ReplayMismatch`` naming the machine,
key or global session, and the field.
"""

import numpy as np
import pytest
import torch

from repro.core import replay as ref
from repro.core.node import ProtocolConfig as RefProtocolConfig
from repro.core.sim import Cluster as RefCluster
from repro.core.sim import NetConfig as RefNetConfig
from repro.core.sim import workload as ref_workload
from repro.core.types import Msg as RefMsg
from repro.core.types import MsgKind as RefMsgKind
from repro.core.types import RmwId as RefRmwId
from repro.core.types import TS as RefTS
from repro_torch.core import replay
from repro_torch.core import vector
from repro_torch.core.node import ProtocolConfig
from repro_torch.core.sim import Cluster, NetConfig, workload
from repro_torch.core.types import Msg, MsgKind, RmwId, TS
from torch_threads import one_thread  # noqa: F401 (autouse)

CPU = {"device": "cpu"}
REF = {"use_kernel": False}
SEEDS = range(22)
ABOARD_SEEDS = (0, 3, 7, 11, 15)
FUSED_SEEDS = (1, 4, 8, 13)


def crashed_cluster(cluster_cls=Cluster, cfg_cls=ProtocolConfig,
                    net_cls=NetConfig, workload_fn=workload):
    """tests/test_replay.py's crash/restart schedule, in either package."""
    cfg = cfg_cls(n_machines=5, sessions_per_machine=2)
    cl = cluster_cls(cfg, net_cls(seed=9, drop_prob=0.04))
    cl.enable_msg_trace()
    workload_fn(cl, n_ops=20, keys=2, seed=9, rmw_frac=0.5, write_frac=0.25)
    cl.step(8)
    cl.crash(4)
    cl.step(6)
    cl.restart(4)
    assert cl.run_until_quiet(max_ticks=120_000)
    return cl


def ref_crashed_cluster():
    return crashed_cluster(RefCluster, RefProtocolConfig, RefNetConfig,
                           ref_workload)


# ---------------------------------------------------------------------------
# per-machine receiver replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_differential_replay(seed):
    stats = replay.run_and_replay(seed, n_ops=24, keys=3, **CPU)
    assert stats == ref.run_and_replay(seed, n_ops=24, keys=3, **REF)
    assert stats["machines"] == 5
    assert stats["messages"] > 0
    assert stats["history"] == 24


@pytest.mark.parametrize("seed", ABOARD_SEEDS)
def test_differential_replay_all_aboard(seed):
    stats = replay.run_and_replay(seed, n_ops=24, keys=3, all_aboard=True,
                                  **CPU)
    assert stats == ref.run_and_replay(seed, n_ops=24, keys=3,
                                       all_aboard=True, **REF)
    assert stats["machines"] == 5
    assert stats["history"] == 24


def test_replay_covers_full_vocabulary():
    """Across a handful of seeds the traces must exercise every receiver
    kind, including the §11 read write-back."""
    counts = {}
    for seed in (0, 1, 5):
        stats = replay.run_and_replay(seed, n_ops=30, keys=3, **CPU)
        assert stats == ref.run_and_replay(seed, n_ops=30, keys=3, **REF)
        for k, v in stats.items():
            counts[k] = counts.get(k, 0) + v
    for kind in ("propose", "accept", "commit", "write_query", "write",
                 "read_query", "read_commit"):
        assert counts.get(kind, 0) > 0, f"vocabulary gap: no {kind} lanes"


def test_replay_with_defaults():
    """The reference's default parameters (its jnp-path test, seed 3)."""
    stats = replay.run_and_replay(3, **CPU)
    assert stats == ref.run_and_replay(3, **REF)
    assert stats["machines"] == 5


def test_replay_with_crash_and_restart():
    """Traces from crashed/restarted schedules replay cleanly (restart
    keeps the trace; a crashed machine's trace simply ends)."""
    stats = replay.replay_cluster(crashed_cluster(), n_keys=2, **CPU)
    assert stats == ref.replay_cluster(ref_crashed_cluster(), n_keys=2,
                                       **REF)
    assert stats["machines"] == 5


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        replay.run_and_replay(0)


# ---------------------------------------------------------------------------
# fused (stacked-machine) replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", FUSED_SEEDS)
def test_fused_replay(seed):
    """All machines share each fused (M*K,) step — the ClusterEngine
    flattening convention — yet every row stays bit-identical to its own
    scalar shadow, wave for wave."""
    stats = replay.run_and_replay_fused(seed, n_ops=24, keys=3, **CPU)
    assert stats == ref.run_and_replay_fused(seed, n_ops=24, keys=3, **REF)
    assert stats["machines"] == 5
    assert stats["messages"] > 0
    assert stats["fused_waves"] > 0
    assert stats["history"] == 24


def test_fused_replay_with_defaults():
    """The reference's kernel-path case (seed 3, default parameters)."""
    stats = replay.run_and_replay_fused(3, **CPU)
    assert stats == ref.run_and_replay_fused(3, **REF)
    assert stats["machines"] == 5
    assert stats["fused_waves"] > 0


def test_fused_replay_with_crash_and_restart():
    """Row isolation under uneven traces: a crashed machine's trace simply
    ends, so its row rides later waves as all-NOOP lanes."""
    stats = replay.replay_cluster_fused(crashed_cluster(), n_keys=2, **CPU)
    assert stats == ref.replay_cluster_fused(ref_crashed_cluster(),
                                             n_keys=2, **REF)
    assert stats["machines"] == 5


# ---------------------------------------------------------------------------
# sharded replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", (1, 2, 4))
@pytest.mark.parametrize("seed", FUSED_SEEDS)
def test_sharded_replay(seed, shards):
    """Shard-for-shard replay against the N scalar shadows: replies,
    per-shard registration journals, and every shard block of every KV
    plane bit-identical at every shard count."""
    stats = replay.run_and_replay_sharded(seed, shards=shards, **CPU)
    assert stats == ref.run_and_replay_sharded(seed, shards=shards, **REF)
    assert stats["machines"] == 5
    assert stats["shards"] == shards
    assert stats["fused_waves"] > 0
    assert stats["lane_axis"] % shards == 0
    staged = sum(stats[f"shard{s}_lanes"] for s in range(shards))
    assert staged == stats["messages"]


def test_sharded_replay_four_shards_seed3():
    """The reference's kernel-path case (seed 3, four shards): one call
    spans every shard, and the planes still match the scalar shadows."""
    stats = replay.run_and_replay_sharded(3, shards=4, **CPU)
    assert stats == ref.run_and_replay_sharded(3, shards=4, **REF)
    assert stats["machines"] == 5
    assert stats["shards"] == 4
    assert stats["fused_waves"] > 0


def test_sharded_replay_with_crash_and_restart():
    """Uneven traces (a crashed row goes all-NOOP mid-run) stay shard-
    isolated too."""
    stats = replay.replay_sharded(crashed_cluster(), n_keys=2, shards=2,
                                  **CPU)
    assert stats == ref.replay_sharded(ref_crashed_cluster(), n_keys=2,
                                       shards=2, **REF)
    assert stats["machines"] == 5
    assert stats["shards"] == 2


# ---------------------------------------------------------------------------
# a moderate width: many staged lanes a wave
# ---------------------------------------------------------------------------

WIDE = dict(n_ops=300, keys=4096, rmw_frac=0.1, write_frac=0.2)


@pytest.mark.parametrize("mode", ["trace", "fused", "sharded"])
def test_replays_at_moderate_width(mode):
    """4096 keys x 64 sessions a machine: about a hundred lanes a fused
    wave go through the staged message stack, and the final compare runs
    over whole (18, 5 x 4096) stacks."""
    run, ref_run, kw = {
        "trace": (replay.run_and_replay, ref.run_and_replay, {}),
        "fused": (replay.run_and_replay_fused, ref.run_and_replay_fused, {}),
        "sharded": (replay.run_and_replay_sharded,
                    ref.run_and_replay_sharded, {"shards": 4}),
    }[mode]
    stats = run(5, cfg=ProtocolConfig(n_machines=5, sessions_per_machine=64),
                **WIDE, **kw, **CPU)
    assert stats == ref_run(5, cfg=RefProtocolConfig(
        n_machines=5, sessions_per_machine=64), **WIDE, **kw, **REF)
    assert stats["history"] == 300
    waves = stats["batches"] if mode == "trace" else stats["fused_waves"]
    assert stats["messages"] > 10 * waves, stats


def test_batch_to_msgbatch_matches_reference():
    trace = [Msg(MsgKind.PROPOSE, src=0, key=1, rmw_id=RmwId(3, 2),
                 ts=TS(4, 1), log_no=2, value=7),
             Msg(MsgKind.COMMIT, src=1, key=3, rmw_id=RmwId(5, 0),
                 ts=TS(1, 0), log_no=1, value=None)]
    ref_trace = [RefMsg(RefMsgKind(int(m.kind)), src=m.src, key=m.key,
                        rmw_id=RefRmwId(*m.rmw_id), ts=RefTS(*m.ts),
                        log_no=m.log_no, value=m.value) for m in trace]
    got = replay.batch_to_msgbatch(trace, 5, **CPU)
    want = ref.batch_to_msgbatch(ref_trace, 5)
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_staged_lanes_go_back_to_noop():
    """The resident message stack: a packed (2 + 12, L) buffer lands at
    its (row, key) lanes only, and clearing them leaves every lane NOOP
    again (MsgBatch.noop, is_registered 0), so a lane staged in one wave
    is not replayed in the next."""
    stage = replay._StagedLanes(2, 8, torch.device("cpu"))
    noop = torch.cat([torch.stack(vector.MsgBatch.noop(16, **CPU)),
                      torch.zeros((1, 16), dtype=torch.int32)])
    assert torch.equal(stage.planes, noop)
    host = np.arange(14 * 3, dtype=np.int32).reshape(14, 3) + 100
    host[0], host[1] = [0, 1, 1], [7, 0, 5]
    idx = stage.put(host)
    assert idx.tolist() == [7, 8, 13]
    want = noop.clone()
    want[:, [7, 8, 13]] = torch.from_numpy(host[2:])
    assert torch.equal(stage.planes, want)
    stage.clear(idx)
    assert torch.equal(stage.planes, noop)


# ---------------------------------------------------------------------------
# mutations: the gate raises, naming the place
# ---------------------------------------------------------------------------

def _staged_lanes(msgreg):
    return (msgreg[0] != vector.NOOP).nonzero()[:, 0].tolist()


def _flip_reply_wrapper(real, wave, k):
    """``paxos_apply`` that flips the opcode's low bit of the first staged
    lane on call ``wave``; records that lane's (row, key)."""
    hit = {}

    def wrapper(kv, msgreg, out=None):
        res = real(kv, msgreg, out=out)
        if wrapper.calls == wave:
            lane = _staged_lanes(msgreg)[0]
            res[1][replay._REP_INDEX["opcode"], lane] ^= 1
            hit["row"], hit["key"] = divmod(lane, k)
        wrapper.calls += 1
        return res

    wrapper.calls = 0
    return wrapper, hit


@pytest.mark.parametrize("shards", [None, 2])
def test_flipped_reply_lane_is_caught(monkeypatch, shards):
    cl = crashed_cluster()
    wrapper, hit = _flip_reply_wrapper(replay.paxos_apply, 3, 2)
    monkeypatch.setattr(replay, "paxos_apply", wrapper)
    with pytest.raises(replay.ReplayMismatch) as exc:
        if shards is None:
            replay.replay_cluster_fused(cl, n_keys=2, **CPU)
        else:
            replay.replay_sharded(cl, n_keys=2, shards=shards, **CPU)
    what = "fused" if shards is None else "sharded"
    shard = "" if shards is None else f"shard {hit['key']}, "
    assert (f"{what} reply diverged at wave 3, machine {hit['row']}, "
            f"{shard}key {hit['key']}") in str(exc.value)
    assert "'opcode'" in str(exc.value)


def test_flipped_reply_lane_is_caught_per_machine(monkeypatch):
    """The per-machine replay through a flipped ``replica_step``."""
    real = replay.replica_step
    hit = {}

    def wrapper(table, msg, registered):
        table, replies, registered = real(table, msg, registered)
        if wrapper.calls == 2:
            hit["key"] = int((msg.kind != vector.NOOP).nonzero()[0, 0])
            kind = replies.kind.clone()
            kind[hit["key"]] ^= 1
            replies = replies._replace(kind=kind)
        wrapper.calls += 1
        return table, replies, registered

    wrapper.calls = 0
    monkeypatch.setattr(replay, "replica_step", wrapper)
    with pytest.raises(replay.ReplayMismatch) as exc:
        replay.replay_cluster(crashed_cluster(), n_keys=2, **CPU)
    assert f"reply diverged at batch 2, key {hit['key']}" in str(exc.value)
    assert "'kind'" in str(exc.value)


@pytest.mark.parametrize("shards", [None, 4])
def test_flipped_untouched_kv_lane_is_caught(monkeypatch, shards):
    """A KV lane no message touched (keys 2..7: the schedule uses keys 0
    and 1) flipped on one wave: the kernel carries it through later waves
    as a NOOP lane, and the final compare names it."""
    cl = crashed_cluster()
    real = replay.paxos_apply
    row, key, n_keys = 3, 6, 8
    field = replay._KV_FIELDS.index("val_log")

    def wrapper(kv, msgreg, out=None):
        res = real(kv, msgreg, out=out)
        if wrapper.calls == 1:
            res[0][field, row * n_keys + key] ^= 4
        wrapper.calls += 1
        return res

    wrapper.calls = 0
    monkeypatch.setattr(replay, "paxos_apply", wrapper)
    with pytest.raises(replay.ReplayMismatch) as exc:
        if shards is None:
            replay.replay_cluster_fused(cl, n_keys=n_keys, **CPU)
        else:
            replay.replay_sharded(cl, n_keys=n_keys, shards=shards, **CPU)
    where = (f"key {key}" if shards is None
             else f"shard {key // (n_keys // shards)}, key {key}")
    assert (f"final KV state diverged at machine {row}, {where} "
            f"(field: (scalar, fused)): {{'val_log': (0, 4)}}"
            in str(exc.value))


@pytest.mark.parametrize("shards", [None, 2])
def test_flipped_register_mask_is_caught(monkeypatch, shards):
    """The register mask of an unregistered PROPOSE lane set to 1: the
    fused side's registry takes an rmw-id the scalar one never committed,
    and the registry compare after that wave names the session."""
    cl = crashed_cluster()
    real = replay.paxos_apply
    hit = {}

    def wrapper(kv, msgreg, out=None):
        res = real(kv, msgreg, out=out)
        if not hit:
            lanes = ((msgreg[0] == vector.PROPOSE) & (msgreg[-1] == 0)
                     & (msgreg[replay._MSG_FIELDS.index("rmw_sess")] >= 0)
                     ).nonzero()[:, 0].tolist()
            if lanes:
                lane = lanes[0]
                res[2][lane] = 1
                hit.update(wave=wrapper.calls, row=lane // 2,
                           gs=int(msgreg[replay._MSG_FIELDS.index(
                               "rmw_sess"), lane]),
                           cnt=int(msgreg[replay._MSG_FIELDS.index(
                               "rmw_cnt"), lane]))
        wrapper.calls += 1
        return res

    wrapper.calls = 0
    monkeypatch.setattr(replay, "paxos_apply", wrapper)
    with pytest.raises(replay.ReplayMismatch) as exc:
        if shards is None:
            replay.replay_cluster_fused(cl, n_keys=2, **CPU)
        else:
            replay.replay_sharded(cl, n_keys=2, shards=shards, **CPU)
    what = "fused" if shards is None else "sharded"
    assert (f"{what} registry diverged at wave {hit['wave']}, machine "
            f"{hit['row']}, global session {hit['gs']}: scalar "
            in str(exc.value))
    assert f", fused {hit['cnt']}" in str(exc.value)


# ---------------------------------------------------------------------------
# bucketing contract
# ---------------------------------------------------------------------------

def _msg(kind, key, cnt=1, gsess=0):
    return Msg(kind, src=0, key=key, rmw_id=RmwId(cnt, gsess),
               ts=TS(3, 0), log_no=1, value=5)


def test_bucketing_one_message_per_key_order_preserved():
    trace = [_msg(MsgKind.PROPOSE, 0), _msg(MsgKind.PROPOSE, 1),
             _msg(MsgKind.ACCEPT, 0), _msg(MsgKind.COMMIT, 0),
             _msg(MsgKind.WRITE, 1)]
    batches = replay.bucket_conflict_free(trace)
    for batch in batches:
        keys = [m.key for m in batch]
        assert len(keys) == len(set(keys)), "two messages for one key"
    # per-key order is the trace order
    for key in (0, 1):
        flat = [m for b in batches for m in b if m.key == key]
        want = [m for m in trace if m.key == key]
        assert flat == want


def test_bucketing_flushes_on_inbatch_registration():
    """A commit registering (cnt, gsess) followed by a propose with the
    same rmw-id on ANOTHER key must split batches: the vector gather reads
    pre-batch registry state, the scalar handler an up-to-date one."""
    trace = [_msg(MsgKind.COMMIT, 0, cnt=5, gsess=2),
             _msg(MsgKind.PROPOSE, 1, cnt=5, gsess=2)]
    batches = replay.bucket_conflict_free(trace)
    assert len(batches) == 2
    # ... while an unrelated rmw-id shares the batch just fine
    trace2 = [_msg(MsgKind.COMMIT, 0, cnt=5, gsess=2),
              _msg(MsgKind.PROPOSE, 1, cnt=6, gsess=2)]
    assert len(replay.bucket_conflict_free(trace2)) == 1


def test_read_commit_rides_commit_lane():
    """§11 write-backs register their rmw-id and flush like commits."""
    trace = [_msg(MsgKind.READ_COMMIT, 0, cnt=4, gsess=1),
             _msg(MsgKind.ACCEPT, 1, cnt=4, gsess=1)]
    assert len(replay.bucket_conflict_free(trace)) == 2
