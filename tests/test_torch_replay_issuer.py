"""The port's differential issuer replay (``repro_torch.core.replay``) on
the CPU.

Counterparts of the issuer tests of ``tests/test_replay.py`` on the same
seeds and parameters, run with ``device="cpu"``: the issuer step is
``kernels/paxos_propose/ops.issuer_step``, whose plain version
``tests/test_torch_proposer_vector.py`` holds bit-equal to the reference's
``proposer_step``.  Each replay's stats dict must equal the reference's
on the same seed.  Beyond them: one case at 4096 keys x 64 sessions, and
mutation cases, where a wrapper around the replay's ``issuer_step`` flips
one plane of one session and the replay must raise ``ReplayMismatch``
naming the session and the plane.
"""

import functools

import pytest

from repro.core import replay as ref
from repro.core.node import ProtocolConfig as RefProtocolConfig
from repro.core.sim import Cluster as RefCluster
from repro.core.sim import NetConfig as RefNetConfig
from repro.core.sim import workload as ref_workload
from repro_torch.core import replay
from repro_torch.core.node import ProtocolConfig
from repro_torch.core.sim import Cluster, NetConfig, workload
from torch_threads import one_thread  # noqa: F401 (autouse)

CPU = {"device": "cpu"}
# >= 20 seeded faulty traces; odd seeds deploy the §9 all-aboard fast path
ISSUER_SEEDS = range(22)


@functools.lru_cache(maxsize=None)
def issuer_pair(seed, all_aboard):
    """(port stats, reference stats) of one seeded run, computed once: the
    vocabulary test reads four of the per-seed test's runs."""
    return (replay.run_and_replay_issuer(seed, n_ops=24, keys=3,
                                         all_aboard=all_aboard, **CPU),
            ref.run_and_replay_issuer(seed, n_ops=24, keys=3,
                                      all_aboard=all_aboard))


@pytest.mark.parametrize("seed", ISSUER_SEEDS)
def test_differential_issuer_replay(seed):
    stats, want = issuer_pair(seed, bool(seed % 2))
    assert stats == want
    assert stats["machines"] == 5
    assert stats["replies"] > 0
    assert stats["decisions"] > 0
    assert stats["history"] == 24


def test_issuer_replay_covers_decision_vocabulary():
    """Across a handful of seeds the replayed decisions must cover the
    protocol's arbitration outcomes: local accepts, commit rounds, retries,
    helping, and every ABD phase transition."""
    counts = {}
    for seed, aboard in ((0, False), (2, False), (3, True), (7, True)):
        stats, want = issuer_pair(seed, aboard)
        assert stats == want
        for k, v in stats.items():
            if k.startswith("d_"):
                counts[k] = counts.get(k, 0) + v
    for d in ("d_local_accept", "d_commit_bcast", "d_commit_done", "d_retry",
              "d_help", "d_help_self", "d_stop_help", "d_log_too_low",
              "d_abd_w2", "d_abd_w_done", "d_abd_r_done", "d_abd_r_wb",
              "d_abd_rc_done"):
        assert counts.get(d, 0) > 0, f"decision vocabulary gap: no {d}"


def crashed_cluster(cluster_cls=Cluster, cfg_cls=ProtocolConfig,
                    net_cls=NetConfig, workload_fn=workload):
    cfg = cfg_cls(n_machines=5, sessions_per_machine=2)
    cl = cluster_cls(cfg, net_cls(seed=9, drop_prob=0.04))
    cl.enable_issuer_trace()
    workload_fn(cl, n_ops=20, keys=2, seed=9, rmw_frac=0.5, write_frac=0.25)
    cl.step(8)
    cl.crash(4)
    cl.step(6)
    cl.restart(4)
    assert cl.run_until_quiet(max_ticks=120_000)
    return cl


def test_issuer_replay_with_crash_and_restart():
    """Issuer traces spanning a crash/restart replay cleanly: the restart
    parks every lane (volatile tallies died), so stale-round replies are
    dropped on both sides."""
    stats = replay.replay_issuer_cluster(crashed_cluster(), **CPU)
    assert stats == ref.replay_issuer_cluster(crashed_cluster(
        RefCluster, RefProtocolConfig, RefNetConfig, ref_workload))
    assert stats["machines"] == 5
    assert stats["decisions"] > 0


def shared_schedule(cluster_cls=Cluster, cfg_cls=ProtocolConfig,
                    net_cls=NetConfig, workload_fn=workload):
    cfg = cfg_cls(n_machines=5, sessions_per_machine=2)
    cl = cluster_cls(cfg, net_cls(seed=4, drop_prob=0.05, dup_prob=0.04))
    cl.enable_msg_trace()
    cl.enable_issuer_trace()
    workload_fn(cl, n_ops=24, keys=3, seed=4, rmw_frac=0.45, write_frac=0.3)
    assert cl.run_until_quiet(max_ticks=120_000)
    return cl


def test_issuer_and_receiver_replay_share_a_schedule():
    """Both taps can record the same run: the receiver replay and the
    issuer replay validate the two halves of every machine end to end."""
    cl = shared_schedule()
    recv = replay.replay_cluster(cl, n_keys=3, **CPU)
    issu = replay.replay_issuer_cluster(cl, **CPU)
    assert recv["machines"] == issu["machines"] == 5
    rcl = shared_schedule(RefCluster, RefProtocolConfig, RefNetConfig,
                          ref_workload)
    assert recv == ref.replay_cluster(rcl, n_keys=3, use_kernel=False)
    assert issu == ref.replay_issuer_cluster(rcl)


def test_issuer_replay_at_moderate_width():
    """64 sessions a machine over 4096 keys: many sessions a reply batch,
    and the incremental plane compare over a (65, 64) table."""
    kw = dict(n_ops=300, keys=4096, rmw_frac=0.1, write_frac=0.2)
    stats = replay.run_and_replay_issuer(
        5, cfg=ProtocolConfig(n_machines=5, sessions_per_machine=64),
        **kw, **CPU)
    assert stats == ref.run_and_replay_issuer(
        5, cfg=RefProtocolConfig(n_machines=5, sessions_per_machine=64),
        **kw)
    assert stats["history"] == 300
    assert stats["replies"] > 3 * stats["batches"], stats


@pytest.mark.parametrize("plane", ["key", "rep_bits"])
def test_flipped_proposer_plane_is_caught(monkeypatch, plane):
    """One plane of session 1 flipped in the table the engine returns on
    its fourth step: the plane compare after that batch names the session
    and the plane (a pass-through plane and a tally plane)."""
    real = replay.issuer_step

    def wrapper(table, batch, **kw):
        table, actions = real(table, batch, **kw)
        if wrapper.calls == 3:
            flipped = getattr(table, plane).clone()
            flipped[1] ^= 64
            table = table._replace(**{plane: flipped})
        wrapper.calls += 1
        return table, actions

    wrapper.calls = 0
    monkeypatch.setattr(replay, "issuer_step", wrapper)
    with pytest.raises(replay.ReplayMismatch) as exc:
        replay.run_and_replay_issuer(2, **CPU)
    msg = str(exc.value)
    assert "proposer planes diverged (after batch) at session 1" in msg
    assert f"{{'{plane}': (" in msg
