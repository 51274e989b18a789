"""The slice as a whole on the CPU: the port's open-loop harness drives the
port's clusters, faults and all, and agrees with the reference.

One small ``OpenLoopSpec`` (5 machines x 2 sessions, 48 Zipf keys, the
kv_mixed mix, message drops and duplicates) with a ``FaultPlan`` (a crash
and restart, then a partition) runs on

* the reference's scalar cluster,
* the port's scalar cluster,
* the port's ``Cluster(machine_cls=partial(BatchedMachine, device="cpu"))``,

each with a sampled ``FlightRecorder``.  All three give the same
completions (tag for tag), the same latency report, the same bench lane
(the batched cluster's lane adds its ingest schedulers' gauges, which the
reference's batched cluster reports identically) and the same per-path
counts, which reconcile exactly with the history.
"""

import functools
import json
import pathlib
from collections import Counter

import pytest

from repro.core import checkers as ref_checkers
from repro.core import sim as ref_sim
from repro.obs import FlightRecorder as RefFlightRecorder
from repro.serve import loadgen as ref_lg
from repro.serve.paxos import BatchedMachine as RefBatchedMachine
from repro_torch.core import checkers, sim
from repro_torch.obs import FlightRecorder
from repro_torch.serve import loadgen as lg
from repro_torch.serve.paxos import BatchedMachine

KIND_TO_PATHS = {"RMW": ("all_aboard_fast", "cp_slow"),
                 "READ": ("abd_read",), "WRITE": ("abd_write",)}
SCHED_GAUGES = ("sched_keys_backlogged", "sched_oldest_age",
                "sched_queue_depth")


def run(pkg_lg, recorder_cls, seed, machine_cls=None, reconfig=False):
    spec = pkg_lg.OpenLoopSpec(
        seed=seed, n_machines=5, sessions=2, n_keys=48, zipf_s=0.9,
        key_base=1 if reconfig else 0, mix=pkg_lg.MIXES["kv_mixed"],
        phases=(pkg_lg.ArrivalPhase(rate=0.25, ticks=160),),
        all_aboard=seed % 2 == 1, reconfig=reconfig,
        drop_prob=0.02, dup_prob=0.02)
    plan = (pkg_lg.FaultPlan(settle=30.0)
            .crash_restart(4, at=40.0, down_for=25.0)
            .partition(90.0, 120.0, (0, 1, 2), (3, 4)))
    rec = recorder_cls(mode="sampled", meta={"seed": seed})
    kw = {} if machine_cls is None else {"machine_cls": machine_cls}
    res = pkg_lg.OpenLoopHarness(spec, faults=plan, obs=rec, **kw).run()
    return res, rec


def reconcile(rec, cluster):
    kinds = Counter(h["kind"].name for h in cluster.history)
    paths = rec.path_counts()
    for kind, names in KIND_TO_PATHS.items():
        assert sum(paths[p] for p in names) == kinds.get(kind, 0)
    assert sum(paths.values()) == len(cluster.history)


def without_sched(lane):
    out = dict(lane)
    out["gauges"] = {k: v for k, v in lane["gauges"].items()
                     if k not in SCHED_GAUGES}
    return out


@pytest.mark.parametrize("reconfig", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_open_loop_reference_scalar_port_scalar_port_batched(seed, reconfig):
    ref, ref_rec = run(ref_lg, RefFlightRecorder, seed, reconfig=reconfig)
    scalar, s_rec = run(lg, FlightRecorder, seed, reconfig=reconfig)
    batched, b_rec = run(lg, FlightRecorder, seed,
                         functools.partial(BatchedMachine, device="cpu"),
                         reconfig=reconfig)
    want = ref_sim.completion_tuples(ref.cluster)
    assert want, "the workload completed nothing"
    assert sim.completion_tuples(scalar.cluster) == want
    assert sim.completion_tuples(batched.cluster) == want
    assert scalar.recorder.report() == ref.recorder.report()
    assert batched.recorder.report() == ref.recorder.report()
    assert scalar.lane() == ref.lane()
    assert without_sched(batched.lane()) == ref.lane()
    assert (s_rec.path_counts() == b_rec.path_counts()
            == ref_rec.path_counts())
    for rec, res in ((s_rec, scalar), (b_rec, batched), (ref_rec, ref)):
        reconcile(rec, res.cluster)
    assert ref.offered == batched.offered == batched.completed + batched.lost
    assert batched.cluster.engine.kv.dev.device.type == "cpu"


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_lane_matches_reference_batched(seed):
    """The batched lane with its scheduler gauges, against the reference's
    batched cluster (jnp engine) on the same spec."""
    ref, _ = run(ref_lg, RefFlightRecorder, seed,
                 functools.partial(RefBatchedMachine, use_kernel=False))
    got, _ = run(lg, FlightRecorder, seed,
                 functools.partial(BatchedMachine, device="cpu"))
    assert set(SCHED_GAUGES) <= set(got.lane()["gauges"])
    assert got.lane() == ref.lane()


def test_overload_and_quiescence_errors_match_reference():
    """A run that cannot drain raises in both packages with the same
    accounting in the message."""
    msgs = []
    for pkg in (lg, ref_lg):
        spec = pkg.OpenLoopSpec(seed=3, n_machines=3, sessions=1, n_keys=8,
                                phases=(pkg.ArrivalPhase(rate=2.0,
                                                         ticks=40),))
        with pytest.raises(RuntimeError) as exc:
            pkg.OpenLoopHarness(spec).run(max_ticks=30)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="key_base"):
        lg.OpenLoopSpec(reconfig=True)


# chip_smoke.py's [open_loop] runs, recorded from the reference's scalar
# cluster: the card's batched runs are held to this record
RECORD = pathlib.Path(__file__).parent / "data" / "open_loop_reference.json"


def full_width_run(pkg, pkg_checkers, pkg_sim, seed):
    """chip_smoke.py's open-loop spec for ``seed`` (5 machines x 800
    sessions, 2^20 Zipf keys, seed 1 all-aboard, machine 4 crashed at tick
    60 and restarted at 85, a partition at 120-150) on ``pkg``'s scalar
    cluster: the record of the run, with the checkers' verdict ("green" or
    the violation raised)."""
    spec = pkg.OpenLoopSpec(
        seed=seed, n_machines=5, sessions=800, n_keys=2 ** 20, zipf_s=0.99,
        mix=pkg.MIXES["kv_mixed"],
        phases=(pkg.ArrivalPhase(rate=25.0, ticks=200.0),),
        all_aboard=seed == 1, drop_prob=0.02, dup_prob=0.02)
    plan = (pkg.FaultPlan(settle=30.0)
            .crash_restart(4, at=60.0, down_for=25.0)
            .partition(120.0, 150.0, (0, 1, 2), (3, 4)))
    res = pkg.OpenLoopHarness(spec, faults=plan).run(check=False)
    try:
        pkg_checkers.check_all(res.cluster)
        verdict = "green"
    except pkg_checkers.SafetyViolation as exc:
        verdict = str(exc)
    got = pkg_sim.completion_tuples(res.cluster)
    return {"spec": repr(spec), "faults": repr((plan.settle, plan.events)),
            "completions": len(got),
            "digest": sim.completion_digest(got), "checkers": verdict}


def test_full_width_all_aboard_restart_fault_matches_reference():
    """chip_smoke.py's open-loop seed 1 on the scalar clusters: the
    reference's protocol violates linearizability there (an all-aboard RMW
    of the restarted machine commits below a write that completed before it
    was invoked; ROADMAP, Queue 3).  The port completes the same operations
    and its checkers raise the same violation; both are the committed
    record's."""
    runs = [full_width_run(lg, checkers, sim, 1),
            full_width_run(ref_lg, ref_checkers, ref_sim, 1)]
    assert runs[0] == runs[1] == json.loads(RECORD.read_text())["1"]
    assert runs[0]["checkers"].startswith("key 796098: real-time violation")


def test_full_width_reference_record():
    """The committed record of chip_smoke.py's open-loop seed 0 is what the
    reference's scalar cluster does today (green checkers), and the port's
    scalar cluster does the same.  ``python tests/test_torch_open_loop.py``
    remakes the record (both seeds) from the reference."""
    record = json.loads(RECORD.read_text())["0"]
    assert record["checkers"] == "green"
    assert full_width_run(ref_lg, ref_checkers, ref_sim, 0) == record
    assert full_width_run(lg, checkers, sim, 0) == record


if __name__ == "__main__":
    RECORD.parent.mkdir(exist_ok=True)
    RECORD.write_text(json.dumps(
        {str(seed): full_width_run(ref_lg, ref_checkers, ref_sim, seed)
         for seed in (0, 1)}, indent=1) + "\n")
