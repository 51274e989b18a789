"""The port's flight recorder (``repro_torch.obs``) against the reference's.

* A scalar run's JSONL dump is byte-identical to the reference's on the
  same seed and recorder settings, in every mode.
* On the batched cluster the recorder's counters reconcile exactly with
  the completion history, the ring is the reference batched cluster's,
  and the engine's telemetry reaches the registry as ``engine.*``
  counters — including the host<->device counters only the port keeps
  (waves, staging and gather bytes, issuer-wave syncs, transfer bytes).
* ``flight_guard`` dumps on a checker failure and re-raises; the report
  reads the dump back as the reference's does.
"""

import functools
import json
from collections import Counter

import pytest

from repro.core.node import ProtocolConfig as RefProtocolConfig
from repro.core.sim import Cluster as RefCluster
from repro.core.sim import NetConfig as RefNetConfig
from repro.core.sim import workload as ref_workload
from repro.obs import FlightRecorder as RefFlightRecorder
from repro.obs import dump_jsonl as ref_dump_jsonl
from repro.obs import summarize as ref_summarize
from repro.serve.paxos import BatchedMachine as RefBatchedMachine
from repro_torch.core import checkers
from repro_torch.core.node import ProtocolConfig
from repro_torch.core.sim import Cluster, NetConfig, workload
from repro_torch.obs import (
    FlightRecorder, MetricsRegistry, dump_all, dump_jsonl, flight_guard,
    load_records, render_summary, summarize,
)
from repro_torch.serve.paxos import BatchedMachine
from torch_threads import one_thread  # noqa: F401 (autouse)

KIND_TO_PATHS = {"RMW": ("all_aboard_fast", "cp_slow"),
                 "READ": ("abd_read",), "WRITE": ("abd_write",)}
PORT = dict(cfg=ProtocolConfig, net=NetConfig, cluster=Cluster,
            workload=workload, rec=FlightRecorder, dump=dump_jsonl)
REF = dict(cfg=RefProtocolConfig, net=RefNetConfig, cluster=RefCluster,
           workload=ref_workload, rec=RefFlightRecorder, dump=ref_dump_jsonl)
# telemetry the port's engine keeps beyond the reference's
PORT_ENGINE_KEYS = ("waves", "stage_h2d_bytes", "gather_d2h_bytes",
                    "issuer_wave_syncs", "transfer_bytes")


def faulty_cluster(pkg, seed, rec, machine_cls=None, n_ops=20):
    cfg = pkg["cfg"](n_machines=5, sessions_per_machine=2, all_aboard=True)
    net = pkg["net"](seed=seed, drop_prob=0.06, dup_prob=0.05,
                     heavy_tail_prob=0.03, heavy_tail_extra=25.0)
    kw = {} if machine_cls is None else {"machine_cls": machine_cls}
    cl = pkg["cluster"](cfg, net, **kw)
    cl.attach_obs(rec)
    pkg["workload"](cl, n_ops=n_ops, keys=3, seed=seed, rmw_frac=0.45,
                    write_frac=0.3)
    cl.step(8)
    cl.network.deliver_due(cl.network.now + 1.0, cl.machines)
    cl.crash(4)
    cl.step(6)
    cl.restart(4)
    assert cl.run_until_quiet(max_ticks=160_000)
    return cl


def run_and_dump(pkg, tmp_path, name, mode, seed, machine_cls=None):
    rec = pkg["rec"](mode=mode, sample_every=3, capacity=1 << 14,
                     meta={"seed": seed, "spec": "determinism"})
    cl = faulty_cluster(pkg, seed, rec, machine_cls)
    return cl, rec, pkg["dump"](rec, str(tmp_path / name))


def reconcile(rec, cluster):
    kinds = Counter(h["kind"].name for h in cluster.history)
    paths = rec.path_counts()
    for kind, names in KIND_TO_PATHS.items():
        assert sum(paths[p] for p in names) == kinds.get(kind, 0)
    assert sum(paths.values()) == len(cluster.history)


@pytest.mark.parametrize("mode", ["off", "sampled", "full"])
@pytest.mark.parametrize("seed", [4, 13])
def test_scalar_dump_byte_identical_to_reference(tmp_path, seed, mode):
    cl, rec, got = run_and_dump(PORT, tmp_path, "port.jsonl", mode, seed)
    _, _, want = run_and_dump(REF, tmp_path, "ref.jsonl", mode, seed)
    with open(got, "rb") as fg, open(want, "rb") as fw:
        body = fg.read()
        assert body == fw.read()
    reconcile(rec, cl)
    assert len(body.splitlines()) == 2 + len(rec.ring)


def test_batched_recorder_matches_reference_and_carries_telemetry(tmp_path):
    seed = 7
    cl, rec, got = run_and_dump(
        PORT, tmp_path, "port.jsonl", "full", seed,
        functools.partial(BatchedMachine, device="cpu"))
    _, ref_rec, want = run_and_dump(
        REF, tmp_path, "ref.jsonl", "full", seed,
        functools.partial(RefBatchedMachine, use_kernel=False))
    reconcile(rec, cl)
    assert rec.path_counts() == ref_rec.path_counts()
    g, w = load_records(got), load_records(want)
    assert g[0] == w[0]                       # meta header
    assert g[2:] == w[2:]                     # the ring, span for span
    gm, wm = g[1], w[1]
    # every counter but the engine's agrees; the engine's flow in too
    assert ({k: v for k, v in gm["counters"].items()
             if not k.startswith("engine.")}
            == {k: v for k, v in wm["counters"].items()
                if not k.startswith("engine.")})
    tel = cl.engine.telemetry()
    for k in PORT_ENGINE_KEYS:
        assert gm["counters"]["engine." + k] == tel[k]
        assert "engine." + k not in wm["counters"]
    assert gm["counters"]["engine.waves"] > 0
    assert gm["counters"]["engine.transfer_bytes"] > 0
    assert gm["counters"]["engine.row_reloads"] > 0      # the restart
    assert gm["gauges"]["engine.receiver_lanes_per_call"] > 0
    assert gm["counters"]["ingest.m0.offered"] > 0
    assert "ingest.m0.queue_depth" in gm["gauges"]


def test_summary_of_a_port_dump_matches_reference(tmp_path):
    _, _, got = run_and_dump(PORT, tmp_path, "p.jsonl", "sampled", 4)
    _, _, want = run_and_dump(REF, tmp_path, "r.jsonl", "sampled", 4)
    assert summarize(load_records(got)) == ref_summarize(load_records(want))


def test_registry_matches_reference():
    from repro.obs import MetricsRegistry as RefRegistry

    regs = [MetricsRegistry(), RefRegistry()]
    for reg in regs:
        reg.inc("a")
        reg.inc("a", 4)
        reg.set_gauge("g", 2.5)
        reg.register_gauge("live", lambda: 7)
        for v in (1.0, 3.0, 9.0, 250.0):
            reg.observe("lat", v)
    assert regs[0].snapshot() == regs[1].snapshot()


def tamper_commit_log(cluster):
    seen = {}
    for m in cluster.machines:
        for key, slots in m.commit_log.items():
            for slot, rec in slots.items():
                if (key, slot) in seen and seen[(key, slot)] is not m:
                    rid, value, base = rec
                    slots[slot] = (rid, value + 999, base)
                    return True
                seen[(key, slot)] = m
    return False


def test_flight_guard_dumps_batched_checker_failure_and_reraises(tmp_path):
    rec = FlightRecorder(mode="full", meta={"seed": 4, "spec": "postmortem"})
    cl = faulty_cluster(PORT, 4, rec,
                        functools.partial(BatchedMachine, device="cpu"))
    assert tamper_commit_log(cl), "workload produced no replicated record"
    out = tmp_path / "dumps"
    with pytest.raises(checkers.SafetyViolation):
        with flight_guard(rec, str(out), label="checker"):
            checkers.check_all(cl)
    s = summarize(load_records(str(out / "flight.jsonl")))
    assert s["dump_reason"].startswith("checker: SafetyViolation")
    assert sum(s["path_mix"].values()) == len(cl.history)
    assert "path mix" in render_summary(s)
    with open(out / "flight.trace.json") as f:
        assert any(e["ph"] == "X" for e in json.load(f)["traceEvents"])
    paths = dump_all(rec, str(tmp_path), reason="unit", stem="seed004")
    assert paths["jsonl"].endswith("seed004.jsonl")
