"""The port's three fault smokes and its dump reader against the
reference's scripts, on the CPU.

``scripts/torch_{batched,reconfig,open_loop}_smoke.py`` are held seed for
seed to ``scripts/{batched,reconfig,open_loop}_smoke.py``, loaded by path:
the reference's **scalar** cluster's completions (tag for tag) equal the
port's scalar cluster's and the port's batched cluster's
(``BatchedMachine(device="cpu")``: the select networks' plain versions).
The reference's own batched path sends its ``KERNEL_SEEDS`` through
Pallas, which fails at trace on JAX 0.9.0, so its scalar run is the
yardstick.  The port's batched run must also pass the checkers, reconcile
its flight recorder's path counters with its history, and (reconfig) end
at epoch 5 with 4 members.  Every seed of every smoke is a case.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.core.node import Machine as RefMachine
from repro.core import sim as ref_sim
from repro.serve import loadgen as ref_lg
from repro_torch.core import checkers, sim
from repro_torch.core.node import Machine
from repro_torch.obs import FlightRecorder
from repro_torch.serve import loadgen as lg
from torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load(rel: str, name: str):
    """A script of the repo as a module, by path."""
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


ref_bs = load("scripts/batched_smoke.py", "ref_batched_smoke")
ref_rs = load("scripts/reconfig_smoke.py", "ref_reconfig_smoke")
ref_ol = load("scripts/open_loop_smoke.py", "ref_open_loop_smoke")
bs = load("scripts/torch_batched_smoke.py", "torch_batched_smoke")
rs = load("scripts/torch_reconfig_smoke.py", "torch_reconfig_smoke")
ol = load("scripts/torch_open_loop_smoke.py", "torch_open_loop_smoke")
tr = load("scripts/torch_trace_report.py", "torch_trace_report")


def test_seed_sets_and_plans_are_the_reference_s():
    for port, ref, names in (
            (bs, ref_bs, ("SEEDS", "ABOARD_SEEDS", "CRASH_SEEDS",
                          "KERNEL_SEEDS", "KIND_TO_PATHS")),
            (rs, ref_rs, ("SEEDS", "ABOARD_SEEDS", "KERNEL_SEEDS")),
            (ol, ref_ol, ("SEEDS", "CRASH_SEEDS", "PARTITION_SEEDS",
                          "STORM_SEEDS", "BATCHED_SEEDS", "KIND_TO_PATHS",
                          "MIX_ROTATION"))):
        for name in names:
            assert getattr(port, name) == getattr(ref, name), name
    for seed in ol.SEEDS:
        a, b = ol.spec_for(seed), ref_ol.spec_for(seed)
        assert (a.mix.name, a.zipf_s, a.n_keys, a.sessions, a.n_machines,
                a.drop_prob, a.dup_prob) == \
            (b.mix.name, b.zipf_s, b.n_keys, b.sessions, b.n_machines,
             b.drop_prob, b.dup_prob)
        fa, fb = ol.faults_for(seed), ref_ol.faults_for(seed)
        assert [(e.at, e.action, e.mid, e.groups)
                for e in fa.sorted_events()] == \
            [(e.at, e.action, e.mid, e.groups) for e in fb.sorted_events()]


@pytest.mark.parametrize("seed", list(bs.SEEDS))
def test_batched_smoke_seed(seed):
    want = ref_sim.completion_tuples(ref_bs.run(RefMachine, seed))
    assert sim.completion_tuples(bs.run(Machine, seed)) == want
    rec = FlightRecorder(mode="sampled", meta={"seed": seed})
    batched = bs.run(bs.batched_cls("cpu"), seed, obs=rec)
    assert sim.completion_tuples(batched) == want
    checkers.check_all(batched)
    bs.reconcile_paths(rec, batched, seed)


@pytest.mark.parametrize("seed", [2, 5])
def test_batched_smoke_seed_sharded(seed):
    """Two shard rows over 3 keys, and the crash mid-batch."""
    want = ref_sim.completion_tuples(ref_bs.run(RefMachine, seed))
    rec = FlightRecorder(mode="sampled", meta={"seed": seed})
    batched = bs.run(bs.batched_cls("cpu", shards=2), seed, obs=rec)
    assert sim.completion_tuples(batched) == want
    checkers.check_all(batched)
    bs.reconcile_paths(rec, batched, seed)


@pytest.mark.parametrize("seed", list(rs.SEEDS))
def test_reconfig_smoke_seed(seed):
    ref = ref_rs.storm(RefMachine, seed)
    want = ref_sim.completion_tuples(ref)
    scalar = rs.storm(Machine, seed)
    batched = rs.storm(rs.batched_cls("cpu"), seed)
    assert sim.completion_tuples(scalar) == want
    assert sim.completion_tuples(batched) == want
    checkers.check_all(batched)
    st = batched.stats()
    assert (st["view_epoch"], st["view_members"]) == (5, 4)
    assert st["net_removed_dst"] == ref.stats()["net_removed_dst"]


@pytest.mark.parametrize("seed", list(ol.SEEDS))
def test_open_loop_smoke_seed(seed):
    ref = ref_lg.OpenLoopHarness(ref_ol.spec_for(seed),
                                 faults=ref_ol.faults_for(seed)).run()
    want = ref_sim.completion_tuples(ref.cluster)
    rec = FlightRecorder(mode="sampled", meta={"seed": seed})
    scalar = lg.OpenLoopHarness(ol.spec_for(seed), faults=ol.faults_for(seed),
                                obs=rec).run()
    ol.reconcile_paths(rec, scalar.cluster, seed)
    assert sim.completion_tuples(scalar.cluster) == want
    assert (scalar.completed, scalar.lost) == (ref.completed, ref.lost)
    batched, launched = ol.run_batched(seed, "cpu")
    assert sim.completion_tuples(batched.cluster) == want
    checkers.check_all(batched.cluster)
    assert sum(launched.values()) == 0      # the CPU counts no launch


def test_mains_print_a_line_a_seed(capsys, monkeypatch):
    monkeypatch.setattr(bs, "SEEDS", [0, 2])
    assert bs.main(["--device", "cpu", "--shards", "2"]) == 0
    monkeypatch.setattr(rs, "SEEDS", range(3, 4))
    assert rs.main([], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("seed  0 [plain /plain ]: 18 completions "
                             "identical")
    assert out[1].startswith("seed  2 [crash /plain ]:")
    assert out[2].startswith("batched smoke OK: 2 seeds,")
    assert ", 2 shards," in out[2]
    assert out[3].startswith("seed  3 [aboard/plain ]:")
    assert ", epoch 5, " in out[3]
    assert out[4].startswith("reconfig smoke OK: 1 seeds,")


def test_open_loop_main_runs_the_batched_subset(capsys):
    assert ol.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 21
    batched = [int(line.split()[1]) for line in out[:-1]
               if "+batched" in line]
    assert batched == sorted(ol.BATCHED_SEEDS)
    assert out[-1].startswith("open-loop smoke OK: 20 seeds,")


def test_open_loop_check_seed_holds_any_seed_batched(capsys):
    """``check_seed`` (what ``chip_smoke.py`` runs on every seed) on a
    seed outside ``BATCHED_SEEDS``."""
    seed = 3
    assert seed not in ol.BATCHED_SEEDS
    res, rec, n_fault = ol.check_seed(seed, torch.device("cpu"), True)
    ol.reconcile_paths(rec, res.cluster, seed)
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith("seed  3 [storm/") and "+batched" in line
    assert n_fault > 0


def test_inject_failure_is_caught_dumped_and_reported(tmp_path, capsys):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_batched_smoke.py"),
         "--device", "cpu", "--inject-failure", "--dump-dir",
         str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode != 0
    assert "SafetyViolation" in proc.stderr
    assert "batched smoke OK" not in proc.stdout
    dump = tmp_path / "batched_seed000.jsonl"
    assert dump.is_file()
    assert (tmp_path / "batched_seed000.trace.json").is_file()
    assert tr.main([str(dump)]) == 0
    text = capsys.readouterr().out
    assert "dumped because: seed 0: SafetyViolation" in text
    assert "path mix (18 completions)" in text
    assert tr.main(["--json", str(dump)]) == 0
    assert '"device": "cpu"' in capsys.readouterr().out


@pytest.mark.parametrize("mod", [bs, rs, ol], ids=lambda m: m.__name__)
def test_main_without_device_fails_loudly(mod):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device resolves to it")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])
