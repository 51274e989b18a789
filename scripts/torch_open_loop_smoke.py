#!/usr/bin/env python
"""Open-loop harness smoke of the PyTorch/CUDA port: 20 seeded faulty
workloads, with the batched ones on the card.

The port's counterpart of ``scripts/open_loop_smoke.py``, with the same
specs and fault plans.  Every seed drives
:class:`repro_torch.serve.loadgen.OpenLoopHarness` (Poisson open-loop
arrivals, Zipf key skew, a §2-style op mix) through a fault plan
(crash/restart on some seeds, a partition on others, both on a few) on
the port's scalar cluster, asserting quiescence and every safety checker
in :mod:`repro_torch.core.checkers` green, linearizability included.

The ``BATCHED_SEEDS`` subset (``check_seed`` takes any seed batched)
additionally runs the identical spec through
``Cluster(machine_cls=partial(BatchedMachine, device=...))`` and asserts
the batched run is completion for completion identical to the scalar
one.  On a CUDA device the batched run's fused waves run the CUDA select
networks (``paxos_apply``, ``paxos_propose``); its line prints their
launches, and a batched run on the card that launches either of them no
time is a failure.  On the CPU the wrappers run their plain versions.

Every seed's scalar run carries a
:class:`repro_torch.obs.FlightRecorder`: per-path completion counters are
reconciled exactly against the history, and any failure (quiescence,
divergence, checker) dumps the recorder into ``--dump-dir`` for
``scripts/torch_trace_report.py``.  ``--dump`` also writes the first
seed's dump on success.

    PYTHONPATH=src python scripts/torch_open_loop_smoke.py              # card
    PYTHONPATH=src python scripts/torch_open_loop_smoke.py --device cpu
"""

from __future__ import annotations

import argparse
import functools
import pathlib
import sys
import time
from collections import Counter

from repro_torch.core.sim import completion_tuples
from repro_torch.device import resolve_device
from repro_torch.obs import FlightRecorder, dump_all, flight_guard
from repro_torch.serve.loadgen import (
    ArrivalPhase, FaultPlan, MIXES, OpenLoopHarness, OpenLoopSpec,
)
from repro_torch.serve.paxos import BatchedMachine, require_launches, \
    select_launches

ROOT = pathlib.Path(__file__).resolve().parents[1]
KIND_TO_PATHS = {"RMW": ("all_aboard_fast", "cp_slow"),
                 "READ": ("abd_read",), "WRITE": ("abd_write",)}

SEEDS = range(20)
CRASH_SEEDS = frozenset((1, 4, 7, 10, 13, 16, 19))
PARTITION_SEEDS = frozenset((2, 5, 8, 11, 14, 17))
# both faults overlapping the same run
STORM_SEEDS = frozenset((3, 9, 15))
# differential subset: same spec through the batched serve path,
# completion-identical to the scalar run (chip_smoke.py runs every seed)
BATCHED_SEEDS = frozenset((0, 7, 14))
MIX_ROTATION = tuple(MIXES)


def spec_for(seed: int) -> OpenLoopSpec:
    mix = MIXES[MIX_ROTATION[seed % len(MIX_ROTATION)]]
    return OpenLoopSpec(
        seed=seed, n_machines=5, sessions=2, n_keys=48,
        zipf_s=0.8 + 0.05 * (seed % 5), mix=mix,
        phases=(ArrivalPhase(rate=0.25, ticks=160),),
        drop_prob=0.02, dup_prob=0.02)


def faults_for(seed: int) -> FaultPlan:
    plan = FaultPlan(settle=30.0)
    if seed in CRASH_SEEDS or seed in STORM_SEEDS:
        plan.crash_restart(seed % 5, at=40.0, down_for=25.0)
    if seed in PARTITION_SEEDS or seed in STORM_SEEDS:
        plan.partition(90.0, 120.0, (0, 1, 2), (3, 4))
    return plan


def reconcile_paths(rec: FlightRecorder, cluster, seed: int) -> None:
    """Exact per-path reconciliation against the completion history
    (ops killed by a crash abort — never path-counted — so the counters
    equal the completions even on faulty seeds)."""
    kinds = Counter(h["kind"].name for h in cluster.history)
    paths = rec.path_counts()
    for kind, names in KIND_TO_PATHS.items():
        got = sum(paths[p] for p in names)
        if got != kinds.get(kind, 0):
            raise AssertionError(
                f"seed {seed}: {kind} path counters ({got}) do not "
                f"reconcile with {kinds.get(kind, 0)} completions")
    if sum(paths.values()) != len(cluster.history):
        raise AssertionError(
            f"seed {seed}: total path count {sum(paths.values())} != "
            f"{len(cluster.history)} completions")


def run_batched(seed: int, device):
    """The seed's spec and fault plan through the batched cluster on
    ``device``: ``(result, launches)``."""
    before = select_launches()
    res = OpenLoopHarness(spec_for(seed),
                          machine_cls=functools.partial(BatchedMachine,
                                                        device=device),
                          faults=faults_for(seed)).run()
    return res, select_launches() - before


def check_seed(seed: int, device, batched: bool,
               dump_dir=ROOT / "build" / "flight_dumps"):
    """One seed's open-loop run on the scalar cluster with its checks,
    and with ``batched`` the same run on ``device``'s batched cluster held
    to it; prints the seed's line and returns ``(result, rec, ops in
    fault windows)``.  A failure dumps the flight recorder into
    ``dump_dir`` and raises."""
    spec, faults = spec_for(seed), faults_for(seed)
    rec = FlightRecorder(mode="sampled",
                         meta={"seed": seed, "spec": "torch_open_loop_smoke",
                               "mix": spec.mix.name})
    counted = ""
    with flight_guard(rec, str(dump_dir), label=f"seed {seed}",
                      stem=f"open_loop_seed{seed:03d}"):
        res = OpenLoopHarness(spec, faults=faults,
                              obs=rec).run()  # check=True:
        # checkers (linearizability included) ran on the final history
        reconcile_paths(rec, res.cluster, seed)
        if batched:
            bat, launched = run_batched(seed, device)
            want = completion_tuples(res.cluster)
            got = completion_tuples(bat.cluster)
            if want != got:
                raise AssertionError(
                    f"seed {seed}: batched open-loop run diverged "
                    f"({len(got)} vs {len(want)} completions)")
            require_launches(launched, device)
            if device.type == "cuda":
                counted = (f", launches apply {launched['paxos_apply']} "
                           f"propose {launched['paxos_propose']}")
    report = res.recorder.report()
    n_fault = sum(s["count"] for s in report["fault"].values() if s)
    mode = ("storm" if seed in STORM_SEEDS
            else "crash" if seed in CRASH_SEEDS
            else "part" if seed in PARTITION_SEEDS else "plain")
    diff = "+batched" if batched else ""
    print(f"seed {seed:2d} [{mode:5s}/{spec.mix.name:12s}]{diff:9s}: "
          f"{res.completed:3d} done ({n_fault:3d} in fault windows), "
          f"{res.lost} lost, checkers green, paths reconcile{counted}")
    return res, rec, n_fault


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--dump-dir",
                    default=str(ROOT / "build" / "flight_dumps"),
                    help="where failing seeds drop their flight-recorder "
                         "dumps")
    ap.add_argument("--dump", action="store_true",
                    help="also dump the first seed's recorder on success")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device if device is None else device)
    t0 = time.time()
    total = fault_total = 0
    for seed in SEEDS:
        res, rec, n_fault = check_seed(seed, dev, seed in BATCHED_SEEDS,
                                       args.dump_dir)
        total += res.completed
        fault_total += n_fault
        if args.dump and seed == min(SEEDS):
            paths = dump_all(rec, args.dump_dir, reason="smoke sample",
                             stem=f"open_loop_seed{seed:03d}")
            print(f"seed {seed:2d} dump: {paths['jsonl']}")
    print(f"open-loop smoke OK: {len(list(SEEDS))} seeds, {total} client "
          f"ops ({fault_total} through fault windows), linearizability "
          f"green, path counters reconcile ({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
