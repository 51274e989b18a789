#!/usr/bin/env python
"""Batched-cluster smoke of the PyTorch/CUDA port: the serve path's
20-seed fault matrix, on the card.

The port's counterpart of ``scripts/batched_smoke.py``, with the same
seeds, workloads and faults: drops, duplicates, heavy-tail delays,
all-aboard deployments, crash/restart (including a crash with messages
in flight mid-batch).  Each seed runs once on the port's scalar cluster
and once on ``Cluster(machine_cls=partial(BatchedMachine, device=...,
shards=...))``, asserting

* completions are identical, machine for machine, tag for tag, value for
  value,
* every safety checker in :mod:`repro_torch.core.checkers` is green on
  the batched cluster, and
* the flight recorder's per-path counters reconcile exactly with the
  batched cluster's completion history.

On a CUDA device every seed's fused waves run the CUDA select networks
(``paxos_apply``, ``paxos_propose``); each seed's line prints their
launches, and a seed on the card that launches either of them no time is
a failure.  On the CPU the same wrappers run their plain PyTorch versions
(the implementation is printed as ``cuda`` or ``plain``).

On any failure the seed's flight recorder dumps into ``--dump-dir``
(JSONL + Chrome trace; summarise with ``scripts/torch_trace_report.py``).
``--inject-failure`` corrupts one replicated commit record on the first
seed to demonstrate the postmortem path end to end.

    PYTHONPATH=src python scripts/torch_batched_smoke.py                # card
    PYTHONPATH=src python scripts/torch_batched_smoke.py --device cpu
    PYTHONPATH=src python scripts/torch_batched_smoke.py --shards 4
"""

from __future__ import annotations

import argparse
import functools
import pathlib
import sys
import time
from collections import Counter

from repro_torch.core import checkers
from repro_torch.core.node import Machine, ProtocolConfig
from repro_torch.core.sim import Cluster, NetConfig, completion_tuples, \
    workload
from repro_torch.device import resolve_device
from repro_torch.obs import FlightRecorder, flight_guard
from repro_torch.serve.paxos import BatchedMachine, require_launches, \
    select_launches

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEEDS = range(20)
ABOARD_SEEDS = frozenset((1, 3, 7, 11, 15, 19))
CRASH_SEEDS = frozenset((2, 5, 9, 13, 17))
# the third of the storm that the reference drives through its Pallas
# kernels in interpret mode; the port runs every seed through its kernels
# on the card, and chip_smoke.py runs these again at 4 shards
KERNEL_SEEDS = frozenset((0, 3, 5, 8, 12, 16, 19))

# ReqKind name -> the flight-recorder paths its completions land in
KIND_TO_PATHS = {"RMW": ("all_aboard_fast", "cp_slow"),
                 "READ": ("abd_read",), "WRITE": ("abd_write",)}


def batched_cls(device, shards: int = 1):
    return functools.partial(BatchedMachine, device=device, shards=shards)


def run(machine_cls, seed: int, obs=None):
    cfg = ProtocolConfig(n_machines=5, sessions_per_machine=2,
                         all_aboard=seed in ABOARD_SEEDS)
    net = NetConfig(seed=seed, drop_prob=0.06, dup_prob=0.05,
                    heavy_tail_prob=0.03, heavy_tail_extra=25.0)
    cl = Cluster(cfg, net, machine_cls=machine_cls)
    if obs is not None:
        cl.attach_obs(obs)
    workload(cl, n_ops=18, keys=3, seed=seed, rmw_frac=0.45, write_frac=0.3)
    if seed in CRASH_SEEDS:
        cl.step(8)
        # deliver due traffic first so the crash lands with messages
        # in-flight ("crash mid-batch": the inbox dies with the machine)
        cl.network.deliver_due(cl.network.now + 1.0, cl.machines)
        cl.crash(4)
        cl.step(6)
        cl.restart(4)
    if not cl.run_until_quiet(max_ticks=120_000):
        raise RuntimeError(f"seed {seed}: cluster did not quiesce")
    return cl


def reconcile_paths(rec: FlightRecorder, cluster, seed: int) -> None:
    """Exact per-path reconciliation against the completion history."""
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


def inject_log_corruption(cluster) -> bool:
    """Corrupt one replicated commit record (--inject-failure demo)."""
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


def check_seed(seed: int, device, shards: int = 1,
               dump_dir=ROOT / "build" / "flight_dumps",
               inject_failure: bool = False) -> int:
    """One seed, scalar against batched on ``device``, with its checks;
    prints the seed's line and returns its client ops.  A failure dumps
    the seed's flight recorder into ``dump_dir`` and raises."""
    impl = "cuda" if device.type == "cuda" else "plain"
    rec = FlightRecorder(
        mode="sampled",
        meta={"seed": seed, "spec": "torch_batched_smoke",
              "shards": shards, "device": str(device)})
    with flight_guard(rec, str(dump_dir), label=f"seed {seed}",
                      stem=f"batched_seed{seed:03d}"):
        scalar = run(Machine, seed)
        before = select_launches()
        batched = run(batched_cls(device, shards), seed, obs=rec)
        launched = select_launches() - before
        want, got = completion_tuples(scalar), completion_tuples(batched)
        if want != got:
            for a, b in zip(want, got):
                if a != b:
                    print(f"  first diff:\n   scalar  {a}\n"
                          f"   batched {b}", file=sys.stderr)
                    break
            raise AssertionError(
                f"seed {seed}: batched completions diverged "
                f"({len(got)} vs {len(want)})")
        if inject_failure and not inject_log_corruption(batched):
            raise RuntimeError("--inject-failure found no replicated "
                               "record to corrupt")
        checkers.check_all(batched)
        reconcile_paths(rec, batched, seed)
        require_launches(launched, device)
    counted = (f", launches apply {launched['paxos_apply']} propose "
               f"{launched['paxos_propose']}" if impl == "cuda" else "")
    mode = ("aboard" if seed in ABOARD_SEEDS
            else "crash" if seed in CRASH_SEEDS else "plain")
    print(f"seed {seed:2d} [{mode:6s}/{impl:6s}]: {len(got):2d} "
          f"completions identical, checkers green, paths reconcile"
          f"{counted}")
    return len(batched.history)


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--shards", type=int, default=1,
                    help="state-plane shard count for the batched cluster "
                         "(>1 exercises the sharded lane layout)")
    ap.add_argument("--dump-dir",
                    default=str(ROOT / "build" / "flight_dumps"),
                    help="where failing seeds drop their flight-recorder "
                         "dumps")
    ap.add_argument("--inject-failure", action="store_true",
                    help="corrupt one replicated commit record on the "
                         "first seed: demonstrates the checker-failure "
                         "-> dump -> torch_trace_report postmortem path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device if device is None else device)
    t0 = time.time()
    total_ops = sum(
        check_seed(seed, dev, args.shards, args.dump_dir,
                   inject_failure=args.inject_failure and seed == SEEDS[0])
        for seed in SEEDS)
    sharded = f", {args.shards} shards" if args.shards > 1 else ""
    print(f"batched smoke OK: {len(SEEDS)} seeds, {total_ops} client "
          f"ops{sharded}, completion-identical to scalar, linearizability "
          f"green, path counters reconcile ({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
