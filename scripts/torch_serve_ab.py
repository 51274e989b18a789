#!/usr/bin/env python3
"""Serve wall time of two trees of the PyTorch/CUDA port, in turns on one
card.

Runs the full-width seeded serve run of ``chip_smoke.py``'s serve phase
(``Cluster(machine_cls=BatchedMachine)`` at 5 replicas x 800 sessions x
2^20 key lanes, the kv_mixed 10/20/70 mix, batched-smoke network faults;
seed 0 plain, seed 1 all-aboard with machine 4 crashed and restarted) for
the ``src/`` of a base tree and of this tree, each run in a fresh process,
in the order base, this, this, base per round, and prints every run's
wall times and the medians as one JSON line::

    python3 scripts/torch_serve_ab.py --base build/parent/src --rounds 2

A run builds the kernels and initialises the card before its timed
region; the timed region is what ``chip_smoke.py`` times (cluster set-up
to quiescence, ending in a synchronise).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
M, SESSIONS, KEYS = 5, 800, 2 ** 20
SEEDS = ((0, False, False), (1, True, True))


def one_run(n_ops: int) -> dict:
    """The serve run of both seeds in this process, on the ``repro_torch``
    that ``sys.path`` finds first."""
    import functools

    import torch

    from repro_torch.core.node import ProtocolConfig
    from repro_torch.core.sim import Cluster, NetConfig, \
        completion_tuples, workload
    from repro_torch.kernels import _build
    from repro_torch.serve.paxos import BatchedMachine

    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_ab.py: no CUDA card")
    _build.build()
    torch.zeros(1, device="cuda")
    machine = functools.partial(BatchedMachine, device="cuda")
    walls = {}
    for seed, aboard, crash in SEEDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cl = Cluster(ProtocolConfig(n_machines=M,
                                    sessions_per_machine=SESSIONS,
                                    all_aboard=aboard),
                     NetConfig(seed=seed, drop_prob=0.06, dup_prob=0.05,
                               heavy_tail_prob=0.03, heavy_tail_extra=25.0),
                     machine_cls=machine)
        workload(cl, n_ops=n_ops, keys=KEYS, seed=seed, rmw_frac=0.1,
                 write_frac=0.2)
        if crash:
            cl.step(8)
            cl.network.deliver_due(cl.network.now + 1.0, cl.machines)
            cl.crash(4)
            cl.step(6)
            cl.restart(4)
        if not cl.run_until_quiet(max_ticks=120_000):
            raise SystemExit(f"seed {seed}: the cluster did not quiesce")
        torch.cuda.synchronize()
        walls[f"seed{seed}_s"] = time.perf_counter() - t0
        walls[f"seed{seed}_completions"] = len(completion_tuples(cl))
    return walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=pathlib.Path,
                    help="the src/ directory of the tree to compare with")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of base, this, this, base")
    ap.add_argument("--n-ops", type=int, default=4000)
    ap.add_argument("--one", type=pathlib.Path,
                    help="run once on this src/ and print its JSON line")
    args = ap.parse_args(argv)
    if args.one is not None:
        sys.path.insert(0, str(args.one.resolve()))
        print(json.dumps(one_run(args.n_ops)), flush=True)
        return 0
    if args.base is None:
        ap.error("--base is required")
    trees = {"base": args.base.resolve(), "this": ROOT / "src"}
    runs = {"base": [], "this": []}
    for _ in range(args.rounds):
        for name in ("base", "this", "this", "base"):
            out = subprocess.run(
                [sys.executable, __file__, "--one", str(trees[name]),
                 "--n-ops", str(args.n_ops)],
                capture_output=True, text=True, timeout=1200)
            if out.returncode != 0:
                raise SystemExit(f"{name} run failed ({out.returncode}):\n"
                                 f"{out.stderr[-4000:]}")
            run = json.loads(out.stdout.strip().splitlines()[-1])
            runs[name].append(run)
            print(f"[ab] {name}: {json.dumps(run)}", flush=True)
    summary = {name: {k: statistics.median(r[k] for r in rs)
                      for k in rs[0] if k.endswith("_s")}
               for name, rs in runs.items()}
    print(json.dumps({"runs": runs, "medians": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
