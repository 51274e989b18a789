#!/usr/bin/env python
"""Reconfiguration smoke of the PyTorch/CUDA port: the live-membership
gate's 20 storms, on the card.

The port's counterpart of ``scripts/reconfig_smoke.py``, with the same
seeds and storms: a 3 -> 4 -> 5 -> 4 -> 5 -> 4 membership trajectory
driven through the CP-decided config register, with the client workload
still in flight, a crash + restart and a network partition deliberately
overlapping the view changes.  Each storm runs once on the port's scalar
cluster and once on ``Cluster(machine_cls=partial(BatchedMachine,
device=..., shards=...))``, asserting

* completions are identical, machine for machine, tag for tag, value for
  value (view installs, epoch fencing and snapshot catch-up included),
* every storm ends at epoch 5 with 4 members, and
* every safety checker in :mod:`repro_torch.core.checkers`, the view
  transitions' included, is green on both clusters.

On a CUDA device every storm's fused waves run the CUDA select networks
(``paxos_apply``, ``paxos_propose``); each seed's line prints their
launches, and a storm on the card that launches either of them no time is
a failure.  On the CPU the wrappers run their plain PyTorch versions.

    PYTHONPATH=src python scripts/torch_reconfig_smoke.py               # card
    PYTHONPATH=src python scripts/torch_reconfig_smoke.py --device cpu
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

from repro_torch.core import checkers
from repro_torch.core.node import Machine, ProtocolConfig
from repro_torch.core.sim import Cluster, NetConfig, completion_tuples, \
    workload
from repro_torch.device import resolve_device
from repro_torch.serve.paxos import BatchedMachine, require_launches, \
    select_launches

SEEDS = range(20)
ABOARD_SEEDS = frozenset((3, 9, 15))
# the storms that the reference drives through its Pallas kernels in
# interpret mode; the port runs every storm through its kernels on the card
KERNEL_SEEDS = frozenset((2, 9, 14, 18))


def batched_cls(device, shards: int = 1):
    return functools.partial(BatchedMachine, device=device, shards=shards)


def storm(machine_cls, seed: int) -> Cluster:
    """One seeded storm; the script is identical for both machine classes
    so the completion histories are directly comparable."""
    cfg = ProtocolConfig(n_machines=3, sessions_per_machine=2,
                         reconfig=True, all_aboard=seed in ABOARD_SEEDS)
    net = NetConfig(seed=seed, drop_prob=0.06, dup_prob=0.05,
                    heavy_tail_prob=0.03, heavy_tail_extra=25.0)
    cl = Cluster(cfg, net, machine_cls=machine_cls)

    # phase 1: load the register bank, leave the ops genuinely in flight
    workload(cl, n_ops=14, keys=3, seed=seed, rmw_frac=0.5,
             write_frac=0.3, key_base=1)
    cl.step(150)

    # phase 2: grow 3 -> 4 -> 5 with a partition overlapping the changes
    cl.network.partition([2], [0])         # minority link cut, quorums live
    cl.join()                              # epoch 1: members (0,1,2,3)
    cl.join()                              # epoch 2: members (0,1,2,3,4)
    cl.network.heal()

    # phase 3: more load on the grown view, then shrink with a crash
    # overlapping the view change
    workload(cl, n_ops=10, keys=3, seed=seed + 1, rmw_frac=0.5,
             write_frac=0.2, key_base=1, mids=cl.active_view.members)
    cl.crash(2)
    cl.leave(1)                            # epoch 3: members (0,2,3,4)
    cl.restart(2)

    # phase 4: rejoin the leaver, then retire another member
    mid = cl.join(1)                       # epoch 4: members (0,1,2,3,4)
    assert mid == 1
    workload(cl, n_ops=8, keys=3, seed=seed + 2, rmw_frac=0.6,
             write_frac=0.2, key_base=1, mids=cl.active_view.members)
    cl.leave(4)                            # epoch 5: members (0,1,2,3)

    if not cl.run_until_quiet(max_ticks=120_000):
        raise RuntimeError(f"seed {seed}: cluster did not quiesce")
    st = cl.stats()
    if st["view_epoch"] != 5 or st["view_members"] != 4:
        raise RuntimeError(
            f"seed {seed}: storm ended at epoch {st['view_epoch']} with "
            f"{st['view_members']} members (want epoch 5, 4 members)")
    return cl


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--shards", type=int, default=1,
                    help="state-plane shard count for the batched cluster "
                         "(>1 drives view installs / snapshot catch-up "
                         "through per-shard plane rows)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device if device is None else device)
    impl = "cuda" if dev.type == "cuda" else "plain"
    t0 = time.time()
    total_ops = 0
    for seed in SEEDS:
        scalar = storm(Machine, seed)
        before = select_launches()
        batched = storm(batched_cls(dev, args.shards), seed)
        launched = select_launches() - before
        want, got = completion_tuples(scalar), completion_tuples(batched)
        if want != got:
            print(f"seed {seed}: batched completions diverged "
                  f"({len(got)} vs {len(want)})", file=sys.stderr)
            for a, b in zip(want, got):
                if a != b:
                    print(f"  first diff:\n   scalar  {a}\n   batched {b}",
                          file=sys.stderr)
                    break
            return 1
        checkers.check_all(scalar)
        checkers.check_all(batched)
        require_launches(launched, dev)
        counted = (f", launches apply {launched['paxos_apply']} "
                   f"propose {launched['paxos_propose']}"
                   if impl == "cuda" else "")
        total_ops += len(batched.history)
        st = batched.stats()
        mode = "aboard" if seed in ABOARD_SEEDS else "plain"
        print(f"seed {seed:2d} [{mode:6s}/{impl:6s}]: {len(got):2d} "
              f"completions identical, epoch {st['view_epoch']}, "
              f"{st['net_removed_dst']} fenced sends, checkers green"
              f"{counted}")
    sharded = f", {args.shards} shards" if args.shards > 1 else ""
    print(f"reconfig smoke OK: {len(list(SEEDS))} seeds, {total_ops} client "
          f"ops through 5 view changes each{sharded}, completion-identical "
          f"to scalar, view-transition + linearizability checkers green "
          f"({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
