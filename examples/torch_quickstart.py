"""Quickstart of the PyTorch/CUDA port: the paper's replicated RMW
register, served on the card.

The port's counterpart of ``examples/quickstart.py``.  Creates a
5-replica register (All-aboard enabled) whose replicas run the batched
serve path (``BatchedMachine``: the ``paxos_apply`` and ``paxos_propose``
kernels on a CUDA device, their plain versions on the CPU), runs CAS /
FAA / writes / reads through it, crashes a minority mid-flight, and
shows everything still completes with linearizable results.

    PYTHONPATH=src python examples/torch_quickstart.py                # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import functools
import sys

from repro_torch.coord.registry import PaxosRegistry
from repro_torch.core import checkers
from repro_torch.device import resolve_device
from repro_torch.serve.paxos import BatchedMachine


def run(device) -> PaxosRegistry:
    """The quickstart's ops on a registry served on ``device``; returns
    the registry (its cluster holds the history)."""
    reg = PaxosRegistry(n_machines=5, all_aboard=True,
                        machine_cls=functools.partial(BatchedMachine,
                                                      device=device))

    # consensus RMWs (exactly-once, helped if our replica stalls)
    assert reg.faa("counter") == 0          # fetch-and-add returns pre-value
    assert reg.faa("counter") == 1
    won, prev = reg.cas("leader-ish", 0, 42)
    print(f"CAS won={won} prev={prev}")

    # ABD fast paths (no consensus needed: ~25x cheaper reads in the paper)
    reg.write("config", 7)
    print("config =", reg.read("config"))

    # crash TWO replicas: a 3/5 majority keeps serving with zero
    # leader-election downtime (the paper's availability claim)
    reg.crash(3)
    reg.crash(4)
    assert reg.faa("counter") == 2
    reg.write("config", 8)
    print("after 2 crashes: counter ->", reg.fetch("counter"),
          " config ->", reg.read("config"))

    # every safety property of §7 holds on the full history
    checkers.check_all(reg.cluster)
    print("linearizability + exactly-once verified over",
          len(reg.cluster.history), "ops")
    return reg


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    run(resolve_device(args.device if device is None else device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
