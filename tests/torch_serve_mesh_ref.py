"""The reference's side of ``tests/test_torch_serve_mesh.py``, as a file.

Run as a fresh process: the forced host device count must precede the
first ``jax`` import::

    PYTHONPATH=src python tests/torch_serve_mesh_ref.py OUT.npz

With 4 XLA host devices the reference's engine places its plane stacks on
a ``"shard"`` mesh whenever ``shards`` > 1 (``_shard_mesh``).  For each
workload of ``tests/torch_mesh_ranks.py``'s ``WORKLOADS`` this runs the
scalar cluster, and the batched cluster (``BatchedMachine(shards=S)``,
the plain jitted steps) at each S of ``SHARDS``, and writes, keyed
``{workload}/...``: the completions as JSON, field by field (the scalar
run's and each S's), and for each S the mesh's shape, each stack's
``device_sharding`` spec, the host KV and proposer planes after the run,
and the engine's lane counters.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import functools                                               # noqa: E402
import json                                                    # noqa: E402

import numpy as np                                             # noqa: E402

from repro.core import sim                                     # noqa: E402
from repro.core.node import Machine, ProtocolConfig            # noqa: E402
from repro.core.sim import completion_tuples                   # noqa: E402
from repro.serve.paxos import BatchedMachine                   # noqa: E402
from torch_mesh_ranks import (                                 # noqa: E402
    WORKLOADS, completions_json, run_workload)

SHARDS = (2, 4)


def run(name, machine_cls):
    return run_workload(sim, ProtocolConfig, name, machine_cls)


def main(out_path: str) -> None:
    out = {}
    for name in WORKLOADS:
        out[f"{name}/scalar/completions"] = completions_json(
            completion_tuples(run(name, Machine)))
        for s in SHARDS:
            cl = run(name, functools.partial(BatchedMachine, shards=s))
            eng = cl.engine
            tag = f"{name}/{s}"
            out[f"{tag}/completions"] = completions_json(
                completion_tuples(cl))
            out[f"{tag}/mesh"] = json.dumps(dict(eng.mesh.shape))
            for stack in ("kv", "tab"):
                st = getattr(eng, stack)
                st.pull()
                out[f"{tag}/{stack}"] = st.host.copy()
                out[f"{tag}/{stack}_spec"] = json.dumps(
                    list(st.device_sharding().spec))
            out[f"{tag}/stats"] = json.dumps(
                {k: eng.stats[k] for k in (
                    "fused_receiver_calls", "fused_receiver_lanes",
                    "fused_issuer_calls", "fused_issuer_lanes",
                    "receiver_shard_lanes", "issuer_shard_lanes")})
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
