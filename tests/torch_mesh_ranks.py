"""Rank bodies of the port's sharded serve path and multi-rank MoE
gradients, for ``tests/torch_ranks.py``'s ``run_ranks`` (imports no JAX).

:data:`WORKLOADS` and :func:`run_workload` are shared with the reference's
side, ``tests/torch_serve_mesh_ref.py``, which drives the same clusters
through the JAX package.  A rank returns tensors, numbers and strings
only (``torch.load`` reads them back with ``weights_only``).
"""

from __future__ import annotations

import enum
import functools
import hashlib
import json
import numbers

import numpy as np
import torch
import torch.distributed as dist

# name -> (cluster config, workload arguments, crash/restart machine);
# "t124" is tests/test_cluster_engine.py's workload (2 sessions: the
# table replicates at 4 shards), "t124s4" the same at 4 sessions (the
# table shards), "crash" grows the KV lanes 8 -> 16 (block boundaries
# move) and crashes and restarts machine 2
WORKLOADS = {
    "t124": (dict(n_machines=3, sessions_per_machine=2),
             dict(n_ops=24, keys=4, seed=11, rmw_frac=0.5, write_frac=0.3),
             None),
    "t124s4": (dict(n_machines=3, sessions_per_machine=4),
               dict(n_ops=24, keys=4, seed=11, rmw_frac=0.5,
                    write_frac=0.3), None),
    "crash": (dict(n_machines=3, sessions_per_machine=4, all_aboard=True),
              dict(n_ops=40, keys=16, seed=5, rmw_frac=0.4, write_frac=0.3),
              2),
}


def run_workload(sim, config_cls, name, machine_cls):
    """Workload ``name`` on a cluster of ``machine_cls`` built from the
    package whose ``core.sim`` module and ``ProtocolConfig`` are given."""
    cfg, load, crash = WORKLOADS[name]
    cl = sim.Cluster(config_cls(**cfg), sim.NetConfig(seed=load["seed"]),
                     machine_cls=machine_cls)
    sim.workload(cl, **load)
    if crash is not None:
        cl.step(8)
        cl.crash(crash)
        cl.step(6)
        cl.restart(crash)
    if not cl.run_until_quiet(max_ticks=50_000):
        raise RuntimeError(f"{name}: the cluster did not quiesce")
    return cl


def plain(v):
    """A completion tuple's field in a form both packages share (enums by
    name, named tuples as lists, integers as ints, anything else by its
    ``repr``, so no field is coerced into agreeing)."""
    if isinstance(v, enum.Enum):
        return v.name
    if isinstance(v, tuple):
        return [plain(x) for x in v]
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, numbers.Integral):
        return int(v)
    return repr(v)


def completions_json(tuples) -> str:
    """``completion_tuples`` of either package as JSON, field by field."""
    return json.dumps([plain(t) for t in tuples])


def mirror_digest(*arrays) -> str:
    """SHA-256 of host plane mirrors."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def serve_rank(rank, world, names):
    """Each workload of ``names`` on ``BatchedMachine(shards=world)`` on
    the CPU inside this rank's group: completions, host mirrors, device
    blocks, block bounds, specs and the engine's telemetry; then the
    group's bookkeeping (``dist.new_group`` calls, a wrong world size)."""
    from repro_torch.core import checkers, sim
    from repro_torch.core.node import ProtocolConfig
    from repro_torch.serve.paxos import BatchedMachine
    from repro_torch.serve.paxos import cluster_engine as ce

    made = []
    new_group = dist.new_group

    def counted(*args, **kw):
        made.append(kw.get("backend"))
        return new_group(*args, **kw)

    dist.new_group = counted
    try:
        out = {}
        for name in names:
            cl = run_workload(sim, ProtocolConfig, name, functools.partial(
                BatchedMachine, shards=world, device="cpu"))
            checkers.check_all(cl)
            eng = cl.engine
            got = sim.completion_tuples(cl)
            res = {"completions": completions_json(got),
                   "mesh": (eng.mesh.rank, eng.mesh.world),
                   "telemetry": eng.telemetry()}
            for tag in ("kv", "tab"):
                st = getattr(eng, tag)
                res[tag] = torch.from_numpy(st.host.copy())
                res[f"{tag}_dev"] = st.dev.clone()
                res[f"{tag}_block"] = (st.block.start, st.block.stop)
                res[f"{tag}_spec"] = list(st.device_sharding().spec)
            res["mirror_digest"] = mirror_digest(eng.kv.host, eng.tab.host)
            out[name] = res
        try:
            ce.ClusterEngine(ProtocolConfig(n_machines=3,
                                            sessions_per_machine=2),
                             3, shards=2 * world, device="cpu")
        except ValueError as exc:
            out["wrong_world"] = str(exc)
        out["unsharded_is_none"] = ce._shard_mesh(1) is None
    finally:
        dist.new_group = new_group
    out["new_groups"] = made
    return out


def moe_grad_rank(rank, world, case_path):
    """Gradients of the sum of this rank's block of the shard_map MoE's
    output (``"y"``) and of its aux (``"aux"``), for each mesh of
    ``case["meshes"]`` and strategy: x, the router, the norm's scale and
    the whole expert tensors (nonzero only on the rank's slices); and the
    rank's aux."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import blocks
    from repro_torch.models.config import ModelConfig

    case = torch.load(case_path)
    out = {}
    for shape in case["meshes"]:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        for strategy in ("ep", "tp"):
            cfg = ModelConfig(**dict(case["cfg"], moe_strategy=strategy,
                                     moe_impl="shardmap"))
            p = {k: v.clone().requires_grad_(True)
                 for k, v in case["params"].items() if k != "norm"}
            p["norm"] = {"scale": case["params"]["norm"]["scale"].clone()
                         .requires_grad_(True)}
            x = case["x"].clone().requires_grad_(True)
            y, aux = blocks.apply_moe_shardmap(cfg, p, x, mesh)
            leaves = {"x": x, "router": p["router"],
                      "norm_scale": p["norm"]["scale"],
                      **{k: p[k] for k in ("w_gate", "w_up", "w_down")}}
            ins = list(leaves.values())
            gy = torch.autograd.grad(y.sum(), ins, retain_graph=True)
            ga = torch.autograd.grad(aux, ins, allow_unused=True)
            ga = [torch.zeros_like(t) if g is None else g
                  for g, t in zip(ga, ins)]
            out[f"{shape[0]}x{shape[1]}/{strategy}"] = {
                "coord": tuple(mesh.get_coordinate()),
                "aux": aux.detach(),
                "grads": {"y": dict(zip(leaves, gy)),
                          "aux": dict(zip(leaves, ga))}}
    return out
