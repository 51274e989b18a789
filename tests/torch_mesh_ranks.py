"""Rank bodies of the port's sharded serve path, multi-rank MoE
gradients, sharded train step, sharded decode cell, the recurrent, MoE
and encoder-decoder families' cells and train steps and the collective
counter, for ``tests/torch_ranks.py``'s ``run_ranks`` (imports no JAX),
and :func:`blockwise`, the shard_map MoE's routing in one process.

:data:`WORKLOADS` and :func:`run_workload` are shared with the reference's
side, ``tests/torch_serve_mesh_ref.py``, which drives the same clusters
through the JAX package.  A rank returns tensors, numbers and strings
only (``torch.load`` reads them back with ``weights_only``).
"""

from __future__ import annotations

import contextlib
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


def _full(t):
    """A DTensor's whole value (a plain tensor as it is), detached."""
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()


def train_mesh_rank(rank, world, case_path):
    """For each (data, model) mesh of ``case["meshes"]``: a train cell of
    ``case["cfg"]`` placed by ``launch/steps.place_cell`` on the whole
    parameters ``case["params"]``; ``train_loss`` and its gradient at
    those parameters, then one step on each batch of ``case["tokens"]``
    with AdamW at ``case["opt"]`` (the step's collectives counted on the
    first), every parameter's and moment's layout, the q, k, v blocks the
    attention kernel was handed, and the prefill of the first batch placed
    the same way; on the first mesh also the steps at ``case["ref_opt"]``
    and one step at ``case["opt"]`` over two microbatches of the first
    batch.  Rank 0 keeps the whole gradients and parameters."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import steps
    from repro_torch.launch.collectives import CollectiveCounter
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import blocks
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.registry import build_model, input_specs
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import distribute
    from repro_torch.tree import leaves, tree_map

    case = torch.load(case_path)
    cfg = ModelConfig(**case["cfg"])
    model = build_model(cfg)
    tokens = case["tokens"]                       # [steps, B, S] int32
    b, s = tokens.shape[1:]
    cell = Shape("train", s, b, "train")

    def fresh():
        # the placed leaves may be the whole tensors themselves (a
        # replicated leaf), which the steps update in place
        return tree_map(torch.clone, case["params"])

    def run_steps(mesh, opt, res, count=False):
        fn, (p, o, _) = steps.place_cell(
            cfg, cell, mesh, {"tokens": tokens[0]}, params=fresh(),
            opt_cfg=adamw.AdamWConfig(**opt))
        b_shard = steps.batch_shardings(input_specs(cfg, cell), mesh)
        res["losses"], res["grad_norms"] = [], []
        for i in range(tokens.shape[0]):
            batch = distribute({"tokens": tokens[i]}, b_shard, mesh)
            if count and i == 0:
                with CollectiveCounter() as counter:
                    p, o, m = fn(p, o, batch)
                res["collectives"] = counter.result()
            else:
                p, o, m = fn(p, o, batch)
            res["losses"].append(_full(m["loss"]))
            res["grad_norms"].append(_full(m["grad_norm"]))
        # every rank gathers (a collective), rank 0 keeps
        whole = [_full(t) for t in leaves(p)]
        if rank == 0:
            res["params"] = whole
        return p, o

    out = {}
    for n, shape in enumerate(case["meshes"]):
        mesh = make_device_mesh(shape, "cpu")
        res = {"coord": tuple(mesh.get_coordinate())}
        blocks_seen = []
        kernel = blocks.flash_attention

        def recording(q, k, v, **kw):
            blocks_seen.append((tuple(q.shape), tuple(k.shape),
                                type(q).__name__))
            return kernel(q, k, v, **kw)

        _, (p, _, batch) = steps.place_cell(cfg, cell, mesh,
                                            {"tokens": tokens[0]},
                                            params=fresh())
        blocks.flash_attention = recording
        try:
            loss0, grads0 = steps._value_and_grad(model, p, batch, True)
        finally:
            blocks.flash_attention = kernel
        grads0 = [_full(g) for g in grads0]
        res.update(loss0=_full(loss0), blocks=list(blocks_seen))
        if rank == 0:
            res["grads0"] = grads0
        p, o = run_steps(mesh, case["opt"], res, count=True)
        res["step"] = _full(o.step)
        res["param_layout"] = [(tuple(t.to_local().shape), str(t.placements))
                               for t in leaves(p)]
        res["moments"] = [(tuple(t.to_local().shape), str(t.placements),
                           t.to_local().device.type, str(t.dtype))
                          for t in leaves(o.m) + leaves(o.v)]
        if n == 0:
            res["ref_run"] = {}
            run_steps(mesh, case["ref_opt"], res["ref_run"])
            fn, args = steps.place_cell(
                cfg, cell, mesh, {"tokens": tokens[0]}, params=fresh(),
                opt_cfg=adamw.AdamWConfig(**case["opt"]))
            p, _, m = steps.make_train_step(
                model, adamw.AdamWConfig(**case["opt"]),
                microbatches=2)(*args)
            whole = [_full(t) for t in leaves(p)]
            res["microbatched"] = {"loss": _full(m["loss"]),
                                   "grad_norm": _full(m["grad_norm"]),
                                   "params": whole if rank == 0 else None}
        pfn, pargs = steps.place_cell(
            cfg, Shape("prefill", s, b, "prefill"), mesh,
            {"tokens": tokens[0]}, params=fresh())
        with torch.no_grad():
            res["prefill"] = _full(pfn(*pargs))
        out[f"{shape[0]}x{shape[1]}"] = res
    return out


def _block_bounds(t):
    """(start, stop) a dim of this rank's block of DTensor ``t`` in the
    whole tensor (Shard and Replicate placements, mesh dims in order)."""
    coord = t.device_mesh.get_coordinate()
    start, size = [0] * t.dim(), list(t.shape)
    for mdim, pl in enumerate(t.placements):
        if pl.is_shard():
            size[pl.dim] //= t.device_mesh.size(mdim)
            start[pl.dim] += coord[mdim] * size[pl.dim]
    return tuple((a, a + n) for a, n in zip(start, size))


def _gathers_counter():
    """The collective counter that also keeps each all-gather's input
    shape (``.shapes``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.collectives import (
        CollectiveCounter, collective_kind,
    )

    class Gathers(CollectiveCounter):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if (not any(issubclass(t, DTensor) for t in types) and
                    collective_kind(func._schema.name) == "all-gather"):
                self.shapes.append(tuple(args[0].shape))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Gathers()


def decode_mesh_case(c, shape):
    """One decode case ``c`` (a config, whole parameters, a cache length
    ``seq``, tokens [B, T], prompts and a generation length; an
    encoder-decoder's ``cross`` caches, whole, for the teacher-forced
    steps) on a (data, model) mesh of ``shape``: the decode cell placed
    by ``launch/steps.place_cell``; every teacher-forced step's logits,
    whole; one step's collectives (``count_at``) with each all-gather's
    input shape; every cache leaf's block, bounds and placements after
    the steps; the parameters' layouts; then ``DecodeEngine.generate`` on
    the placed parameters."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.sharding import distribute
    from repro_torch.serve.engine import DecodeEngine, ServeConfig
    from repro_torch.tree import leaves

    cfg = ModelConfig(**c["cfg"])
    tokens = c["tokens"]
    b, steps_n = tokens.shape
    cell = Shape("decode", c["seq"], b, "decode")
    mesh = make_device_mesh(shape, "cpu")
    fn, (params, caches, _) = steps.place_cell(
        cfg, cell, mesh, {"tokens": tokens[:, :1]}, params=c["params"])
    if "cross" in c:
        caches["cross"] = distribute(c["cross"], steps.cache_shardings(
            build_model(cfg), mesh, b, c["seq"], seq_shard=b == 1)["cross"],
            mesh)
    res = {"coord": tuple(mesh.get_coordinate())}
    logits = []
    for t in range(steps_n):
        batch = {"tokens": steps.place_tokens(tokens[:, t:t + 1], mesh)}
        if t == c["count_at"]:
            with _gathers_counter() as counter:
                lg, caches = fn(params, caches, batch)
            res["collectives"] = counter.result()
            res["gathers"] = counter.shapes
        else:
            lg, caches = fn(params, caches, batch)
        logits.append(_full(lg))
    res["logits"] = torch.stack(logits)
    res["caches"] = [(_block_bounds(x), x.to_local().clone(),
                      str(x.placements)) for x in leaves(caches)]
    res["param_layout"] = [(tuple(x.to_local().shape), str(x.placements),
                            x.element_size()) for x in leaves(params)]
    engine = DecodeEngine(build_model(cfg), params,
                          ServeConfig(max_seq=c["seq"], batch=b),
                          device="cpu")
    res["generated"] = torch.from_numpy(engine.generate(c["prompts"],
                                                        c["gen"]))
    return res


def decode_mesh_rank(rank, world, case_path):
    """:func:`decode_mesh_case` for each case of ``case["cases"]`` and
    each (data, model) mesh of the case."""
    case = torch.load(case_path)
    return {f"{name}/{shape[0]}x{shape[1]}": decode_mesh_case(c, shape)
            for name, c in case["cases"].items() for shape in c["meshes"]}


def recurrent_mesh_rank(rank, world, case_path):
    """The recurrent families' cells over ranks: :func:`decode_mesh_case`
    for each case of ``case["decode"]`` and mesh; for each arch of
    ``case["cells"]`` (a config, whole parameters, tokens [B, S]) and
    mesh: the train cell placed by ``place_cell``, ``train_loss`` and its
    gradient at those parameters (whole on every rank) with the blocks
    the WKV or SSD kernel was handed, the same gradient with ``Replicate``
    planted in place of ``_on_blocks``' ``Partial`` gradient placements on
    the meshes of ``case["plant"]``, and the prefill cell's logits (keyed
    ``cell/<arch>/<mesh>``)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import blocks
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.registry import build_model

    case = torch.load(case_path)
    out = {f"{name}/{shape[0]}x{shape[1]}": decode_mesh_case(c, shape)
           for name, c in case["decode"].items() for shape in c["meshes"]}
    for arch, c in case["cells"].items():
        cfg = ModelConfig(**c["cfg"])
        model = build_model(cfg)
        tokens = c["tokens"]
        b, s = tokens.shape
        for shape in c["meshes"]:
            mesh = make_device_mesh(shape, "cpu")
            res = {"coord": tuple(mesh.get_coordinate())}
            _, (p, _, batch) = steps.place_cell(
                cfg, Shape("train", s, b, "train"), mesh,
                {"tokens": tokens}, params=c["params"])
            seen = []
            kernels = {n: getattr(blocks, n) for n in ("wkv6", "ssd")}

            def recording(name):
                def kernel(*args):
                    seen.append((name, tuple(args[0].shape),
                                 type(args[0]).__name__))
                    return kernels[name](*args)
                return kernel

            for n in kernels:
                setattr(blocks, n, recording(n))
            try:
                loss, grads = steps._value_and_grad(model, p, batch, True)
            finally:
                for n, k in kernels.items():
                    setattr(blocks, n, k)
            res.update(loss=_full(loss), grads=[_full(g) for g in grads],
                       blocks=seen)
            if list(shape) in [list(m) for m in case["plant"]]:
                partial = blocks.Partial
                blocks.Partial = Replicate
                try:
                    _, planted = steps._value_and_grad(model, p, batch, True)
                finally:
                    blocks.Partial = partial
                res["planted"] = [_full(g) for g in planted]
            pfn, pargs = steps.place_cell(
                cfg, Shape("prefill", s, b, "prefill"), mesh,
                {"tokens": tokens}, params=c["params"])
            with torch.no_grad():
                res["prefill"] = _full(pfn(*pargs))
            out[f"cell/{arch}/{shape[0]}x{shape[1]}"] = res
    return out


@contextlib.contextmanager
def planted(name, data):
    """A fault planted in the MoE for the block, to show a test sees it:
    ``"capacity"``, the spmd path's capacity cut to a batch block's of
    ``data`` blocks (its routing still over all T tokens), or
    ``"replicate"``, ``Replicate`` declared in place of the router's
    ``Partial`` gradient placements in the shard_map path's ``local_map``
    (each rank's share of its gradient then passes for the whole)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.models import blocks

    route, local_map = blocks.moe_route, blocks.local_map

    def block_capacity(cfg, router, h, lo=0, n_local=None):
        r = route(cfg, router, h, lo, n_local)
        t = h.shape[0] // data
        c = int(t * cfg.top_k // cfg.n_experts * cfg.capacity_factor) + 1
        return r._replace(capacity=c, pos=torch.where(
            r.pos < c, r.pos, torch.full_like(r.pos, c)))

    def replicated_router(fn, *, in_grad_placements=None, **kw):
        if in_grad_placements is not None and fn.__name__ == "local":
            router = tuple(Replicate() if p.is_partial() else p
                           for p in in_grad_placements[0])
            in_grad_placements = (router,) + tuple(in_grad_placements[1:])
        return local_map(fn, in_grad_placements=in_grad_placements, **kw)

    if name == "capacity":
        blocks.moe_route = block_capacity
    else:
        blocks.local_map = replicated_router
    try:
        yield
    finally:
        blocks.moe_route, blocks.local_map = route, local_map


def cells_mesh_rank(rank, world, case_path):
    """The MoE and encoder-decoder cells over ranks:
    :func:`decode_mesh_case` for each case of ``case["decode"]`` and mesh;
    for each cell case of ``case["cells"]`` (a config, whole parameters,
    a whole batch: tokens [B, S] and the encoder-decoder's frames) and
    mesh: the train cell placed by ``place_cell``, ``train_loss`` and its
    gradient at those parameters (whole on every rank) with the q and k
    blocks ``flash_attention`` was handed, the same gradient with the
    case's fault :func:`planted` on the meshes of its ``"plant"``, and
    the prefill cell's logits with the shard_map path's all-reduces it
    counted (keyed ``cell/<case>/<mesh>``)."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import blocks
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.registry import build_model

    case = torch.load(case_path)
    out = {f"{name}/{shape[0]}x{shape[1]}": decode_mesh_case(c, shape)
           for name, c in case["decode"].items() for shape in c["meshes"]}
    for name, c in case["cells"].items():
        cfg = ModelConfig(**c["cfg"])
        model = build_model(cfg)
        batch = c["batch"]
        b, s = batch["tokens"].shape
        for shape in c["meshes"]:
            mesh = make_device_mesh(shape, "cpu")
            res = {"coord": tuple(mesh.get_coordinate())}
            _, (p, _, placed) = steps.place_cell(
                cfg, Shape("train", s, b, "train"), mesh, batch,
                params=c["params"])
            seen = []
            kernel = blocks.flash_attention

            def recording(q, k, v, **kw):
                seen.append((tuple(q.shape), tuple(k.shape),
                             type(q).__name__))
                return kernel(q, k, v, **kw)

            blocks.flash_attention = recording
            try:
                loss, grads = steps._value_and_grad(model, p, placed, True)
            finally:
                blocks.flash_attention = kernel
            res.update(loss=_full(loss), grads=[_full(g) for g in grads],
                       blocks=seen)
            fault, meshes = c.get("plant", (None, []))
            if list(shape) in [list(m) for m in meshes]:
                with planted(fault, shape[0]):
                    _, bad = steps._value_and_grad(model, p, placed, True)
                res["planted"] = [_full(g) for g in bad]
            pfn, pargs = steps.place_cell(
                cfg, Shape("prefill", s, b, "prefill"), mesh, batch,
                params=c["params"])
            before = blocks.apply_moe_shardmap.all_reduces
            with torch.no_grad():
                res["prefill"] = _full(pfn(*pargs))
            res["all_reduces"] = blocks.apply_moe_shardmap.all_reduces - before
            out[f"cell/{name}/{shape[0]}x{shape[1]}"] = res
    return out


@contextlib.contextmanager
def blockwise(n, auxes=None):
    """The shard_map MoE's semantics in one process: each MoE layer
    routes each of ``n`` batch blocks on its own (``apply_moe_spmd`` on
    the block, its capacity from the block's tokens; a batch ``n`` does
    not divide stays whole, as the data axes drop), aux the blocks' mean;
    each layer's block auxes appended to ``auxes``."""
    from repro_torch.models import blocks, lm

    whole = lm.apply_moe

    def apply(cfg, p, x):
        k = n if x.shape[0] % n == 0 else 1
        ys, aux = zip(*[blocks.apply_moe_spmd(cfg, p, c)
                        for c in x.chunk(k)])
        if auxes is not None:
            auxes.append([float(a.detach()) for a in aux])
        return torch.cat(ys), torch.stack(aux).mean()

    lm.apply_moe = apply
    try:
        yield
    finally:
        lm.apply_moe = whole


def train_families_rank(rank, world, case_path):
    """For each arch of ``case["cells"]`` (a config, whole parameters,
    each step's batch: tokens [steps, B, S] and an encoder-decoder's
    frames [steps, B, Se, d]): the train cell placed by
    ``launch/steps.place_cell`` on a (data, model) mesh of
    ``case["mesh"]`` and one ``make_train_step`` AdamW step at
    ``case["opt"]`` on each batch, under ``PeerStaged`` for CPU tensors
    (the card's path: every collective through its table, the functional
    ones through buffers the group maps) with step 1's collectives
    counted: each step's loss and grad norm, what was staged, every
    moment's layout; rank 0 keeps the whole parameters after the steps."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import steps
    from repro_torch.launch.collectives import CollectiveCounter
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import adamw
    from repro_torch.parallel.peer_staged import PeerStaged
    from repro_torch.parallel.sharding import distribute
    from repro_torch.tree import leaves

    case = torch.load(case_path)
    mesh = make_device_mesh(tuple(case["mesh"]), "cpu")
    out = {}
    for arch, c in case["cells"].items():
        cfg = ModelConfig(**c["cfg"])
        batches = c["batches"]
        b, s = batches["tokens"].shape[1:]
        first = {k: v[0] for k, v in batches.items()}
        fn, (p, o, _) = steps.place_cell(
            cfg, Shape("train", s, b, "train"), mesh, first,
            params=c["params"], opt_cfg=adamw.AdamWConfig(**case["opt"]))
        b_shard = steps.batch_shardings(
            {k: (tuple(v.shape), v.dtype) for k, v in first.items()}, mesh)
        res = {"coord": tuple(mesh.get_coordinate()), "losses": [],
               "grad_norms": []}
        with PeerStaged("cpu") as staged:
            for i in range(batches["tokens"].shape[0]):
                batch = distribute({k: v[i] for k, v in batches.items()},
                                   b_shard, mesh)
                if i == 0:
                    with CollectiveCounter() as counter:
                        p, o, m = fn(p, o, batch)
                    res["collectives"] = counter.result()
                else:
                    p, o, m = fn(p, o, batch)
                res["losses"].append(_full(m["loss"]))
                res["grad_norms"].append(_full(m["grad_norm"]))
        res["staged"] = dict(staged.ops)
        res["step"] = _full(o.step)
        res["moments"] = [(tuple(t.to_local().shape), str(t.placements),
                           t.to_local().device.type, str(t.dtype))
                          for t in leaves(o.m) + leaves(o.v)]
        whole = [_full(t) for t in leaves(p)]
        res["params"] = whole if rank == 0 else None
        out[arch] = res
    return out


def redistribute_rank(rank, world):
    """The collective counter over three redistributes of a float32
    [8, 16] DTensor on a 1-D mesh of ``world`` ranks (Shard(0) ->
    Replicate, Partial -> Replicate, Partial -> Shard(0)) and over one
    ``torch.distributed.all_reduce`` of it: each case's dict and whether
    the values came out right; then the three again under ``HostStaged``
    for this device type, and under ``PeerStaged`` for it, with what each
    staged; then, under one ``PeerStaged``, Partial-to-Shard and
    Shard-to-Replicate redistributes of float32 inputs that grow past the
    group's buffers, shrink and grow again, and an int64 and a 0-d float32
    sum: whether each came out right."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (
        DTensor, Partial, Replicate, Shard, distribute_tensor,
    )

    from repro_torch.launch.collectives import CollectiveCounter
    from repro_torch.parallel.host_staged import HostStaged
    from repro_torch.parallel.peer_staged import PeerStaged

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    whole = torch.arange(128, dtype=torch.float32).reshape(8, 16)

    def cases():
        return {
            "shard_to_replicate": (
                distribute_tensor(whole, mesh, [Shard(0)],
                                  src_data_rank=None),
                [Replicate()], whole),
            "partial_to_replicate": (
                DTensor.from_local(whole.clone(), mesh, [Partial()],
                                   run_check=False),
                [Replicate()], world * whole),
            "partial_to_shard": (
                DTensor.from_local(whole.clone(), mesh, [Partial()],
                                   run_check=False),
                [Shard(0)], world * whole)}

    out = {}
    for name, (x, target, want) in cases().items():
        with CollectiveCounter() as counter:
            y = x.redistribute(mesh, target)
            local = y.to_local() + 0      # waits for the collective
        out[name] = {"counts": counter.result(),
                     "right": bool(torch.equal(y.full_tensor(), want)),
                     "local": tuple(local.shape)}
    t = whole.clone()
    with CollectiveCounter() as counter:
        dist.all_reduce(t)
    out["c10d_all_reduce"] = {"counts": counter.result(),
                              "right": bool(torch.equal(t, world * whole))}
    for name, (x, target, want) in cases().items():
        with HostStaged("cpu") as staged:
            y = x.redistribute(mesh, target)
            got = y.full_tensor()
        out[f"staged/{name}"] = {"staged": dict(staged.ops),
                                 "right": bool(torch.equal(got, want))}
    for name, (x, target, want) in cases().items():
        with PeerStaged("cpu") as staged:
            y = x.redistribute(mesh, target)
            got = y.full_tensor()
        out[f"peer/{name}"] = {"staged": dict(staged.ops),
                               "right": bool(torch.equal(got, want))}
    # inputs that outgrow the group's buffers (new generations mapped),
    # shrink and grow again, in float32, int64 and a 0-d sum
    right = []
    with PeerStaged("cpu") as staged:
        for rows in (1, 3, 400_000, 2, 700_000, 0, 5):
            parts = [torch.randn((rows * world, 3), generator=torch.Generator()
                                 .manual_seed(10 * rows + r))
                     for r in range(world)]
            a = parts[rank]
            whole = DTensor.from_local(a, mesh, [Partial()], run_check=False)
            sums = parts[0].clone()     # added in rank order, as the peers
            for part in parts[1:]:
                sums += part
            right.append(torch.equal(
                whole.redistribute(mesh, [Shard(0)]).to_local(),
                sums.chunk(world)[rank]))
            right.append(torch.equal(
                distribute_tensor(sums, mesh, [Shard(0)],
                                  src_data_rank=None).full_tensor(), sums))
        n = torch.tensor([rank + 1], dtype=torch.int64)
        right.append(int(DTensor.from_local(n, mesh, [Partial()],
                                            run_check=False)
                         .full_tensor()) == world * (world + 1) // 2)
        s = DTensor.from_local(torch.tensor(float(rank)), mesh, [Partial()],
                               run_check=False)
        right.append(float(s.full_tensor()) == sum(range(world)))
    out["peer/growing"] = {"staged": dict(staged.ops), "right": right}
    return out


def one_rank_step(rank, world, case_path):
    """The train step of ``case`` on a 1 x 1 (data, model) mesh: the
    counter's dict for one step."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import steps
    from repro_torch.launch.collectives import CollectiveCounter
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import adamw

    case = torch.load(case_path)
    cfg = ModelConfig(**case["cfg"])
    tokens = case["tokens"]
    mesh = make_device_mesh((1, 1), "cpu")
    fn, args = steps.place_cell(
        cfg, Shape("train", tokens.shape[1], tokens.shape[0], "train"), mesh,
        {"tokens": tokens}, params=case["params"],
        opt_cfg=adamw.AdamWConfig())
    with CollectiveCounter() as counter:
        _, _, m = fn(*args)
    return {"counts": counter.result(), "loss": _full(m["loss"])}
