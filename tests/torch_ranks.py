"""Ranks of a ``torch.distributed`` group as child processes, for the
tests of the port's collectives (imports no JAX).

:func:`run_ranks` starts ``world`` processes from a ``spawn`` context,
each joining a gloo group through a ``FileStore`` in a scratch directory,
and joins them under one hard time limit: a rank still alive at the limit
is killed and the call fails, so a hung collective cannot hold a test run.
Each rank runs with one intra-op thread.
Arguments go as plain values (paths), and each rank writes its results
with ``torch.save`` for the parent to read, so no tensor crosses processes
through shared memory.

:func:`moe_rank` is the rank body of ``tests/test_torch_moe_shardmap.py``.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT = 120.0


def _entry(target, rank, world, workdir, args):
    torch.set_num_threads(1)          # the group shares the machine's cores
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    try:
        torch.save(target(rank, world, *args),
                   os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(target, world: int, workdir, *args,
              timeout: float = RANK_TIMEOUT):
    """``target(rank, world, *args)`` on ``world`` spawned ranks -> the
    list of their return values, by rank."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(target, r, world, str(workdir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still running "
                               f"after {timeout:.0f} s; killed")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [torch.load(workdir / f"rank{r}.pt") for r in range(world)]


def sleep_rank(rank, world, secs):
    """Rank 0 waits in a barrier that rank 1 reaches only after ``secs``:
    a hung collective, for the time-limit test."""
    if rank:
        time.sleep(secs)
    dist.barrier()


def _grads(fn, p):
    """d sum(fn(p)[0]) / d p, leaf by leaf of the MoE block."""
    leaves = {k: v for k, v in p.items() if k != "norm"}
    leaves["norm.scale"] = p["norm"]["scale"]
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        g = torch.autograd.grad(fn(p)[0].sum(), list(leaves.values()))
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    return dict(zip(leaves, g))


def moe_rank(rank, world, case_path):
    """One rank of the MoE cases saved at ``case_path``: for each mesh of
    ``case["meshes"]`` (each of ``world`` ranks), the shard_map block
    through ``apply_moe`` under ``use_mesh`` (and, on a one-rank mesh, its
    gradients and a smoke LM's prefill with and without the mesh)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import blocks
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.sharding import use_mesh

    torch.manual_seed(0)
    case = torch.load(case_path)
    out = {}
    x = case["x"]
    for shape in case["meshes"]:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        coord = mesh.get_coordinate()
        for strategy in ("ep", "tp"):
            cfg = ModelConfig(**dict(case["cfg"], moe_strategy=strategy,
                                     moe_impl="shardmap"))
            p = case["params"]
            before = blocks.apply_moe_shardmap.all_reduces
            with use_mesh(mesh):
                y, aux = blocks.apply_moe(cfg, p, x)
            res = {"coord": coord, "y": y, "aux": aux,
                   "all_reduces": blocks.apply_moe_shardmap.all_reduces
                   - before}
            if world == 1:
                y0, aux0 = blocks.apply_moe_spmd(cfg, p, x)
                res.update(y_spmd=y0, aux_spmd=aux0)
                res["g_shardmap"] = _grads(
                    lambda q: blocks.apply_moe_shardmap(cfg, q, x, mesh), p)
                res["g_spmd"] = _grads(
                    lambda q: blocks.apply_moe_spmd(cfg, q, x), p)
                lm_cfg = dataclasses.replace(cfg, n_layers=3)
                model = build_model(lm_cfg)
                params = model.init(0, device="cpu")
                tokens = torch.randint(1, lm_cfg.vocab, (2, 12))
                before = blocks.apply_moe_shardmap.all_reduces
                with use_mesh(mesh):
                    res["lm_shardmap"] = model.prefill(params, tokens)
                res["lm_all_reduces"] = (blocks.apply_moe_shardmap.all_reduces
                                         - before)
                res["lm_spmd"] = model.prefill(params, tokens)
            out[f"{shape[0]}x{shape[1]}/{strategy}"] = res
    return out
