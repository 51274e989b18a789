"""Dry run: every (arch x shape) cell laid out over a mesh, with no
compiler and nothing allocated.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell for the production mesh and reads its memory analysis, cost analysis
and the collectives of the optimized HLO.  An eager PyTorch program has no
compiled program to read, so per cell this records, from
:func:`repro_torch.launch.steps.build_cell`'s ``meta`` tensors and their
shardings' shard shapes:

* the bytes a device holds of each argument: parameters (bf16),
  optimizer state (train), caches (decode) and inputs;
* ``n_params`` and ``n_active_params``;
* the analytic FLOPs and HBM bytes of ``launch/roofline.py``;
* with ``--collectives``, the collectives one device runs in the cell's
  step (:func:`step_collectives`): the step runs for real on DTensors
  placed by the cell's shardings, as rank 0 of a fake process group of
  the mesh's size, on fake CPU tensors (shapes only, nothing computed or
  sent; the WKV and SSD wrappers give their outputs' shapes and run no
  scan), and ``launch/collectives.py`` counts what it issues: the
  reference's ``collective_bytes`` keys, from which the roofline takes its
  collective term.  Every family's cells run so: the dense, VLM, SSM,
  hybrid, MoE (the shard_map path of mixtral-8x7b's and kimi-k2's
  configs on each rank's blocks, one all-reduce a layer) and
  encoder-decoder ones.

Meshes: ``16x16`` and ``2x16x16`` (the reference's production layouts)
and ``1xH100`` (one card as a 1 x 1 (data, model) mesh).  Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        [--shape decode_32k] [--mesh 1xH100] [--collectives] \\
        [--out results.json]

With no ``--arch`` every arch runs; ``python -m
repro_torch.launch.roofline --glob OUT.json`` prints the roofline table of
the records written to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.shapes import SHAPES, skip_reason
from repro_torch.launch import roofline
from repro_torch.launch.collectives import CollectiveCounter
from repro_torch.launch.mesh import (
    make_card_mesh, make_device_mesh, make_production_mesh,
)
from repro_torch.launch.steps import build_cell
from repro_torch.parallel.sharding import (
    Mesh, MeshShape, NamedSharding, distribute, mesh_size,
)
from repro_torch.tree import tree_map

MESHES = {
    "16x16": make_production_mesh,
    "2x16x16": lambda: make_production_mesh(multi_pod=True),
    "1xH100": make_card_mesh,
}


def _leaf_pairs(args, shardings):
    """(tensor, NamedSharding) of every leaf of an argument tree."""
    out = []

    def visit(node, sh):
        if isinstance(node, torch.Tensor):
            out.append((node, sh))
        elif isinstance(node, dict):
            for k in node:
                visit(node[k], sh[k])
        elif isinstance(node, (tuple, list)):
            for n, s in zip(node, sh):
                visit(n, s)

    visit(args, shardings)
    return out


def device_bytes(args, shardings) -> int:
    """Bytes one device holds of ``args`` laid out by ``shardings``."""
    total = 0
    for t, sh in _leaf_pairs(args, shardings):
        if not isinstance(sh, NamedSharding):
            raise TypeError(f"leaf of shape {tuple(t.shape)} has no "
                            f"NamedSharding ({sh!r})")
        total += math.prod(sh.shard_shape(tuple(t.shape))) * t.element_size()
    return total


@contextlib.contextmanager
def fake_world(size: int):
    """Rank 0 of a fake process group of ``size`` ranks (``FakeStore``,
    backend ``"fake"``: collectives return at once, sending nothing) for
    the block; the group is destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is up; the dry run needs its "
                           "own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def alltoall_as_on_a_card():
    """DTensor's shard-to-shard redistribute as a card's group runs it.  On
    a CPU mesh DTensor falls back to an all-gather of the whole dim and a
    chunk of it (gloo has no all-to-all); on a card it runs
    ``_dtensor::shard_dim_alltoall``, whose result is the block.  In the
    block the op itself runs (on fake tensors its fake kernel gives the
    block), so the count is a card's."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    def alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            x, gather_dim, shard_dim, funcol._group_or_group_name(group))

    fallback = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = fallback


def step_collectives(cfg, shape, mesh: MeshShape) -> Dict[str, int]:
    """The collectives one device runs in one step of the cell: the step
    of :func:`build_cell` on its arguments placed as DTensors by its
    shardings over ``mesh``'s ``DeviceMesh`` (a fake world of the mesh's
    size must be up, :func:`fake_world`), on fake tensors, with
    shard-to-shard redistributes run as on a card
    (:func:`alltoall_as_on_a_card`); the counter's dict
    (``launch/collectives.py``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dmesh = make_device_mesh(mesh, "cpu")
    fn, args, in_sh, _, _ = build_cell(cfg, shape, dmesh)
    # the mesh's own bookkeeping runs on real tensors inside the mode
    with FakeTensorMode(allow_non_fake_inputs=True):
        whole = tuple(tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                               a) for a in args)
        placed = tuple(distribute(a, sh, dmesh)
                       for a, sh in zip(whole, in_sh))
        with alltoall_as_on_a_card(), CollectiveCounter() as counter:
            fn(*placed)
    return counter.result()


def run_cell(arch: str, shape_name: str, mesh: str = "16x16",
             collectives: bool = False) -> Dict:
    """The dry-run record of one cell (``mesh`` names one of
    :data:`MESHES`); ``collectives`` counts its step's collectives, under
    a :func:`fake_world` of the mesh's size."""
    reason = skip_reason(arch, shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    m: Mesh = MESHES[mesh]()
    _, args, in_sh, _, _ = build_cell(cfg, shape, m)
    names = {"train": ("params", "opt_state", "inputs"),
             "prefill": ("params", "inputs"),
             "decode": ("params", "cache", "inputs")}[shape.kind]
    per_dev = {n: device_bytes(a, s) for n, a, s in zip(names, args, in_sh)}
    per_dev["total"] = sum(per_dev.values())
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh,
        "chips": mesh_size(m),
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "flops": roofline.analytic_flops(cfg, shape),
        "hbm_bytes": roofline.analytic_hbm_bytes(cfg, shape),
        "collectives": None,
        "bytes_per_device": per_dev,
    }
    if collectives:
        rec["collectives"] = step_collectives(cfg, shape, m)
    return rec


def run_all(mesh: str, archs=None, shapes=None, collectives: bool = False):
    """Records of every cell of ``archs`` x ``shapes`` (default: all),
    skipped cells included; ``collectives`` counts each step's under one
    fake world of the mesh's size."""
    cells = [(a, s) for a in (archs or ARCHS) for s in (shapes or SHAPES)]
    world = (fake_world(mesh_size(MESHES[mesh]())) if collectives
             else contextlib.nullcontext())
    with world:
        return [run_cell(a, s, mesh, collectives) for a, s in cells]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="16x16", choices=sorted(MESHES))
    ap.add_argument("--collectives", action="store_true",
                    help="count each step's collectives a device on a "
                         "fake process group of the mesh's size")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    records = run_all(args.mesh, [args.arch] if args.arch else None,
                      [args.shape] if args.shape else None,
                      args.collectives)
    for rec in records:
        if "skipped" in rec:
            print(f"[dryrun] {rec['arch']:18s} {rec['shape']:12s} SKIP: "
                  f"{rec['skipped']}")
            continue
        coll = rec["collectives"]
        coll = ("" if coll is None else
                f"  dt-coll {coll['count']:5d} ops "
                f"{sum(v for k, v in coll.items() if k != 'count') / 1e9:8.2f}"
                f" GB")
        print(f"[dryrun] {rec['arch']:18s} {rec['shape']:12s} "
              f"{rec['mesh']:8s} GFLOP {rec['flops'] / 1e9:14.1f}  "
              f"mem/dev {rec['bytes_per_device']['total'] / 1e9:8.2f} GB"
              f"{coll}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
