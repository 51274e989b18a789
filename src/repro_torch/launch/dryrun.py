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
* ``"collectives": None``: there is no HLO to parse (ROADMAP Queue 1 item
  5), so the roofline takes its dominant term over compute and memory.

Meshes: ``16x16`` and ``2x16x16`` (the reference's production layouts)
and ``1xH100`` (one card as a 1 x 1 (data, model) mesh).  Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        [--shape decode_32k] [--mesh 1xH100] [--out results.json]

With no ``--arch`` every arch runs; ``python -m
repro_torch.launch.roofline --glob OUT.json`` prints the roofline table of
the records written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict

import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.shapes import SHAPES, skip_reason
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_card_mesh, make_production_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.parallel.sharding import Mesh, NamedSharding, mesh_size

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


def run_cell(arch: str, shape_name: str, mesh: str = "16x16") -> Dict:
    """The dry-run record of one cell (``mesh`` names one of
    :data:`MESHES`)."""
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
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh,
        "chips": mesh_size(m),
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "flops": roofline.analytic_flops(cfg, shape),
        "hbm_bytes": roofline.analytic_hbm_bytes(cfg, shape),
        "collectives": None,
        "bytes_per_device": per_dev,
    }


def run_all(mesh: str, archs=None, shapes=None):
    """Records of every cell of ``archs`` x ``shapes`` (default: all),
    skipped cells included."""
    return [run_cell(a, s, mesh) for a in (archs or ARCHS)
            for s in (shapes or SHAPES)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="16x16", choices=sorted(MESHES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    records = run_all(args.mesh, [args.arch] if args.arch else None,
                      [args.shape] if args.shape else None)
    for rec in records:
        if "skipped" in rec:
            print(f"[dryrun] {rec['arch']:18s} {rec['shape']:12s} SKIP: "
                  f"{rec['skipped']}")
            continue
        print(f"[dryrun] {rec['arch']:18s} {rec['shape']:12s} "
              f"{rec['mesh']:8s} GFLOP {rec['flops'] / 1e9:14.1f}  "
              f"mem/dev {rec['bytes_per_device']['total'] / 1e9:8.2f} GB")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
