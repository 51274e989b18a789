"""The reference's side of the port's parallel-layer tests, as files.

Run as a fresh process: the forced host device count must precede the
first ``jax`` import, so this script sets it from its arguments::

    PYTHONPATH=src python tests/torch_mesh_ref.py sharding OUT.json
    PYTHONPATH=src python tests/torch_mesh_ref.py moe CASE.npz OUT.npz

``sharding`` (512 devices): the shardings of every full ``ARCHS`` config on
the 16 x 16 and 2 x 16 x 16 production meshes, which
``tests/test_torch_sharding.py`` and ``tests/test_torch_roofline.py`` hold
the port's ``resolve``, ``shard_shape``, ``build_cell`` and dry-run bytes
to.  Paths are the tree keys joined by "/"; a spec is a list with one
entry a tensor dim (null, an axis name, or a list of names).

``moe`` (4 devices): ``apply_moe_shardmap`` of the MoE block in CASE (its
weights, ``x`` and the config as JSON) on each mesh and strategy, the
spmd path, and each batch block's aux by the reference's
``_moe_local_compute``, for ``tests/test_torch_moe_shardmap.py``.
"""

import os
import sys

N_DEVICES = {"sharding": 512, "moe": 4}
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_"
    f"count={N_DEVICES[sys.argv[1]]}")

import json                                                    # noqa: E402

import jax                                                     # noqa: E402
import numpy as np                                             # noqa: E402

from repro.configs.archs import ARCHS                          # noqa: E402
from repro.configs.shapes import cells                         # noqa: E402
from repro.launch import steps                                 # noqa: E402
from repro.launch.mesh import make_production_mesh             # noqa: E402
from repro.models.registry import build_model                  # noqa: E402

# one cell of each shape kind (and the sequence-sharded long decode)
CELLS = [("kimi-k2-1t-a32b", "train_4k"), ("qwen2-vl-72b", "prefill_32k"),
         ("whisper-large-v3", "decode_32k"), ("zamba2-7b", "decode_32k"),
         ("mixtral-8x7b", "long_500k"), ("rwkv6-7b", "long_500k")]


def path_str(path) -> str:
    out = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                out.append(str(getattr(k, attr)))
                break
    return "/".join(out)


def spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def layout(shardings, shapes):
    """{path: [spec, shape, shard shape]} of every leaf."""
    sh = jax.tree_util.tree_flatten_with_path(shardings)[0]
    sd = jax.tree.leaves(shapes)
    assert len(sh) == len(sd)
    return {path_str(p): [spec_json(s.spec), list(x.shape),
                          list(s.shard_shape(x.shape))]
            for (p, s), x in zip(sh, sd)}


def sharding(out_path: str) -> None:
    meshes = {"16x16": make_production_mesh(),
              "2x16x16": make_production_mesh(multi_pod=True)}
    out = {"params": {}, "cells": {}, "param_bytes": {}}
    for arch, cfg in ARCHS.items():
        shapes, specs = steps.abstract_init(build_model(cfg))
        out["params"][arch] = {
            name: layout(steps.param_shardings(specs, shapes, m), shapes)
            for name, m in meshes.items()}
        for shape in cells(arch):
            _, args, in_sh, out_sh, donate = steps.build_cell(
                cfg, shape, meshes["16x16"])
            leaves = zip(jax.tree.leaves(in_sh[0]), jax.tree.leaves(args[0]))
            out["param_bytes"][f"{arch}/{shape.name}"] = int(sum(
                np.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
                for s, x in leaves))
            if (arch, shape.name) in CELLS:
                out["cells"][f"{arch}/{shape.name}"] = {
                    "in": [layout(s, a) for s, a in zip(in_sh, args)],
                    "out": None if out_sh is None else [
                        None if s is None else layout(s, a)
                        for s, a in zip(out_sh, args)],
                    "donate": list(donate)}
    with open(out_path, "w") as f:
        json.dump(out, f)


MOE_MESHES = [(1, 1), (1, 2), (1, 4), (2, 2)]


def moe(case_path: str, out_path: str) -> None:
    import dataclasses

    import jax.numpy as jnp

    from repro.compat import use_mesh
    from repro.models import blocks
    from repro.models.common import rms_norm
    from repro.models.config import ModelConfig

    case = np.load(case_path)
    base = ModelConfig(**json.loads(str(case["cfg"])))
    p = {k: jnp.asarray(case[k]) for k in ("router", "w_gate", "w_up",
                                           "w_down")}
    p["norm"] = {"scale": jnp.asarray(case["norm_scale"])}
    x = jnp.asarray(case["x"])
    out = {}
    for strategy in ("ep", "tp"):
        cfg = dataclasses.replace(base, moe_strategy=strategy,
                                  moe_impl="shardmap")
        y, aux = blocks.apply_moe_spmd(cfg, p, x)
        out[f"spmd/{strategy}/y"], out[f"spmd/{strategy}/aux"] = y, aux
        for shape in MOE_MESHES:
            mesh = jax.make_mesh(shape, ("data", "model"))
            # jitted: one compile a case (eager shard_map dispatches op
            # by op, about 10 s a call on the CPU)
            fn = jax.jit(lambda p, x: blocks.apply_moe_shardmap(
                cfg, p, x, mesh))
            with use_mesh(mesh):
                y, aux = fn(p, x)
            tag = f"{shape[0]}x{shape[1]}/{strategy}"
            out[f"{tag}/y"], out[f"{tag}/aux"] = y, aux
            # each batch block's aux: routing over all E on the block
            b = x.shape[0] // shape[0]
            for i in range(shape[0]):
                h = rms_norm(x[i * b:(i + 1) * b], p["norm"]["scale"])
                out[f"{tag}/aux{i}"] = jax.jit(
                    lambda p, h: blocks._moe_local_compute(
                        cfg, p, h, 0, cfg.n_experts)[1])(
                    p, h.reshape(-1, x.shape[-1]))
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    if sys.argv[1] == "sharding":
        sharding(sys.argv[2])
    else:
        moe(sys.argv[2], sys.argv[3])
