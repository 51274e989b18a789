"""The reference's side of ``tests/test_torch_moe_shardmap_grad.py``.

Run as a fresh process with 4 XLA host devices (the flag must precede the
first ``jax`` import)::

    PYTHONPATH=src python tests/torch_moe_grad_ref.py CASE.npz OUT.npz

CASE holds the MoE block's weights, ``x`` and the config as JSON (as
``tests/torch_mesh_ref.py moe`` reads them).  For each mesh of ``MESHES``
and strategy this writes ``jax.grad`` of each of ``LOSSES`` (the sum of
``apply_moe_shardmap``'s output, its aux) with respect to x, the router,
the norm's scale and the three expert tensors, keyed
``{d}x{m}/{strategy}/{loss}/{leaf}``, and aux's value keyed
``{d}x{m}/{strategy}/aux_value``; and the same of ``apply_moe_spmd``
keyed ``spmd/{strategy}/...``.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import dataclasses                                             # noqa: E402
import json                                                    # noqa: E402

import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402
import numpy as np                                             # noqa: E402

from repro.compat import use_mesh                              # noqa: E402
from repro.models import blocks                                # noqa: E402
from repro.models.config import ModelConfig                    # noqa: E402

MESHES = [(1, 2), (1, 4), (2, 2)]
EXPERT = ("w_gate", "w_up", "w_down")
# the two losses: the sum of the block's output, and its aux loss
LOSSES = {"y": lambda out: out[0].sum(), "aux": lambda out: out[1]}


def leaves(gp, gx):
    out = {"x": gx, "router": gp["router"], "norm_scale": gp["norm"]["scale"]}
    out.update({k: gp[k] for k in EXPERT})
    return out


def main(case_path: str, out_path: str) -> None:
    case = np.load(case_path)
    base = ModelConfig(**json.loads(str(case["cfg"])))
    p = {k: jnp.asarray(case[k]) for k in ("router",) + EXPERT}
    p["norm"] = {"scale": jnp.asarray(case["norm_scale"])}
    x = jnp.asarray(case["x"])
    out = {}
    for strategy in ("ep", "tp"):
        cfg = dataclasses.replace(base, moe_strategy=strategy,
                                  moe_impl="shardmap")
        out[f"spmd/{strategy}/aux_value"] = blocks.apply_moe_spmd(
            cfg, p, x)[1]
        for loss, pick in LOSSES.items():
            g = jax.grad(lambda p, x: pick(blocks.apply_moe_spmd(cfg, p, x)),
                         argnums=(0, 1))(p, x)
            for k, v in leaves(*g).items():
                out[f"spmd/{strategy}/{loss}/{k}"] = v
        for shape in MESHES:
            mesh = jax.make_mesh(shape, ("data", "model"))
            name = f"{shape[0]}x{shape[1]}/{strategy}"
            with use_mesh(mesh):
                out[f"{name}/aux_value"] = jax.jit(
                    lambda p, x: blocks.apply_moe_shardmap(
                        cfg, p, x, mesh)[1])(p, x)
            for loss, pick in LOSSES.items():
                fn = jax.jit(jax.grad(
                    lambda p, x: pick(blocks.apply_moe_shardmap(
                        cfg, p, x, mesh)), argnums=(0, 1)))
                with use_mesh(mesh):
                    g = fn(p, x)
                for k, v in leaves(*g).items():
                    out[f"{name}/{loss}/{k}"] = v
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
