"""The reference's side of ``tests/test_torch_collectives.py``, as a file.

Run as a fresh process: the forced host device count must precede the
first ``jax`` import, so this script sets it from its arguments::

    PYTHONPATH=src python tests/torch_collectives_ref.py OUT.json
    PYTHONPATH=src python tests/torch_collectives_ref.py cell ARCH SHAPE \
        MESH OUT.json

With 4 devices, each redistribute of ``tests/torch_mesh_ranks.py``'s ``redistribute_rank``
(a float32 [8, 16] over a 1-D mesh of 4) jitted as the reference writes
it: ``with_sharding_constraint`` of a row-sharded array to replicated; a
sum over the sharded axis of a [4, 8, 16] array, which leaves each device
a partial [8, 16], to replicated and to row-sharded; and ``psum`` under
``shard_map`` for the explicit all-reduce.  OUT maps each case to
``repro.launch.dryrun.collective_bytes`` of its compiled HLO.

The reference's parser skips a collective that is its computation's ROOT
instruction (the line starts with ``ROOT``), so each program ends in a
product after its collective.

``cell`` (256 or 512 devices, MESH ``16x16`` or ``2x16x16``): the
reference's dry run of one cell (``repro.launch.dryrun.run_cell``: the
step of ``build_cell`` jitted with its shardings, compiled, and
``collective_bytes`` of its HLO with the layer loop's trip count), on the
production mesh made with Auto axes, which JAX 0.9's default Explicit axes
are not (its ``shard`` refuses them).  OUT gets the cell's record; the
port's counts of the same cell come from ``python -m
repro_torch.launch.dryrun --collectives``.
"""

import os
import sys

N_DEVICES = ({"16x16": 256, "2x16x16": 512}[sys.argv[4]]
             if sys.argv[1] == "cell" else 4)
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count="
                           f"{N_DEVICES}")

import json                                                    # noqa: E402

import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402
from jax.sharding import AxisType, NamedSharding               # noqa: E402
from jax.sharding import PartitionSpec as P                    # noqa: E402

from repro.launch.dryrun import collective_bytes               # noqa: E402


def main(out_path: str) -> None:
    mesh = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))

    def sh(*spec):
        return NamedSharding(mesh, P(*spec))

    whole = jnp.arange(128, dtype=jnp.float32).reshape(8, 16)
    parts = jnp.stack([whole] * 4)
    cases = {
        "shard_to_replicate": (
            lambda x: jax.lax.with_sharding_constraint(x, sh()) * 2.0,
            whole, sh()),
        "partial_to_replicate": (lambda a: a.sum(0) * 2.0, parts, sh()),
        "partial_to_shard": (lambda a: a.sum(0) * 2.0, parts, sh("data")),
        "c10d_all_reduce": (
            jax.shard_map(lambda a: jax.lax.psum(a[0], "data") * 2.0,
                      mesh=mesh, in_specs=P("data"), out_specs=P()),
            parts, sh()),
    }
    out = {}
    for name, (fn, x, out_sh) in cases.items():
        x = jax.device_put(x, sh("data"))
        hlo = jax.jit(fn, out_shardings=out_sh).lower(x).compile().as_text()
        out[name] = collective_bytes(hlo)
    with open(out_path, "w") as f:
        json.dump(out, f)


def cell(arch: str, shape: str, mesh: str, out_path: str) -> None:
    from repro.launch import dryrun, mesh as mesh_mod

    multi_pod = mesh == "2x16x16"

    def production_mesh(*, multi_pod: bool = False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(shape))

    mesh_mod.make_production_mesh = production_mesh
    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod)
    with open(out_path, "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    if sys.argv[1] == "cell":
        cell(*sys.argv[2:6])
    else:
        main(sys.argv[1])
