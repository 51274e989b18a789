"""The reference's side of ``tests/test_torch_train_mesh.py``, as a file.

Run as a fresh process with 4 XLA host devices (the flag must precede the
first ``jax`` import)::

    PYTHONPATH=src python tests/torch_train_mesh_ref.py CASE.npz OUT.npz

CASE holds a smoke config's name (``arch``; qwen1.5-4b where it is
absent), its parameters as the leaves of its ``init`` tree (``p0``,
``p1``, ... in ``jax.tree.leaves`` order), the tokens of each step
(``tokens``, [steps, B, S]), the AdamW settings as JSON (``opt``) and,
where present, the encoder-decoder's frames of each step (``frames``,
[steps, B, Se, d]), the MoE path (``impl``, the reference's
``--moe-impl`` override) and ``grads_only`` (the loss and gradients
alone: no step is compiled or run).  On a 2 x 2 ("data", "model") mesh
with Auto axes (JAX 0.9 makes Explicit ones by default, which the
reference's ``shard`` refuses), this jits ``train_loss``'s value and
gradient and ``launch.steps.make_train_step`` with ``param_shardings``
as their in-shardings, and writes the loss and gradient leaves at the given
parameters (``loss0``, ``g0``, ...), each step's loss and grad norm, the
parameter leaves after the last step (``q0``, ...), and the reference's
``collective_bytes`` of the jitted step's compiled HLO as JSON
(``collectives``), its layer loop scaled as its dry run scales it.
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
from jax.sharding import AxisType                              # noqa: E402

from repro.compat import use_mesh                              # noqa: E402
from repro.configs.archs import SMOKE                          # noqa: E402
from repro.launch import steps                                 # noqa: E402
from repro.launch.dryrun import collective_bytes              # noqa: E402
from repro.models.registry import build_model                  # noqa: E402
from repro.optim import adamw                                  # noqa: E402

ARCH = "qwen1.5-4b"


def main(case_path: str, out_path: str) -> None:
    case = np.load(case_path)
    arch = str(case["arch"]) if "arch" in case else ARCH
    cfg = SMOKE[arch]
    if "impl" in case:
        cfg = dataclasses.replace(cfg, moe_impl=str(case["impl"]))
    model = build_model(cfg)
    init, specs = model.init(jax.random.PRNGKey(0))
    treedef = jax.tree.structure(init)
    params = jax.tree.unflatten(treedef, [
        jnp.asarray(case[f"p{i}"]) for i in range(treedef.num_leaves)])
    tokens = case["tokens"]
    opt_cfg = adamw.AdamWConfig(**json.loads(str(case["opt"])))
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    p_sh = steps.param_shardings(specs, params, mesh)
    state = adamw.init(opt_cfg, params)
    o_sh = steps.param_shardings(steps.opt_state_specs(specs, opt_cfg),
                                 state, mesh)
    frames = case["frames"] if "frames" in case else None
    specs = {"tokens": jax.ShapeDtypeStruct(tokens.shape[1:], jnp.int32)}
    if frames is not None:
        specs["frames"] = jax.ShapeDtypeStruct(frames.shape[1:], jnp.float32)
    b_sh = steps.batch_shardings(specs, mesh)

    def batch(i):
        b = {"tokens": jnp.asarray(tokens[i])}
        if frames is not None:
            b["frames"] = jnp.asarray(frames[i])
        return b

    out = {}
    with use_mesh(mesh):
        params = jax.device_put(params, p_sh)
        state = jax.device_put(state, o_sh)
        grad = jax.jit(jax.value_and_grad(
            lambda p, b: model.train_loss(p, b)), in_shardings=(p_sh, b_sh))
        loss0, g0 = grad(params, batch(0))
        out["loss0"] = np.asarray(loss0)
        for i, g in enumerate(jax.tree.leaves(g0)):
            out[f"g{i}"] = np.asarray(g)
        if "grads_only" in case:
            np.savez(out_path, **out)
            return
        step = jax.jit(steps.make_train_step(model, opt_cfg),
                       in_shardings=(p_sh, o_sh, b_sh))
        hlo = step.lower(params, state, batch(0)).compile().as_text()
        out["collectives"] = json.dumps(collective_bytes(
            hlo, loop_trip=getattr(model, "repeats", model.cfg.n_layers)))
        losses, norms = [], []
        for i in range(len(tokens)):
            params, state, m = step(params, state, batch(i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out["losses"] = np.asarray(losses)
    out["grad_norms"] = np.asarray(norms)
    for i, p in enumerate(jax.tree.leaves(params)):
        out[f"q{i}"] = np.asarray(p)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
