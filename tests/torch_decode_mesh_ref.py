"""The reference's side of ``tests/test_torch_decode_mesh.py``, as a file.

Run as a fresh process with 4 XLA host devices (the flag must precede the
first ``jax`` import)::

    PYTHONPATH=src python tests/torch_decode_mesh_ref.py CASE.npz OUT.npz

CASE holds, for each case ``c`` named in ``names`` (JSON), the smoke
config's name (``c__arch``), its parameters as the leaves of its ``init``
tree (``c__p0``, ``c__p1``, ... in ``jax.tree.leaves`` order), the cache
length (``c__seq``), the teacher-forced tokens [B, T] (``c__tokens``), the
left-padded prompts [B, P] (``c__prompts``), the number of tokens to
generate (``c__gen``) and, where present, the MoE path (``c__impl``,
``"spmd"`` or ``"shardmap"``: the reference's ``--moe-impl`` override,
``dataclasses.replace`` of the config) and an encoder-decoder's cross
caches for the teacher-forced steps (``c__cross_k``, ``c__cross_v``; the
generation starts from zero ones, as the reference's engine does).  On a 2 x 2 ("data", "model") mesh with Auto axes
(JAX 0.9 makes Explicit ones by default, which the reference's ``shard``
refuses), this jits ``launch.steps.build_cell``'s decode cell
(``make_decode_step`` with its in-shardings: the serve layout, the caches
by ``cache_shardings``, the KV sequence over "data" at batch 1, the
caches donated, and laid out again by their in-shardings after each step:
XLA may give a recurrent state back in another layout, which the jitted
cell refuses) and writes each step's logits (``c__logits``, [T, B,
vocab]), the cache leaves after the steps (``c__cache0``, ...), and the
greedy generation from the prompts as the reference's
``DecodeEngine.generate`` runs it (``c__generated``, [B, gen]); then the
same of the unsharded ``jax.jit(model.decode_step)`` (``c__plain_logits``,
``c__plain_cache0``, ..., ``c__plain_generated``).  The two part once a
global layer's cache is full: there the unsharded
``dynamic_update_slice`` clamps the write to the last slot, and the
partitioned one over a sequence split over "data" drops it.
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
from repro.configs.shapes import Shape                         # noqa: E402
from repro.launch import steps                                 # noqa: E402
from repro.models.registry import build_model                  # noqa: E402


def run_case(case, c: str, mesh) -> dict:
    cfg = SMOKE[str(case[f"{c}__arch"])]
    if f"{c}__impl" in case:
        cfg = dataclasses.replace(cfg, moe_impl=str(case[f"{c}__impl"]))
    model = build_model(cfg)
    init, _ = model.init(jax.random.PRNGKey(0))
    treedef = jax.tree.structure(init)
    params = jax.tree.unflatten(treedef, [
        jnp.asarray(case[f"{c}__p{i}"]) for i in range(treedef.num_leaves)])
    tokens, prompts = case[f"{c}__tokens"], case[f"{c}__prompts"]
    seq, gen = int(case[f"{c}__seq"]), int(case[f"{c}__gen"])
    b = tokens.shape[0]
    fn, _, in_sh, _, donate = steps.build_cell(
        cfg, Shape("decode", seq, b, "decode"), mesh)
    sharded = jax.jit(fn, in_shardings=in_sh, donate_argnums=donate)
    plain = jax.jit(model.decode_step)
    placed = jax.device_put(params, in_sh[0])
    out = {}
    for tag, step, p, put_cache, put_tokens in (
            ("", sharded,
             placed, lambda c: jax.device_put(c, in_sh[1]),
             lambda t: jax.device_put({"tokens": t}, in_sh[2])),
            ("plain_", lambda p, c, t: plain(p, c, t["tokens"]),
             params, lambda c: c, lambda t: {"tokens": t})):

        def fresh(cross=False):
            caches = model.init_cache(b, seq, dtype=jnp.float32)
            if cross and f"{c}__cross_k" in case:
                caches["cross"] = {"k": jnp.asarray(case[f"{c}__cross_k"]),
                                   "v": jnp.asarray(case[f"{c}__cross_v"])}
            return put_cache(caches)

        def feed(t):
            return put_tokens(jnp.asarray(t, jnp.int32))

        def put(out):
            return out[0], put_cache(out[1])

        caches, logits = fresh(cross=True), []
        for t in range(tokens.shape[1]):
            lg, caches = put(step(p, caches, feed(tokens[:, t:t + 1])))
            logits.append(np.asarray(lg))
        out[f"{c}__{tag}logits"] = np.stack(logits)
        for i, leaf in enumerate(jax.tree.leaves(caches)):
            out[f"{c}__{tag}cache{i}"] = np.asarray(leaf)
        # repro.serve.engine.DecodeEngine.generate's loop, on this cell
        caches = fresh()
        for t in range(prompts.shape[1]):
            lg, caches = put(step(p, caches, feed(prompts[:, t:t + 1])))
        last = np.asarray(jnp.argmax(lg, -1))[:, None]
        generated = np.zeros((b, gen), np.int32)
        for t in range(gen):
            generated[:, t] = last[:, 0]
            lg, caches = put(step(p, caches, feed(last)))
            last = np.asarray(jnp.argmax(lg, -1))[:, None]
        out[f"{c}__{tag}generated"] = generated
    return out


def main(case_path: str, out_path: str) -> None:
    case = np.load(case_path)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    with use_mesh(mesh):
        for c in json.loads(str(case["names"])):
            out.update(run_case(case, c, mesh))
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
