"""Step functions (train, prefill, decode) and their shardings.

Port of ``repro.launch.steps``.  PyTorch runs eagerly, so there is nothing
to jit or lower: each ``make_*`` builder returns a plain callable.  The
sharding helpers give, for an (arch, shape, mesh) cell, the layout of
every argument as a :class:`~repro_torch.parallel.sharding.NamedSharding`
(the resolved spec, with ``.placements`` for DTensor and
``.shard_shape``), over a ``DeviceMesh`` or a ``MeshShape``.
:func:`build_cell` assembles them with ``meta`` tensors for the dry run
(``launch/dryrun.py``).  The same shardings place a cell for real, as the
reference's module says they are "used identically by the real
trainer/server and the dry-run": :func:`place_cell` puts a cell's
parameters, optimizer state (train), caches (decode) and batch on a
``DeviceMesh`` as DTensors, and the step it returns (``make_train_step``,
``make_prefill`` or ``make_decode_step``, unchanged) runs on them, each
rank on its blocks.  :func:`decode_inputs` lays out a decode run's caches
and tokens for plain or placed parameters (``serve/engine.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.configs.shapes import Shape
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model, input_specs
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (
    Mesh, NamedSharding, distribute, mesh_axis_sizes, replicate_like,
    resolve, spec_map,
)
from repro_torch.tree import leaves, unflatten


# ---------------------------------------------------------------------------
# Abstract init: shapes + specs without allocating a single parameter
# ---------------------------------------------------------------------------

def abstract_init(model, dtype: torch.dtype = torch.bfloat16):
    """(the parameter tree on the ``meta`` device, its logical specs)."""
    return model.param_shapes(dtype), model.param_specs()


def param_shardings(specs, shapes, mesh: Mesh):
    return spec_map(lambda spec, t: NamedSharding(
        mesh, resolve(spec, mesh, shape=tuple(t.shape))), specs, shapes)


BATCH_AXES = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "vision_embeds": ("batch", None, None),
    "mrope_positions": (None, "batch", None),
    "frames": ("batch", None, None),
}


def batch_shardings(spec_tree: Dict[str, Any], mesh: Mesh):
    """Shardings of the model inputs of ``registry.input_specs`` (a
    ``(shape, dtype)`` leaf each)."""
    return {k: NamedSharding(mesh, resolve(BATCH_AXES[k], mesh,
                                           shape=tuple(sd[0])))
            for k, sd in spec_tree.items()}


def _cache_axes(name: Optional[str], rank: int, seq_shard: bool):
    lead = (None,) * (rank - 4)
    if name in ("k", "v"):            # [..., B, H, S, D]
        return lead + (("batch", "kv_heads", "seq", None) if seq_shard
                       else ("batch", "kv_heads", None, None))
    if name in ("ssm", "wkv"):        # [..., B, H, N, P] / [..., B, nh, K, V]
        return lead + ("batch", "heads", None, None)
    if name == "conv":                # [..., B, K-1, C]
        return (None,) * (rank - 3) + ("batch", None, None)
    if name in ("last_t", "last_c"):
        return (None,) * (rank - 2) + ("batch", None)
    return (None,) * rank             # length scalars etc.


def _is_cache_leaf(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and \
        isinstance(x[1], torch.dtype)


def cache_shardings(model, mesh: Mesh, b: int, seq_len: int, *,
                    seq_shard: bool):
    """KV/state cache shardings, dispatched on the cache leaf's name.

    ``seq_shard`` (long-context decode, global_batch=1) shards the KV
    sequence dim over "data" — sequence parallelism — since the batch dim
    cannot shard.
    """
    def walk(node, name):
        if _is_cache_leaf(node):
            shape = tuple(node[0])
            ax = _cache_axes(name, len(shape), seq_shard)
            return NamedSharding(mesh, resolve(ax, mesh, shape=shape))
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return type(node)(walk(v, name) for v in node)

    return walk(model.cache_specs(b, seq_len), None)


def _meta(spec_tree):
    """``meta`` tensors for a tree of ``(shape, dtype)`` leaves."""
    if _is_cache_leaf(spec_tree):
        return torch.empty(tuple(spec_tree[0]), dtype=spec_tree[1],
                           device="meta")
    if isinstance(spec_tree, dict):
        return {k: _meta(v) for k, v in spec_tree.items()}
    return type(spec_tree)(_meta(v) for v in spec_tree)


def _value_and_grad(model, params, batch, remat: bool):
    """(loss, gradient leaves) of ``model.train_loss`` at ``params``."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    try:
        loss = model.train_loss(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, ps, materialize_grads=True)
    finally:
        for p in ps:
            p.requires_grad_(False)
    return loss.detach(), grads


def make_train_step(model, opt_cfg: adamw.AdamWConfig, *,
                    microbatches: int = 1, remat: bool = True):
    """(params, opt_state, batch) -> (params', opt_state', metrics).

    The update is :func:`repro_torch.optim.adamw.apply`'s, in place: the
    returned trees are the ones passed in.  ``microbatches > 1`` splits the
    batch's leading axis and accumulates float32 gradients over the parts,
    then divides by their count, as the reference's ``lax.scan`` does.
    """

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, g = _value_and_grad(model, params, batch, remat)
        else:
            def split(x):
                return x.reshape((microbatches,
                                  x.shape[0] // microbatches) + x.shape[1:])
            parts = {k: split(v) for k, v in batch.items()}
            ps = leaves(params)
            loss = replicate_like(torch.zeros((), dtype=torch.float32,
                                              device=ps[0].device), ps[0])
            g = [torch.zeros_like(p, dtype=torch.float32) for p in ps]
            for i in range(microbatches):
                l_i, g_i = _value_and_grad(
                    model, params, {k: v[i] for k, v in parts.items()}, remat)
                loss = loss + l_i
                g = [a + b for a, b in zip(g, g_i)]
            loss = loss / microbatches
            g = [a / microbatches for a in g]
        grads = unflatten(params, g)
        params, opt_state, metrics = adamw.apply(opt_cfg, params, grads,
                                                 opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def make_prefill(model):
    """(params, batch) -> last-position logits: ``frames`` and ``tokens``
    for the encoder-decoder family, ``tokens`` and the VLM inputs if any
    for an LM."""
    def prefill(params, batch):
        if model.cfg.family == "encdec":
            return model.prefill(params, batch["frames"], batch["tokens"])
        return model.prefill(params, batch["tokens"],
                             batch.get("vision_embeds"),
                             batch.get("mrope_positions"))
    return prefill


def make_decode_step(model):
    """(params, caches, batch) -> (logits, caches); one signature for both
    families (an ``EncDec``'s caches carry the encoder's keys and values)."""
    def decode(params, caches, batch):
        return model.decode_step(params, caches, batch["tokens"])
    return decode


# ---------------------------------------------------------------------------
# Cell assembly (used by the dry run)
# ---------------------------------------------------------------------------

def opt_state_specs(param_specs, opt_cfg: adamw.AdamWConfig):
    """ZeRO-1: the moments (and error residuals) take their parameters'
    specs; the step counter is replicated."""
    err = param_specs if opt_cfg.compress_grads else None
    return adamw.OptState(step=(), m=param_specs, v=param_specs, err=err)


def build_cell(cfg: ModelConfig, shape: Shape, mesh: Mesh,
               opt_cfg: Optional[adamw.AdamWConfig] = None,
               remat: bool = True):
    """(fn, meta args, in-shardings, out-shardings, donate) of one cell.

    The args are ``meta`` tensors (shapes and dtypes, nothing allocated):
    bf16 parameters, the optimizer state (train), the caches (decode) and
    the inputs.  Each sharding tree mirrors its argument; ``donate`` names
    the arguments a step may overwrite in place."""
    model = build_model(cfg)
    p_shapes, p_specs = abstract_init(model)
    p_shard = param_shardings(p_specs, p_shapes, mesh)
    inputs = input_specs(cfg, shape)
    b_shard = batch_shardings(inputs, mesh)
    batch = _meta(inputs)

    if shape.kind == "train":
        opt_cfg = opt_cfg or adamw.AdamWConfig(
            state_dtype=torch.bfloat16 if cfg.n_params() > 2e11
            else torch.float32)
        o_shapes = adamw.init(opt_cfg, p_shapes)
        o_shard = param_shardings(opt_state_specs(p_specs, opt_cfg),
                                  o_shapes, mesh)
        fn = make_train_step(model, opt_cfg, remat=remat)
        args = (p_shapes, o_shapes, batch)
        in_sh = (p_shard, o_shard, b_shard)
        donate = (0, 1)
        out_sh = (p_shard, o_shard, None)
    elif shape.kind == "prefill":
        fn = make_prefill(model)
        args = (p_shapes, batch)
        in_sh = (p_shard, b_shard)
        donate = ()
        out_sh = None
    else:
        seq_shard = shape.global_batch == 1
        c_shapes = _meta(model.cache_specs(shape.global_batch,
                                           shape.seq_len))
        c_shard = cache_shardings(model, mesh, shape.global_batch,
                                  shape.seq_len, seq_shard=seq_shard)
        # Decode is weight-stationary: params are read-only, so paying an
        # FSDP all-gather per generated token is pure waste.  Drop the
        # "embed_fsdp" (data-axis) shard dim whenever the model-axis-only
        # layout fits the per-device HBM budget.  kimi-k2's 1T params keep
        # the 2-D layout (130 GB/dev otherwise).
        per_dev = cfg.n_params() * 2 / mesh_axis_sizes(mesh).get("model", 1)
        if per_dev < 10e9:
            serve_specs = spec_map(
                lambda sp: tuple(None if a == "embed_fsdp" else a
                                 for a in sp), p_specs)
            p_shard = param_shardings(serve_specs, p_shapes, mesh)
        fn = make_decode_step(model)
        args = (p_shapes, c_shapes, batch)
        in_sh = (p_shard, c_shard, b_shard)
        donate = (1,)
        out_sh = (None, c_shard)
    return fn, args, in_sh, out_sh, donate


def init_placed(model, shardings, mesh: DeviceMesh):
    """``model.init(0, torch.float32)`` on ``mesh``'s device type, each
    leaf placed by its sharding (a tree like :func:`build_cell`'s
    ``in_sh[0]``) as soon as it is drawn, so a rank holds one whole leaf at
    a time beside its blocks.  The values are ``model.init``'s: the same
    draws in the same order."""
    made = []       # the meta pass's leaves, in the order drawn
    meta = model._init(None, torch.float32, torch.device("meta"),
                       lambda t: made.append(t) or t)
    by_id = {}
    spec_map(lambda sh, t: by_id.__setitem__(id(t), sh), shardings, meta)
    order = iter([by_id[id(t)] for t in made])
    return model.init(0, torch.float32, mesh.device_type,
                      place=lambda t: distribute(t, next(order), mesh))


def place_caches(model, mesh: DeviceMesh, b: int, seq_len: int):
    """``model.init_cache(b, seq_len, torch.float32)`` laid out by
    :func:`cache_shardings` (the KV sequence over "data" when ``b == 1``,
    as :func:`build_cell` lays out a decode cell): each rank makes only its
    block of every leaf, zeros, on ``mesh``'s device type."""
    shardings = cache_shardings(model, mesh, b, seq_len, seq_shard=b == 1)

    def make(sh: NamedSharding, spec):
        shape, dt = spec
        local = torch.zeros(sh.shard_shape(tuple(shape)), dtype=dt,
                            device=mesh.device_type)
        return DTensor.from_local(local, mesh, sh.placements,
                                  run_check=False)

    return spec_map(make, shardings,
                    model.cache_specs(b, seq_len, torch.float32))


def place_tokens(tokens: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """A decode step's tokens [B, 1], whole on every rank, laid out as a
    decode cell's (``BATCH_AXES``: batch over "data")."""
    sh = NamedSharding(mesh, resolve(BATCH_AXES["tokens"], mesh,
                                     shape=tuple(tokens.shape)))
    return distribute(tokens, sh, mesh)


def decode_inputs(model, params, b: int, seq_len: int, device):
    """A decode run's float32 caches and the layout of its tokens [B, 1],
    ``(caches, feed)``, for ``params``: on DTensors :func:`place_caches`
    and :func:`place_tokens` on their mesh, as a decode cell lays them
    out; on plain tensors ``model.init_cache`` on ``device`` and the
    tokens as given."""
    leaf = leaves(params)[0]
    if not isinstance(leaf, DTensor):
        return (model.init_cache(b, seq_len, dtype=torch.float32,
                                 device=device), lambda t: t)
    mesh = leaf.device_mesh
    return (place_caches(model, mesh, b, seq_len),
            lambda t: place_tokens(t, mesh))


def place_cell(cfg: ModelConfig, shape: Shape, mesh: DeviceMesh,
               batch: Dict[str, torch.Tensor], *, params=None,
               opt_cfg: Optional[adamw.AdamWConfig] = None):
    """(fn, args) of a cell placed on ``mesh`` by :func:`build_cell`'s
    shardings: ``fn(*args)`` runs the step.

    ``batch`` holds the cell's inputs whole (``registry.input_specs(cfg,
    shape)``'s shapes); ``params`` is a whole parameter tree on the mesh's
    device (such as ``models/convert.params_from_reference``'s), or
    ``None`` to draw a float32 one from seed 0 a leaf at a time
    (:func:`init_placed`).  Every rank must pass the same values: each
    keeps its own block of every leaf (a copy, where the block is part of
    the whole tensor), and a replicated leaf's block is the given tensor
    itself, which a train step updates in place.  A train cell's optimizer
    state is ``adamw.init`` of the placed parameters, so its moments
    follow them (ZeRO-1, :func:`opt_state_specs`).  A decode cell's
    parameters take the serve layout where :func:`build_cell` chooses it,
    and its caches are :func:`place_caches`' float32 zeros: args
    ``(params, caches, batch)``."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    fn, _, in_sh, _, _ = build_cell(cfg, shape, mesh, opt_cfg)
    model = build_model(cfg)
    if params is None:
        placed = init_placed(model, in_sh[0], mesh)
    else:
        placed = distribute(params, in_sh[0], mesh)
    inputs = distribute(batch, in_sh[-1], mesh)
    if shape.kind == "prefill":
        return fn, (placed, inputs)
    if shape.kind == "decode":
        caches = place_caches(model, mesh, shape.global_batch, shape.seq_len)
        return fn, (placed, caches, inputs)
    return fn, (placed, adamw.init(opt_cfg, placed), inputs)
