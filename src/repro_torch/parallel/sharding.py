"""Logical-axis sharding rules, resolved over a mesh.

Port of ``repro.parallel.sharding``.  Parameters, caches and inputs carry
*logical* axis names (``LM.param_specs``, ``launch/steps.py``); the rule
table maps them onto mesh axes.  The mesh may or may not have a "pod"
axis (multi-pod layouts shard the batch over ("pod", "data")).

Layout strategy (2-D sharding, MaxText-style):
  * batch        -> ("pod", "data")      activations
  * embed/mlp    -> "model"              tensor-parallel param dim
  * fsdp         -> "data"               params' second shard dim (ZeRO-ish)
  * experts      -> "model"              expert-parallel MoE
  * heads        -> "model"              attention head parallelism
  * seq          -> "data"               sequence parallelism for long decode

A mesh is either a ``torch.distributed`` ``DeviceMesh`` (ranks in a
process group; what :func:`repro_torch.models.blocks.apply_moe_shardmap`
runs its collectives over) or a :class:`MeshShape`: axis names and sizes
with no devices, so a 16 x 16 or a 2 x 16 x 16 layout resolves without
512 processes (the dry run).

A resolved spec is a plain tuple with one entry a tensor dim: ``None``,
an axis name, or a tuple of names, entry for entry the reference's
``PartitionSpec``.  :func:`placements` turns it into DTensor placements
(one a mesh dim).

Real tensors go onto a ``DeviceMesh`` as DTensors: :func:`distribute`
places a tree by a tree of :class:`NamedSharding` (``launch/steps.py``
``place_cell``), and :func:`shard`, the reference's constraint, lays an
activation out by logical axes.  In XLA it is a hint to the SPMD
partitioner; under DTensor it is a redistribute, and it is needed: without
it DTensor's own propagation can leave a layout an operator cannot take
(the MLP's ``[B*S, d]`` input sharded with a stride).  A plain tensor is
the mesh-of-one case: :func:`shard` returns it as it is, and the model
code runs the same operations on either.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor, Replicate, Shard, distribute_tensor,
)

# logical axis -> preferred mesh axes, first available wins
RULES = {
    "batch": (("pod", "data"),),
    "seq": (("data",),),
    "embed": (("model",),),
    "embed_fsdp": (("data",),),
    "mlp": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "vocab": (("model",),),
    "experts": (("model",),),
    "expert_mlp": (("model",),),    # TP-within-expert strategy (mixtral)
    "stack": ((),),                 # scan-stacked layer dim: never sharded
    # serve-plane logical axes (repro.serve.paxos.cluster_engine): the lane
    # axis of a PlaneStack block-partitions over the "shard" mesh axis —
    # contiguous lane blocks == ShardMap shard blocks by construction;
    # plane-field and machine axes are never sharded.
    "lanes": (("shard",),),
    "plane_fields": ((),),
    "machines": ((),),
    None: ((),),
}

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind them."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} against sizes {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


Mesh = Union[DeviceMesh, MeshShape]


def mesh_axes(mesh: Mesh) -> Tuple[str, ...]:
    if isinstance(mesh, MeshShape):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names or ())


def mesh_axis_sizes(mesh: Mesh) -> Dict[str, int]:
    """{axis name: size} for either kind of mesh."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    # ``size(d)``, not ``mesh.mesh.shape``: the mesh tensor is rebuilt at
    # each read, a cost every constraint of a step paid
    return {a: mesh.size(d) for d, a in enumerate(mesh_axes(mesh))}


def mesh_size(mesh: Mesh) -> int:
    return math.prod(mesh_axis_sizes(mesh).values())


def is_logical_spec(x) -> bool:
    """Leaf predicate for spec trees: a tuple of axis names / None."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def spec_map(fn: Callable[..., Any], specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree (dicts, tuples and
    NamedTuples down to :func:`is_logical_spec` or :class:`NamedSharding`
    leaves) and trees of the same structure; ``None`` stays ``None``."""
    if specs is None:
        return None
    if is_logical_spec(specs) or isinstance(specs, NamedSharding):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: spec_map(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(spec_map(fn, v, *(t[i] for t in trees))
                             for i, v in enumerate(specs)))
    if isinstance(specs, tuple):
        return tuple(spec_map(fn, v, *(t[i] for t in trees))
                     for i, v in enumerate(specs))
    raise TypeError(f"not a spec tree node: {specs!r}")


def resolve(logical: Tuple[Optional[str], ...], mesh: Mesh,
            shape: Optional[Tuple[int, ...]] = None) -> Spec:
    """Map logical axes to a spec valid for this mesh.

    With ``shape`` given, the resolution is divisibility-aware: a dim whose
    size the chosen mesh axes do not divide falls back to a shorter axis
    prefix, and to replication if nothing divides (e.g. 8 KV heads on a
    16-way model axis, or whisper's 51866 vocab).
    """
    present = set(mesh_axes(mesh))
    sizes = mesh_axis_sizes(mesh)
    out = []
    for i, name in enumerate(logical):
        spec: Tuple[str, ...] = ()
        for cand in RULES.get(name, ((),)):
            axes = tuple(a for a in cand if a in present)
            if not axes:
                continue
            if shape is not None:
                dim = shape[i]
                while axes:
                    if dim % math.prod(sizes[a] for a in axes) == 0:
                        break
                    axes = axes[:-1]
                if not axes:
                    continue
            spec = axes
            break
        if len(spec) == 0:
            out.append(None)
        elif len(spec) == 1:
            out.append(spec[0])
        else:
            out.append(spec)
    return tuple(out)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh: Mesh) -> tuple:
    """DTensor placements of a resolved spec: for each mesh dim in order,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names it, else
    ``Replicate()``.  A dim split over several axes (("pod", "data")) is
    sharded by each, major axis first, as the mesh orders them."""
    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            if a in owner:
                raise ValueError(f"mesh axis {a!r} shards two dims: {spec}")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh_axes(mesh))


def shard_shape(shape: Tuple[int, ...], spec: Spec,
                mesh: Mesh) -> Tuple[int, ...]:
    """The per-device block of a ``shape`` tensor laid out by ``spec``."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for d, dim in enumerate(shape):
        n = math.prod(sizes[a] for a in _entry_axes(
            spec[d] if d < len(spec) else None))
        if dim % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"into {n} shards ({spec})")
        out.append(dim // n)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout over a mesh: the resolved spec, one entry a
    tensor dim (as ``jax.sharding.NamedSharding(mesh, spec)``)."""
    mesh: Mesh
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return shard_shape(shape, self.spec, self.mesh)


def named_sharding(mesh: Mesh, *logical: Optional[str]) -> NamedSharding:
    """The layout of a tensor whose dims carry the ``logical`` axis names
    (resolved without a shape: no divisibility fallback)."""
    return NamedSharding(mesh, resolve(tuple(logical), mesh))


_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost :func:`use_mesh` block, or None."""
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Activate ``mesh`` for the block; the previous one comes back on
    exit, an exception included."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


# ---------------------------------------------------------------------------
# DTensor: placing trees, constraining activations
# ---------------------------------------------------------------------------

def distribute(tree, shardings, mesh: DeviceMesh):
    """A tree of whole tensors placed on ``mesh`` by a tree of
    :class:`NamedSharding` of the same structure: each leaf becomes a
    DTensor whose local block this rank cuts from the whole tensor it
    holds (``distribute_tensor`` with no source rank, so no collective:
    every rank must hold the same values, as a seed or a converted tree
    gives them).  A block that is part of the whole tensor is copied out,
    so that dropping the whole frees it; a replicated leaf's block is the
    whole tensor itself.  A sharding's mesh may be a :class:`MeshShape`;
    its axes must be ``mesh``'s, in order."""
    def place(sh: NamedSharding, t: torch.Tensor) -> DTensor:
        if mesh_axes(sh.mesh) != mesh_axes(mesh):
            raise ValueError(f"a sharding over {mesh_axes(sh.mesh)} placed "
                             f"on a mesh over {mesh_axes(mesh)}")
        d = distribute_tensor(t, mesh, sh.placements, src_data_rank=None)
        local = d.to_local()
        if local.untyped_storage().nbytes() > \
                local.numel() * local.element_size() > 0 and \
                local.numel() < t.numel():
            d = DTensor.from_local(local.clone(), mesh, d.placements,
                                   run_check=False, shape=d.shape,
                                   stride=d.stride())
        return d

    return spec_map(place, shardings, tree)


def shard(x: torch.Tensor, logical: Tuple[Optional[str], ...], *,
          sizes: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """The reference's ``shard`` (``with_sharding_constraint`` by logical
    axes): a DTensor is redistributed to the placements of ``logical``
    resolved divisibility-aware against its own mesh (the reference's
    ``mesh`` argument names the mesh it constrains over; a DTensor lives
    on one), so a dim its axes do not divide replicates.  ``sizes`` judges
    divisibility on other sizes than x's (the head count of a flattened
    heads x head-dim dim).  A plain tensor comes back unchanged.

    The redistribute runs even where x already has the layout: its
    backward lays the gradient out as x was, which keeps DTensor's choice
    for the gradient from splitting a dim a later view cannot take."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sizes = tuple(x.shape) if sizes is None else tuple(sizes)
    return x.redistribute(mesh, placements(resolve(logical, mesh,
                                                   shape=sizes), mesh))


def replicate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, a constant every rank computes whole, as a DTensor replicated
    over ``like``'s mesh when ``like`` is a DTensor; ``t`` itself when it
    is not."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
