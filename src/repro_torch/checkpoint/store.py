"""Checkpoint save/restore with Paxos-committed manifests.

Write protocol (crash-safe without a coordinator):

  1. every host writes its param/opt shards to ``<dir>/step_<n>/...``
     (here: single-host np.savez per pytree leaf path),
  2. the *commit point* is the CAS on ``ckpt/<run>/latest`` in the
     replicated registry — a checkpoint exists iff its step was committed
     there.  Torn writes from crashed trainers are invisible: restore reads
     the committed step from the registry, never the filesystem listing.

This is the paper's exactly-once RMW applied to checkpointing: two racing
trainers (e.g. a restarted node plus its backup) cannot both commit step N,
and a reader never observes a half-written checkpoint.

The file format is the JAX reference's (``repro.checkpoint.store``), key
for key, so a checkpoint written by either package restores in the other.
A leaf's key is its path through the tree, joined by ``/``: dict keys in
sorted order (an ``OrderedDict`` in insertion order), list and tuple items
by index, NamedTuple fields as ``.field`` (``{"n": NT(a=4)}`` flattens to
``n/.a``); ``None`` is an empty subtree and stores nothing.  Leaves may be
numpy arrays, torch tensors or Python scalars.

Sharded state planes: with ``shards > 1`` every leaf whose trailing (lane)
axis the shard count divides is serialized as one ``<key>@shard<s>`` entry
per lane block — the same contiguous blocks the serve path's
:class:`~repro_torch.core.lanes.ShardMap` steers keys by, so each shard's
plane rows round-trip as a unit.  Restore is layout-agnostic: it accepts
whole leaves or any shard split and reassembles bit-identically, so a
checkpoint written at ``shards=4`` restores into a scalar stack and vice
versa.

Restore keeps the dtype of ``like``'s leaves.  (The reference casts
through ``jnp.asarray``, which with JAX's default of x64 off stores int64
leaves as int32; the values agree wherever they fit in 32 bits.)
"""

from __future__ import annotations

import collections
import os
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.coord.registry import PaxosRegistry


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(path element, child) pairs of a tree node, or None for a leaf."""
    if isinstance(node, collections.OrderedDict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _leaves(tree, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in the order and with the keys the reference's
    ``jax.tree_util.tree_flatten_with_path`` gives."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield "/".join(prefix), tree
        return
    for name, child in kids:
        yield from _leaves(child, prefix + (name,))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {key: _to_numpy(leaf) for key, leaf in _leaves(tree)}


def _rebuild(like, arrays: Iterator[Any]):
    """``like``'s structure with its leaves replaced, in flatten order."""
    if like is None:
        return None
    if isinstance(like, collections.OrderedDict):
        return type(like)((k, _rebuild(v, arrays)) for k, v in like.items())
    if isinstance(like, dict):
        return {k: _rebuild(like[k], arrays) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), arrays)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, arrays) for v in like)
    return next(arrays)


def shard_tree(flat: dict, shards: int) -> dict:
    """Split each leaf into per-shard lane blocks along its trailing axis.

    A leaf the shard count does not divide (or a scalar) stays whole —
    mirroring the serve path, where such an axis falls back to a single
    shard rather than a ragged split.
    """
    if shards <= 1:
        return dict(flat)
    out = {}
    for key, arr in flat.items():
        if arr.ndim and arr.shape[-1] % shards == 0 and arr.shape[-1]:
            for s, block in enumerate(np.split(arr, shards, axis=-1)):
                out[f"{key}@shard{s}"] = block
        else:
            out[key] = arr
    return out


def unshard_tree(data, key: str) -> np.ndarray:
    """Reassemble one leaf from ``data`` (a mapping / npz), whether it was
    stored whole or as ``<key>@shard<s>`` lane blocks."""
    if key in data:
        return data[key]
    blocks = []
    s = 0
    while f"{key}@shard{s}" in data:
        blocks.append(data[f"{key}@shard{s}"])
        s += 1
    if not blocks:
        raise KeyError(key)
    return np.concatenate(blocks, axis=-1)


def save(directory: str, run: str, step: int, tree: Any,
         registry: Optional[PaxosRegistry] = None,
         shards: int = 1) -> bool:
    """Write shards, then commit via CAS.  Returns True iff we won the
    commit (a racing trainer may have committed this step first).
    ``shards > 1`` serializes each leaf as per-shard lane blocks (see the
    module docstring)."""
    path = os.path.join(directory, run, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "shards.npz"),
             **shard_tree(_flatten(tree), shards))
    if registry is None:
        return True
    return registry.commit_checkpoint(run, step)


def restore(directory: str, run: str, like: Any,
            registry: Optional[PaxosRegistry] = None,
            step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore the *committed* latest step (or an explicit one) into
    ``like``'s structure, each leaf with ``like``'s dtype (a torch tensor
    leaf comes back as a tensor on its device, any other as numpy)."""
    if step is None:
        if registry is None:
            raise ValueError("need a registry or an explicit step")
        step = registry.latest_checkpoint(run)
    if step <= 0:
        return like, 0
    path = os.path.join(directory, run, f"step_{step:08d}", "shards.npz")
    out = []
    with np.load(path) as data:
        for key, leaf in _leaves(like):
            arr = np.asarray(unshard_tree(data, key))
            shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
            if arr.shape != shape:
                raise ValueError(f"checkpoint leaf {key!r} has shape "
                                 f"{arr.shape}, the tree wants {shape}")
            if isinstance(leaf, torch.Tensor):
                arr = torch.from_numpy(arr).to(dtype=leaf.dtype,
                                               device=leaf.device)
            else:
                arr = arr.astype(np.asarray(leaf).dtype)
            out.append(arr)
    return _rebuild(like, iter(out)), step
