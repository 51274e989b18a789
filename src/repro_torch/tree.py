"""Parameter trees: nested dicts, tuples and lists of tensors.

The port's stand-in for the ``jax.tree`` calls the reference's optimizer
and step builders make.  Leaves are visited as ``jax.tree.leaves`` visits
them: dict entries in sorted key order, sequence items in order; ``None``
is an empty subtree.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    return list(_walk(tree))


def _walk(tree: Any) -> Iterator[Any]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k])
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _walk(t)
    else:
        yield tree


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree``'s structure with ``fn`` applied to every leaf."""
    return unflatten(tree, map(fn, leaves(tree)))


def unflatten(like: Any, values: Iterator[Any]) -> Any:
    """``like``'s structure with its leaves taken from ``values`` in
    :func:`leaves` order."""
    values = iter(values)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(t) for t in node))     # NamedTuple
        if isinstance(node, (tuple, list)):
            return type(node)(build(t) for t in node)
        return next(values)

    return build(like)
