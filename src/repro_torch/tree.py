"""Parameter-tree helpers with JAX's flatten order.

The port keeps its model and training state as nested Python containers
of tensors, as the reference keeps pytrees.  Flattening follows
``jax.tree.flatten``: dict leaves in sorted key order, tuples, lists and
NamedTuples in field order, ``None`` a node without leaves, anything else
a leaf.  Optimizer updates walk leaves in that order, and checkpoints
store them in it, so a checkpoint of either package restores into the
other (``repro_torch.checkpoint``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["flatten", "unflatten", "tree_map", "leaves"]


_LEAF = object()                   # a leaf's place in a tree structure


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _structure(tree, out: List[Any]):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _structure(tree[k], out) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_structure(v, out) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_structure(v, out) for v in tree)
    out.append(tree)
    return _LEAF


def flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` in JAX's order; ``treedef`` rebuilds the tree
    with :func:`unflatten`."""
    out: List[Any] = []
    return out, _structure(tree, out)


def unflatten(treedef, leaves) -> Any:
    """The tree of ``treedef`` with its leaves taken from ``leaves`` in
    order (dict keys come back sorted)."""
    it = iter(leaves)

    def build(node):
        if node is _LEAF:
            return next(it)
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        return type(node)(build(v) for v in node)

    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree structure holds")
    return out


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure)."""
    flat, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"tree_map: {len(o)} leaves against "
                             f"{len(flat)}")
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])
