"""Parameter trees: nested dicts, lists and tuples with tensors (or other
values) at the leaves, the port's stand-in for the JAX package's
pytrees. Leaves are visited in the order ``jax.tree_util`` flattens a
pytree of the same shape: dict keys sorted, sequences in order."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def _children(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def flatten(tree, upto=None) -> Tuple[List[Path], List[Any]]:
    """``(paths, leaves)`` of ``tree``. With ``upto`` (a tree whose
    structure is a prefix of ``tree``'s), stop at ``upto``'s leaves and
    return the subtrees there (``flatten_up_to`` of ``jax.tree_util``)."""
    paths, leaves = [], []

    def walk(node, ref, path):
        kids = _children(ref if upto is not None else node)
        if kids is None:
            paths.append(path)
            leaves.append(node)
            return
        for key, sub in kids:
            walk(node[key], sub, path + (key,))

    walk(tree, upto, ())
    return paths, leaves


def leaves(tree) -> List[Any]:
    return flatten(tree)[1]


def unflatten(tree_like, new_leaves):
    """A tree shaped as ``tree_like`` with ``new_leaves`` in flatten
    order."""
    it = iter(new_leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            return {k: build(v) for k, v in kids}
        out = [build(v) for _, v in kids]
        return tuple(out) if isinstance(node, tuple) else out

    out = build(tree_like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``
    (same structure)."""
    others = [flatten(t, upto=tree)[1] for t in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others)])
