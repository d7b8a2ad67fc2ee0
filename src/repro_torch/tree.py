"""Minimal helpers for parameter trees: nested dicts of tensors."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over one or more trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the traversal order of :func:`tree_map`."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """Rebuild ``like``'s structure from ``leaves`` (``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_unstack(tree) -> list:
    """A tree of ``[m, ...]`` leaves -> ``m`` trees of ``[...]`` leaves,
    by one ``unbind`` per leaf: under autograd its backward stacks the
    slices' gradients once, where indexing slice by slice would fill a
    zero gradient of the whole leaf for every slice and add them up."""
    leaves = tree_leaves(tree)
    return [tree_unflatten(tree, list(parts))
            for parts in zip(*(leaf.unbind(0) for leaf in leaves))]
