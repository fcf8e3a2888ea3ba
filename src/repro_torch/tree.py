"""Trees of the port: nested dicts whose leaves are tensors, ParamSpecs,
axes tuples or anything else that is not a dict.  Leaves are visited in
sorted-key order, ``jax.tree.leaves``'s order for dicts, which is the one
order the train step's gradients, the optimizer, the checkpoint keys and
the sharding tables share.
"""

from __future__ import annotations

__all__ = ["tree_map", "tree_items", "tree_leaves", "tree_unflatten"]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``
    (the same structure), as nested dicts of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_items(tree, path: tuple = ()):
    """(path, leaf) pairs in sorted-key order; a path is a tuple of keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    """The leaves in sorted-key order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(like, leaves):
    """Nested dicts of ``like``'s structure over ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
