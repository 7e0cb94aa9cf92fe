"""Parameter trees: nested NamedTuples (and dicts) of tensors, with None
for absent leaves — the port's counterpart of JAX pytrees.

Leaf order and paths follow ``jax.tree_util``: NamedTuple fields in order,
dict keys sorted, None skipped; a path joins field names / keys with "/".
"""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure), in leaf order; None stays
    None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, tuple):
        parts = [tree_map(fn, *p) for p in zip(tree, *rest)]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    return fn(tree, *rest)


def tree_items(tree, prefix: str = ""):
    """[(path, leaf)] in ``jax.tree_util`` order, None leaves skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or \
            [str(i) for i in range(len(tree))]
        return [item for name, sub in zip(names, tree)
                for item in tree_items(sub, f"{prefix}{name}/")]
    return [(prefix[:-1], tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten_like(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
