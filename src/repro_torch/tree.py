"""Nested param and state trees: dicts, lists, tuples and named tuples with
tensors (or other leaves) at the bottom.

Leaves come in the order JAX's tree functions give them: dict keys
sorted, sequences and named tuples in order.  ``optim.adamw``, ``train.step``
and ``ft.checkpoint`` walk the port's trees through these.
"""

from __future__ import annotations


def flatten_with_path(tree, path=()):
    """[(path, leaf)], ``path`` the tuple of keys, indices and field names
    from the root to the leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in flatten_with_path(getattr(tree, f), path + (f,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves):
    """A tree shaped as ``like`` whose leaves are ``new_leaves`` (a
    sequence in :func:`leaves`' order)."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[build(getattr(node, f)) for f in node._fields])
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others)])
