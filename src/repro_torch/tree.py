"""Parameter trees: nested dicts, lists, tuples and NamedTuples of tensors.

The port's counterpart of the ``jax.tree_util`` calls the reference's
training code makes. The traversal order is JAX's: dict keys sorted,
sequences in order, NamedTuple fields in order, ``None`` an empty
subtree. ``flatten_with_path`` names each leaf as
``jax.tree_util.tree_flatten_with_path`` does (``['w']/[0]``,
``.mu``), so a checkpoint's leaf keys are the same in both packages.
"""
from __future__ import annotations


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """[(path element, child), ...], or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def _rebuild(node, children: list):
    if node is None:
        return None
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def flatten_with_path(tree) -> list:
    """[(path, leaf), ...] in JAX's order; path elements joined by ``/``."""
    kids = _children(tree)
    if kids is None:
        return [("", tree)]
    out = []
    for key, child in kids:
        for path, leaf in flatten_with_path(child):
            out.append((key + ("/" + path if path else ""), leaf))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_unflatten(like, leaves) -> object:
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(c) for _, c in kids])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    return _rebuild(tree, [
        tree_map(fn, c, *(o[i][1] for o in others))
        for i, (_, c) in enumerate(kids)])
