"""Nested dict / tuple trees of tensors — the port's pytrees.

Leaves come in JAX's flatten order: dict entries by sorted key, tuple
and list entries by position.  The checkpoint store writes leaves in
this order, so a checkpoint of either package restores in the other.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, tuple, list))


def leaves(tree) -> Iterator[Any]:
    """The leaves of ``tree`` in JAX's flatten order."""
    if is_leaf(tree):
        yield tree
        return
    for _, v in _children(tree):
        yield from leaves(v)


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's flatten order; a path joins the keys and
    indices from the root with "/" ("0/stack/1/mixer/wq")."""
    if is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for k, v in _children(tree):
        out.extend(flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def unflatten(tree_like, values) -> Any:
    """A tree of ``tree_like``'s structure holding ``values`` (an
    iterator, consumed in flatten order)."""
    if is_leaf(tree_like):
        return next(values)
    if isinstance(tree_like, dict):
        return {k: unflatten(tree_like[k], values) for k in sorted(tree_like)}
    return type(tree_like)(unflatten(v, values) for v in tree_like)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree``, with the matching subtrees of
    ``rest`` (whatever lies at a leaf's place in them: a leaf, or a whole
    subtree such as an int8 moment's {"q", "s"})."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                      for i, v in enumerate(tree))


def treedef_str(tree) -> str:
    """The structure of ``tree`` in the form of ``str(jax.tree.structure)``
    (what a checkpoint's manifest records)."""
    def inner(t):
        if is_leaf(t):
            return "*"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {inner(t[k])}"
                                   for k in sorted(t)) + "}"
        items = [inner(v) for v in t]
        if isinstance(t, list):
            return "[" + ", ".join(items) + "]"
        return "(" + ", ".join(items) + ("," if len(items) == 1 else "") + ")"
    return f"PyTreeDef({inner(tree)})"

