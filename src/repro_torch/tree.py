"""Nested-dict trees of tensors, the port's parameter and state layout:
leaves in JAX's flatten order (dict keys sorted, depth first), so a
tree's i-th leaf is the reference's i-th leaf of the same tree."""
from __future__ import annotations

__all__ = ["leaves", "unflatten", "structure"]


def leaves(tree) -> list:
    """The leaves of a nested dict (keys sorted; an empty dict has none)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten(like, flat) -> dict:
    """A tree shaped as ``like`` whose leaves are ``flat``, in
    ``leaves`` order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def structure(tree) -> str:
    """The tree's nesting as a string: keys in order, ``*`` a leaf."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"
