"""Nested dicts of tensors (parameter and optimizer trees) in the JAX
package's flatten order: a dict's keys sorted, depth first, as
``jax.tree.flatten`` orders them. Checkpoints list their leaves in this
order, so a checkpoint of either package restores into the other."""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def paths(tree: Any, prefix: str = "") -> List[str]:
    """Each leaf's "/"-joined key path, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], f"{prefix}/{k}")]
    return [prefix or "/"]


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(like: Any, flat: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``flat`` (in ``leaves`` order)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out
