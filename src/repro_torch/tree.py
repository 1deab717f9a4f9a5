"""Nested params trees (dicts, lists and tuples of tensors) in the JAX
package's leaf order: dict keys sorted, lists and tuples in order, None
holding no leaf, as ``jax.tree_util`` flattens them.  The checkpoint
reader and the weight converter map leaves one for one in this order."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def leaves(tree) -> List[Any]:
    return list(_iter_leaves(tree))


def _iter_leaves(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _iter_leaves(t)
    elif tree is not None:
        yield tree


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(``"/key/0/..."`` path, leaf) of every leaf, in leaf order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaves_with_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree)
                for pl in leaves_with_paths(t, f"{prefix}/{i}")]
    return [] if tree is None else [(prefix, tree)]


def map_tree(fn: Callable[[Any], Any], tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])


def unflatten(like, new_leaves):
    """A tree shaped like ``like`` holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [_rebuild(t, it) for t in tree]
        return items if isinstance(tree, list) else tuple(items)
    if tree is None:
        return None
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the tree holds") from None
