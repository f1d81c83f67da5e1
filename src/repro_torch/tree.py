"""Nested containers of tensors, flattened and rebuilt in JAX's order.

The reference's parameter, optimiser and checkpoint trees are pytrees, and
``jax.tree_util`` orders their leaves so: dict keys sorted (recursively),
NamedTuple fields and list and tuple items in order. The port's trainer walks
the same trees in the same order, so that a sum over the leaves (the global
gradient norm) adds in the reference's order, and a checkpoint names each
leaf by the reference's path (``"/".join`` of dict keys, field names and
indices). Anything that is not a dict, list or tuple is a leaf.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Sequence, Tuple

__all__ = ["flatten_with_paths", "leaves", "unflatten", "path_key"]

Path = Tuple[Any, ...]


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any) -> Iterator[Tuple[Any, Any]]:
    """(key, child) pairs of a container in JAX's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield k, tree[k]
    elif _is_namedtuple(tree):
        yield from zip(tree._fields, tree)
    else:  # list or tuple
        yield from enumerate(tree)


def _is_container(x: Any) -> bool:
    return isinstance(x, (dict, list, tuple))


def flatten_with_paths(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """``[(path, leaf), ...]`` in JAX's leaf order."""
    if not _is_container(tree):
        return [(prefix, tree)]
    out: List[Tuple[Path, Any]] = []
    for k, child in _children(tree):
        out += flatten_with_paths(child, prefix + (k,))
    return out


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def path_key(path: Path) -> str:
    """A leaf's checkpoint key, as the reference's store forms it."""
    return "/".join(str(k) for k in path)


def unflatten(like: Any, new_leaves: Sequence[Any]) -> Any:
    """A tree shaped as ``like`` holding ``new_leaves`` (in JAX's order)."""
    it = iter(new_leaves)
    out = _rebuild(like, it)
    if next(it, _END) is not _END:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


_END = object()


def _rebuild(like: Any, it: Iterator[Any]) -> Any:
    if not _is_container(like):
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("unflatten: fewer leaves than the tree holds")
        return leaf
    if isinstance(like, dict):
        return {k: _rebuild(child, it) for k, child in _children(like)}
    items = [_rebuild(child, it) for _, child in _children(like)]
    if _is_namedtuple(like):
        return type(like)(*items)
    return type(like)(items)
