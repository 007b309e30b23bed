"""Nested containers of tensors (the port's parameter and training-state
trees): dicts, NamedTuples and ``None``, the shapes the reference's pytrees
take.  Dict keys are walked in sorted order and each leaf is named by the
reference's ``jax.tree_util.keystr`` of its path (``['params']['embed']``,
``['opt'].m['embed']``), so leaf orders and names match the JAX package's."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_unzip(tree: Any, n: int) -> Tuple[Any, ...]:
    """A tree whose leaves are n-tuples → n trees (dicts only, as
    :func:`tree_map` returns over a parameter tree)."""
    if isinstance(tree, dict):
        parts = {k: tree_unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    return tuple(tree)


def tree_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` in the reference's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}[{k!r}]")
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from tree_paths(v, f"{prefix}.{name}")
    elif tree is not None:
        yield prefix, tree


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(template: Any, leaves: Iterator[Any]) -> Any:
    """``template``'s structure with its leaves taken in turn from ``leaves``
    (in :func:`tree_paths` order)."""
    if isinstance(template, dict):
        out = {k: tree_unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(tree_unflatten(v, leaves) for v in template))
    if template is None:
        return None
    return next(leaves)
