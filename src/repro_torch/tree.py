"""Parameter trees of the port: nested dicts and lists of tensors.

The reference walks its pytrees with ``jax.tree``; the port's trees (the
parameters, their gradients, the optimizer's moments) are plain dicts and
lists, walked in insertion order by these two functions.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["leaves", "map_leaves"]


def leaves(tree: Any) -> Iterator[Any]:
    """The leaves of ``tree`` in order: dict values in insertion order, list
    and tuple items in sequence."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def map_leaves(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure, as a new tree
    of that structure."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)
