"""Flatten and rebuild the nested containers a checkpoint holds.

The reference flattens its trees with JAX's pytree utilities.  The
port's trees are nested ``dict`` / ``list`` / ``tuple`` containers
(namedtuples and ``OrderedDict`` included) of tensors or arrays, and
this module flattens them in JAX's order: a ``dict``'s keys sorted, an
``OrderedDict``'s in insertion order, sequences by index, ``None``
holding no leaf, anything else a leaf.  :func:`flatten_with_path` names
each leaf as JAX's ``keystr`` does (``['w']``, ``['opt'][0]``,
``['n'].x``), so a checkpoint's manifest is the reference's.
"""

from __future__ import annotations

import collections
from typing import Any

_LEAF = object()


def flatten_with_path(tree) -> tuple[list[tuple[str, Any]], Any]:
    """``([(keystr name, leaf), ...], structure)`` in JAX's order;
    :func:`unflatten` rebuilds a tree from the structure."""
    named: list[tuple[str, Any]] = []

    def walk(node, path: str):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = (list(node) if isinstance(node, collections.OrderedDict)
                    else sorted(node))
            return (type(node), keys,
                    [walk(node[k], f"{path}[{k!r}]") for k in keys])
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return (type(node), None, [walk(getattr(node, f), f"{path}.{f}")
                                       for f in node._fields])
        if isinstance(node, (list, tuple)):
            return (type(node), None, [walk(v, f"{path}[{i}]")
                                       for i, v in enumerate(node)])
        named.append((path, node))
        return _LEAF

    structure = walk(tree, "")
    return named, structure


def flatten(tree) -> tuple[list, Any]:
    """``(leaves, structure)``; :func:`unflatten` inverts it."""
    named, structure = flatten_with_path(tree)
    return [leaf for _, leaf in named], structure


def unflatten(structure, leaves) -> Any:
    """The tree of ``structure`` (from :func:`flatten`) over ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if node is _LEAF:
            return next(it)
        kind, keys, kids = node
        values = [build(k) for k in kids]
        if keys is not None:
            return kind(zip(keys, values))
        if hasattr(kind, "_fields"):
            return kind(*values)
        return kind(values)

    tree = build(structure)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the structure holds")
    return tree
