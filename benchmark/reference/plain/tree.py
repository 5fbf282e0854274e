"""Helpers for nested parameter dicts (the port's counterpart of pytrees)."""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, Iterator, Tuple

SEP = "/"


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(``"a/b/c"`` path, leaf) pairs in insertion order."""
    for k, v in tree.items():
        path = f"{prefix}{SEP}{k}" if prefix else k
        if isinstance(v, dict):
            yield from tree_items(v, path)
        else:
            yield path, v


def tree_leaves(tree):
    return [v for _, v in tree_items(tree)]


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": x}`` → ``{"a": {"b": {"c": x}}}``."""
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split(SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def tree_digest(tree) -> str:
    """sha256 over every leaf's path and bytes, in order: equal exactly when
    two trees of tensors are bitwise equal (ranks of a mesh, say)."""
    h = hashlib.sha256()
    for k, t in tree_items(tree):
        h.update(k.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()
