"""Nested-dict parameter-tree helpers (port of
``deeplearning4j_tpu/utils/trees.py``): path-addressed access and the
deterministic leaf order of the flattened-params view, over dicts of
tensors."""
from __future__ import annotations

from typing import Dict, Iterator, Tuple


def iter_leaves(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator:
    """Yield ((path, ...), leaf) depth-first with sorted keys at each level
    — the deterministic order of the flattened-params view."""
    for k in sorted(tree.keys()):
        v = tree[k]
        if isinstance(v, dict):
            yield from iter_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def get_path(tree: Dict, path: str):
    """Resolve 'a/b/c' into nested dicts; returns None when absent."""
    node = tree
    for part in path.split("/"):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def set_path(tree: Dict, path, value) -> None:
    parts = path.split("/") if isinstance(path, str) else list(path)
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def deep_copy_dicts(tree):
    """Copy the dict skeleton (leaves shared) — safe to mutate structure."""
    if isinstance(tree, dict):
        return {k: deep_copy_dicts(v) for k, v in tree.items()}
    return tree


def map_leaves(fn, *trees):
    """``fn`` over the leaves of same-structure trees -> a new tree."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: map_leaves(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)
