"""Elastic N->M checkpoint re-layout (port of
``deeplearning4j_tpu/parallel/elastic.py``): transforms between the
canonical per-layer tree and the pipeline-stacked ``{pre, blocks,
post}`` tree.

A checkpoint's PARAMS are always canonical — ``CheckpointListener``
syncs the model tree before capture.  The OPTIMIZER state is not: a
pipeline trainer captures its pipe-structured tree (``sync_opt``),
whose middle is ONE leaf per parameter stacked over the pipelined
layers, while every other trainer captures the per-layer structure.
Resuming on a different layout needs exactly one mechanical step —
restack or unstack that middle — and it is byte-preserving per layer:
the stacked leaf's ``[j]`` slice IS layer ``lo+j``'s leaf.  The
counters are world-agnostic (``batch_in_epoch`` counts GLOBAL batches,
the RNG stream advances once per global step), and the trainer raises
a typed ``ElasticWorldError`` when the global batch cannot divide over
a new data axis.  Works on nested dicts of tensors (or numpy arrays).
"""
from __future__ import annotations

import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_torch.utils.trees import iter_leaves, map_leaves

_PIPE_KEYS = frozenset(("pre", "blocks", "post"))
_LAYER_RE = re.compile(r"^layer_(\d+)$")


def _layer_indices(d: dict) -> Optional[list]:
    """Sorted layer indices when EVERY key is ``layer_<i>``, else None."""
    idx = []
    for k in d:
        m = _LAYER_RE.match(str(k))
        if m is None:
            return None
        idx.append(int(m.group(1)))
    return sorted(idx)


def is_pipe_layout(tree: Any) -> bool:
    """True for a ``{pre, blocks, post}`` pipeline-structured dict."""
    return isinstance(tree, dict) and set(tree) == _PIPE_KEYS


def pipe_run(tree: dict) -> Tuple[int, int]:
    """The ``(lo, hi)`` layer run a pipe-structured tree stacks:
    ``pre`` holds layers ``0..lo-1``, ``blocks`` stacks ``lo..hi-1``
    on its leading axis, ``post`` holds the rest."""
    if not is_pipe_layout(tree):
        raise ValueError("not a {pre, blocks, post} pipe tree")
    pre_idx = _layer_indices(tree["pre"])
    if pre_idx is None:
        # None (non-layer keys) is NOT the empty prefix []: silently
        # assuming lo=0 would relabel every stacked block one slot off
        raise ValueError(
            f"pipe 'pre' holds non-layer keys {sorted(tree['pre'])}")
    lo = (pre_idx[-1] + 1) if pre_idx else 0
    if pre_idx != list(range(lo)):
        raise ValueError(f"pipe 'pre' holds layers {pre_idx}, expected "
                         f"a contiguous prefix")
    leaves = [leaf for _, leaf in iter_leaves(tree["blocks"])] \
        if isinstance(tree["blocks"], dict) else [tree["blocks"]]
    if not leaves:
        raise ValueError("pipe 'blocks' has no leaves")
    n_blocks = int(leaves[0].shape[0])
    post_idx = _layer_indices(tree["post"])
    if post_idx is None or (post_idx
                            and post_idx[0] < lo + n_blocks):
        raise ValueError(
            f"pipe 'post' layers {post_idx} overlap the stacked run "
            f"[{lo}, {lo + n_blocks})")
    return lo, lo + n_blocks


def unstack_pipe(tree: dict) -> dict:
    """Pipe-structured → canonical per-layer (byte-preserving: layer
    ``lo+j``'s leaves are the stacked leaves' ``[j]`` slices)."""
    lo, hi = pipe_run(tree)
    out = {k: v for k, v in tree["pre"].items()}
    for j in range(hi - lo):
        out[f"layer_{lo + j}"] = map_leaves(
            lambda a, _j=j: a[_j], tree["blocks"])
    out.update(tree["post"])
    return out


def stack_leaves(*leaves):
    """One stacked leaf (tensors on the first leaf's device, or numpy)."""
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack([leaf.to(leaves[0].device) for leaf in leaves])
    return np.stack(leaves)


def stack_layers(tree: dict, lo: int, hi: int) -> dict:
    """Canonical per-layer → pipe-structured over the ``[lo, hi)``
    run (the inverse of :func:`unstack_pipe`)."""
    idx = _layer_indices(tree)
    if idx is None or not set(range(lo, hi)) <= set(idx):
        raise ValueError(
            f"per-layer tree (layers {idx}) does not cover the "
            f"pipelined run [{lo}, {hi})")
    stacked = map_leaves(
        stack_leaves, *[tree[f"layer_{i}"] for i in range(lo, hi)])
    return {"pre": {f"layer_{i}": tree[f"layer_{i}"] for i in range(lo)},
            "blocks": stacked,
            "post": {f"layer_{i}": tree[f"layer_{i}"]
                     for i in idx if i >= hi}}


def pipe_to_layers(tree: Any) -> Any:
    """Recursively replace every pipe-structured sub-dict with its
    per-layer expansion (optimizer states nest the params-like tree
    under updater keys — ``{"m": <params-like>, "v": ...}`` — so the
    transform applies wherever the shape appears)."""
    if isinstance(tree, dict):
        if is_pipe_layout(tree):
            return unstack_pipe(tree)
        return {k: pipe_to_layers(v) for k, v in tree.items()}
    return tree


def layers_to_pipe(tree: Any, lo: int, hi: int) -> Any:
    """Recursively replace every per-layer sub-dict covering the run
    with its pipe-structured stack (inverse of :func:`pipe_to_layers`
    for the same ``(lo, hi)``)."""
    if isinstance(tree, dict):
        idx = _layer_indices(tree)
        if idx is not None and set(range(lo, hi)) <= set(idx):
            return stack_layers(tree, lo, hi)
        return {k: layers_to_pipe(v, lo, hi) for k, v in tree.items()}
    return tree


def opt_layout(tree: Any) -> Optional[str]:
    """Classify an optimizer-state tree: ``"pipe"`` (contains a
    ``{pre, blocks, post}`` sub-dict), ``"layers"`` (contains a
    per-layer sub-dict), or None (empty / unrecognized — e.g. a
    ComputationGraph keyed by vertex names)."""
    if isinstance(tree, dict):
        if is_pipe_layout(tree):
            return "pipe"
        if tree and _layer_indices(tree) is not None:
            return "layers"
        for v in tree.values():
            hit = opt_layout(v)
            if hit is not None:
                return hit
    return None


def find_pipe_run(tree: Any) -> Optional[Tuple[int, int]]:
    """The ``(lo, hi)`` run of the first pipe-structured sub-dict."""
    if isinstance(tree, dict):
        if is_pipe_layout(tree):
            return pipe_run(tree)
        for v in tree.values():
            hit = find_pipe_run(v)
            if hit is not None:
                return hit
    return None


def convert_opt_layout(opt: Any, like: Any) -> Optional[Any]:
    """Re-lay ``opt`` into the layout of ``like`` (pipe ↔ per-layer);
    None when no conversion applies (same layout, or neither side is
    recognizably layered).  Leaves are never recomputed — only
    stacked/unstacked — so per-layer bytes are preserved."""
    have, want = opt_layout(opt), opt_layout(like)
    if have is None or want is None or have == want:
        return None
    if want == "layers":
        return pipe_to_layers(opt)
    run = find_pipe_run(like)
    if run is None:
        return None
    return layers_to_pipe(opt, *run)
