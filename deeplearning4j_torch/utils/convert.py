"""Carry weights from the JAX package into the port.

``load_numpy_params(net, params_tree_np)`` takes the JAX package's
``net.params_tree`` converted leaf by leaf to numpy arrays (nested
``{"layer_i": {name: array}}`` — e.g. ``jax.tree_util.tree_map(
np.asarray, jax_net.params_tree)``) and installs it as the port net's
``params_tree``.  Names and layouts are shared (``Wqkv`` [d, 3d], head
``W`` [d, V]), so no leaf is transposed; every leaf is checked against
the layer's ``param_shapes()``.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_torch.runtime.backend import resolve_device


def load_numpy_params(net, params_tree_np, device=None):
    """Install a numpy params tree on ``net`` (on ``device``; default the
    net's own device, else ``"cuda"``).  Returns ``net``."""
    dev = resolve_device(device if device is not None
                         else (net.device or "cuda"))
    tree = {}
    for i, ly in enumerate(net.layers):
        lname = f"layer_{i}"
        given = params_tree_np.get(lname, {})
        want = ly.param_shapes()
        if set(given) != set(want):
            raise ValueError(
                f"{lname} ({type(ly).__name__}): params {sorted(given)} "
                f"do not match the configuration's {sorted(want)}")
        leaves = {}
        for name, shape in want.items():
            arr = np.asarray(given[name])
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"{lname}/{name}: shape {arr.shape}, "
                                 f"configuration wants {tuple(shape)}")
            leaves[name] = torch.from_numpy(np.array(arr)).to(dev)
        tree[lname] = leaves
    extra = set(params_tree_np) - set(tree)
    if extra:
        raise ValueError(f"params for unknown layers {sorted(extra)}")
    net.params_tree = tree
    net.state_tree = {f"layer_{i}": {} for i in range(len(net.layers))}
    net.device = dev
    return net
