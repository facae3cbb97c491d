"""Carry weights from the JAX package into the port.

``load_numpy_params(net, params_tree_np)`` takes the JAX package's
``net.params_tree`` converted leaf by leaf to numpy arrays (nested
``{"layer_i": {name: array}}`` — e.g. ``jax.tree_util.tree_map(
np.asarray, jax_net.params_tree)``) and installs it as the port net's
``params_tree``.  Names and layouts are shared (``Wqkv`` [d, 3d], head
``W`` [d, V], ``EmbeddingLayer``'s ``W`` [n_in, n_out] and ``b``), so no
leaf is transposed; every leaf is checked against the layer's
``param_shapes()``, and a layer without parameters (pooling, activation,
dropout, loss) takes an empty dict.

``load_numpy_opt_state(net, opt_state_np)`` does the same for the JAX
package's ``opt_state`` (e.g. Adam's ``{"m": params-like, "v":
params-like}``), checked against the structure the net's own updater
builds — after both calls the two packages start a step from the same
state.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_torch.runtime.backend import resolve_device
from deeplearning4j_torch.utils.trees import iter_leaves, set_path


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


def load_numpy_opt_state(net, opt_state_np):
    """Install a numpy optimizer-state tree on ``net`` (on the device of
    its params, which must be installed first).  Every leaf's path and
    shape must match what the net's updater builds for its params.
    Returns ``net``."""
    if net.params_tree is None:
        raise ValueError("load the params first (load_numpy_params)")
    # imported here: optimize imports utils.trees, which imports this
    # package
    from deeplearning4j_torch.optimize.updaters import updater_from_dict
    updater = updater_from_dict(net.conf.global_conf.updater)
    want = dict(iter_leaves(updater.init_state(net.params_tree)))
    given = dict(iter_leaves(opt_state_np))
    if set(given) != set(want):
        raise ValueError(
            f"optimizer state paths {sorted('/'.join(p) for p in given)[:6]}"
            f"... do not match the {type(updater).__name__} updater's "
            f"{sorted('/'.join(p) for p in want)[:6]}...")
    tree = {}
    for path, ref in want.items():
        arr = np.asarray(given[path])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"opt_state {'/'.join(path)}: shape {arr.shape},"
                             f" params want {tuple(ref.shape)}")
        set_path(tree, path, torch.from_numpy(np.array(arr)).to(
            device=ref.device, dtype=ref.dtype))
    net.opt_state = tree
    return net
