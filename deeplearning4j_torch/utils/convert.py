"""Carry weights and state from the JAX package into the port.

``load_numpy_params(net, params_tree_np)`` takes the JAX package's
``net.params_tree`` converted leaf by leaf to numpy arrays (e.g.
``jax.tree_util.tree_map(np.asarray, jax_net.params_tree)``) and installs
it as the port net's ``params_tree``: nested ``{"layer_i": {name:
array}}`` for a ``MultiLayerNetwork``, ``{vertex name: {name: array}}``
for a ``ComputationGraph``.  Names and layouts are shared (``Wqkv`` [d,
3d], head ``W`` [d, V], conv ``W`` HWIO, recurrent ``W`` [n_in, 4h] and
``R`` [h, 4h], PReLU ``alpha`` (1 on shared axes), the locally connected
layers' per-position ``W`` [oh, ow, c*kh*kw, n_out] / [ot, f*k, n_out],
Conv3D ``W`` DHWIO, the VAE's ``enc{i}``/``mu``/``logvar``/``dec{i}``/
``recon`` ``_W``/``_b``, the center loss's ``centers`` [n_out, n_in],
the learned queries ``Q`` [n_queries, heads * head_size]), so no leaf is
transposed; every leaf is checked against
the layer's ``param_shapes()`` (nested for ``Bidirectional``'s ``fwd`` /
``bwd``), and a layer or vertex without parameters takes an empty dict.  The net's state starts
as each layer's ``init_state``.

``load_numpy_state(net, state_tree_np)`` installs the JAX package's
``state_tree`` the same way (the batch-norm running mean and variance),
checked against what ``init_state`` builds.

``load_numpy_opt_state(net, opt_state_np)`` does the same for the JAX
package's ``opt_state`` of any updater (Adam's ``{"m": params-like, "v":
params-like}``, AMSGrad's ``vhat``, AdaMax's ``u``, RmsProp's and
AdaGrad's ``g2``, Ema's nested ``{"base": <base state>, "ema":
params-like}``), checked against the structure the net's own updater
builds — after the three calls the two packages start a step from the
same state.

``samediff_from_dict(d, values=None, device=None)`` builds the port's
``SameDiff`` from the JAX package's ``sd.to_portable_dict()`` (structure
and values, control-flow subgraphs included) and, optionally, its
``sd.values`` (e.g. after a fine-tune there), so an imported or trained
graph carries across with its weights.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_torch.runtime.backend import resolve_device
from deeplearning4j_torch.utils.trees import iter_leaves, set_path


def _named_layers(net):
    """(tree key, layer or None) for every entry of the net's trees: the
    ``layer_i`` keys of a ``MultiLayerNetwork``, the vertex names of a
    ``ComputationGraph`` (None for a combining vertex)."""
    if hasattr(net, "vertex_names"):
        return [(name, net.conf.vertices[name].layer)
                for name in net.vertex_names()]
    return [(f"layer_{i}", ly) for i, ly in enumerate(net.layers)]


def _checked_leaves(what, key, kind, given, want, dev):
    """``given`` (a layer's numpy leaves) as tensors on ``dev``, checked
    against ``want`` ({name: shape}, nested for a wrapper such as
    ``Bidirectional``'s ``{"fwd": {...}, "bwd": {...}}``)."""
    if set(given) != set(want):
        raise ValueError(
            f"{key} ({kind}): {what} {sorted(given)} do not match the "
            f"configuration's {sorted(want)}")
    leaves = {}
    for name, shape in want.items():
        if isinstance(shape, dict):
            leaves[name] = _checked_leaves(what, f"{key}/{name}", kind,
                                           given[name], shape, dev)
            continue
        arr = np.asarray(given[name])
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{key}/{name}: shape {arr.shape}, "
                             f"configuration wants {tuple(shape)}")
        leaves[name] = torch.from_numpy(np.array(arr)).to(dev)
    return leaves


def _checked_tree(what, named, given_tree, want_of, dev):
    tree = {}
    for key, ly in named:
        kind = type(ly).__name__ if ly is not None else "vertex"
        tree[key] = _checked_leaves(
            what, key, kind, given_tree.get(key, {}),
            want_of(ly) if ly is not None else {}, dev)
    extra = set(given_tree) - set(tree)
    if extra:
        raise ValueError(f"{what} for unknown layers {sorted(extra)}")
    return tree


def load_numpy_params(net, params_tree_np, device=None):
    """Install a numpy params tree on ``net`` (on ``device``; default the
    net's own device, else ``"cuda"``) and reset its state to each
    layer's ``init_state``.  Returns ``net``."""
    dev = resolve_device(device if device is not None
                         else (net.device or "cuda"))
    named = _named_layers(net)
    net.params_tree = _checked_tree("params", named, params_tree_np,
                                    lambda ly: ly.param_shapes(), dev)
    net.state_tree = {key: (ly.init_state(dev) if ly is not None else {})
                      for key, ly in named}
    net.device = dev
    return net


def load_numpy_state(net, state_tree_np):
    """Install a numpy state tree (the JAX package's ``state_tree``: the
    batch-norm ``mean``/``var``) on ``net``, on the device of its params,
    which must be installed first.  Returns ``net``."""
    if net.params_tree is None:
        raise ValueError("load the params first (load_numpy_params)")
    net.state_tree = _checked_tree(
        "state", _named_layers(net), state_tree_np,
        lambda ly: {k: tuple(v.shape)
                    for k, v in ly.init_state("cpu").items()}, net.device)
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


def samediff_from_dict(d: dict, values=None, device=None):
    """The port's ``SameDiff`` from a portable dict (the JAX package's
    ``to_portable_dict()``), its values replaced by ``values`` (name ->
    array) where given; every given name must be a VARIABLE or
    CONSTANT of the graph, at its shape."""
    from deeplearning4j_torch.autodiff.samediff import SameDiff
    sd = SameDiff.from_portable_dict(d, device=device)
    for name, value in (values or {}).items():
        value = np.asarray(value)
        if name not in sd.values:
            raise KeyError(f"samediff_from_dict: {name!r} is not a "
                           "VARIABLE or CONSTANT of the graph")
        if value.shape != np.shape(sd.values[name]):
            raise ValueError(
                f"samediff_from_dict: {name!r} has shape {value.shape}, "
                f"the graph's is {np.shape(sd.values[name])}")
        sd.values[name] = value
    return sd
