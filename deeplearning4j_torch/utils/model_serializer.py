"""Model checkpointing (port of ``deeplearning4j_tpu/utils/model_serializer.py``).

The same zip as the reference: ``configuration.json`` (the model IR),
``coefficients.npz`` (the parameter tree, ``layer_i/name`` keys),
``state.npz`` (the batch-norm running statistics), ``updaterState.npz``
(the optimizer state, ``m/layer_i/W`` keys for Adam) and
``training.json`` (iteration and epoch counters), for a
``MultiLayerNetwork`` (trees keyed ``layer_i``) and a
``ComputationGraph`` (trees keyed by vertex name).  It is read and
written with numpy alone, so either package resumes the other's
training checkpoint.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict

import numpy as np
import torch

from deeplearning4j_torch.runtime.backend import resolve_device

_CONFIG = "configuration.json"
_PARAMS = "coefficients.npz"
_STATE = "state.npz"
_UPDATER = "updaterState.npz"
_TRAINING = "training.json"


def _flatten_tree(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        if not tree and prefix:
            # keep empty subtrees (paramless layers) so the restored
            # structure matches the reference's exactly
            out[prefix + "@empty"] = np.zeros(0, np.float32)
        for k in sorted(tree.keys()):
            out.update(_flatten_tree(tree[k], f"{prefix}{k}/"))
    elif tree is not None:
        if isinstance(tree, torch.Tensor):
            if tree.dtype == torch.bfloat16:
                raise ValueError("bfloat16 parameters have no numpy dtype; "
                                 "store parameters in float32")
            tree = tree.detach().cpu().numpy()
        key = prefix[:-1] if prefix.endswith("/") else prefix
        out[key] = np.asarray(tree)
    return out


def _unflatten_tree(flat: Dict[str, np.ndarray], device):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] == "@empty":
            continue  # marker: parent dict exists but is empty
        node[parts[-1]] = torch.from_numpy(np.array(val)).to(device)
    return root


def _npz_bytes(tree) -> bytes:
    buf = io.BytesIO()
    flat = _flatten_tree(tree)
    np.savez(buf, **flat) if flat else np.savez(buf, __empty__=np.zeros(0))
    return buf.getvalue()


def _tree_from_npz(data: bytes, device):
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if k != "__empty__"}
    return _unflatten_tree(flat, device)


def write_model(model, path, save_updater: bool = True) -> None:
    """DL4J ``ModelSerializer.writeModel(model, file, saveUpdater)``."""
    hook = getattr(model, "_param_sync_hook", None)
    if hook is not None:   # lazily-synced trainer-owned params
        hook()
        sync_opt = getattr(hook, "sync_opt", None)
        if sync_opt is not None and save_updater:
            sync_opt()
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_CONFIG, json.dumps(model.conf.to_dict(), indent=2))
        zf.writestr(_PARAMS, _npz_bytes(model.params_tree or {}))
        zf.writestr(_STATE, _npz_bytes(model.state_tree or {}))
        if save_updater and model.opt_state is not None:
            zf.writestr(_UPDATER, _npz_bytes(model.opt_state))
        zf.writestr(_TRAINING, json.dumps({
            "iteration_count": model.iteration_count,
            "epoch_count": model.epoch_count,
        }))


def _restore_trees(model, zf, dev, names, load_updater):
    """Parameters, state, updater state and counters from an open zip
    into ``model``; every name in ``names`` gets an entry (empty for a
    vertex without parameters or state)."""
    model.params_tree = _tree_from_npz(zf.read(_PARAMS), dev)
    model.state_tree = _tree_from_npz(zf.read(_STATE), dev)
    for name in names:
        model.state_tree.setdefault(name, {})
        model.params_tree.setdefault(name, {})
    if load_updater and _UPDATER in zf.namelist():
        model.opt_state = _tree_from_npz(zf.read(_UPDATER), dev)
    if _TRAINING in zf.namelist():
        t = json.loads(zf.read(_TRAINING).decode())
        model.iteration_count = t.get("iteration_count", 0)
        model.epoch_count = t.get("epoch_count", 0)
    model.device = dev
    return model


def restore_multi_layer_network(path, device="cuda",
                                load_updater: bool = True):
    """DL4J ``ModelSerializer.restoreMultiLayerNetwork`` onto ``device``."""
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf.builder import MultiLayerConfiguration

    dev = resolve_device(device)
    with zipfile.ZipFile(path, "r") as zf:
        model = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
            json.loads(zf.read(_CONFIG).decode())))
        return _restore_trees(model, zf, dev,
                              [f"layer_{i}" for i in range(len(model.layers))],
                              load_updater)


def restore_computation_graph(path, device="cuda",
                              load_updater: bool = True):
    """DL4J ``ModelSerializer.restoreComputationGraph`` onto ``device``."""
    from deeplearning4j_torch.models.computation_graph import (
        ComputationGraph, ComputationGraphConfiguration)

    dev = resolve_device(device)
    with zipfile.ZipFile(path, "r") as zf:
        model = ComputationGraph(ComputationGraphConfiguration.from_dict(
            json.loads(zf.read(_CONFIG).decode())))
        return _restore_trees(model, zf, dev, model.vertex_names(),
                              load_updater)


def restore_model(path, device="cuda", load_updater: bool = True):
    """Restore either model class onto ``device`` (default ``"cuda"``),
    chosen by the configuration's "format" (a structural sniff for
    writers without one), with its updater state when present and
    ``load_updater``."""
    with zipfile.ZipFile(path) as zf:
        conf = json.loads(zf.read(_CONFIG))
    fmt = conf.get("format", "")
    if "ComputationGraphConfiguration" in fmt or (
            "MultiLayerConfiguration" not in fmt and "vertices" in conf):
        return restore_computation_graph(path, device, load_updater)
    return restore_multi_layer_network(path, device, load_updater)
