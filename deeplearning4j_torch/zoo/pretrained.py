"""Pretrained-weight registry (port of
``deeplearning4j_tpu/zoo/pretrained.py``; ``ZooModel.initPretrained`` and
its URL/checksum table).

The registry maps (model, dataset) to a LOCAL checkpoint path and its
sha256 — upstream's ``checkSumForPretrained``/``pretrainedUrl`` contract
without a download of any kind.  The cache directory is the reference's
(``DL4J_TPU_PRETRAINED_DIR``, default ``~/.deeplearning4j_tpu``), and the
weight sets published in the repository are read by path from the JAX
package's ``zoo/weights/`` folder (data files, not imported), so both
packages find the same zips and manifests.  Publishing a weight set is
``save_pretrained`` (the zip + a sidecar manifest with its checksum).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Tuple

_REGISTRY: Dict[Tuple[str, str], Dict[str, str]] = {}


def cache_dir() -> str:
    return os.environ.get("DL4J_TPU_PRETRAINED_DIR",
                          os.path.expanduser("~/.deeplearning4j_tpu"))


def package_weights_dir() -> str:
    """The weight sets published in the repository
    (``deeplearning4j_tpu/zoo/weights/`` beside this package)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "deeplearning4j_tpu", "zoo", "weights")


def sha256_of(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def register(model_name: str, dataset: str, path: str, sha256: str):
    _REGISTRY[(model_name, dataset)] = {"path": path, "sha256": sha256}


def registered() -> Dict[Tuple[str, str], Dict[str, str]]:
    return dict(_REGISTRY)


def save_pretrained(model, model_name: str, dataset: str,
                    directory: Optional[str] = None,
                    save_updater: bool = False) -> Dict[str, str]:
    """Serialize a trained model as a registered pretrained weight set;
    returns the registry entry (path + sha256).  Updater state is
    dropped by default: a pretrained set ships weights."""
    from deeplearning4j_torch.utils.model_serializer import write_model
    d = directory or cache_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{model_name}_{dataset}.zip")
    write_model(model, path, save_updater=save_updater)
    digest = sha256_of(path)
    register(model_name, dataset, path, digest)
    # a sidecar manifest, so a fresh process re-registers without code
    with open(path + ".json", "w") as f:
        json.dump({"model": model_name, "dataset": dataset,
                   "sha256": digest}, f)
    return _REGISTRY[(model_name, dataset)]


def load_pretrained(model_name: str, dataset: str,
                    directory: Optional[str] = None, device="cuda"):
    """Restore a registered weight set onto ``device``, verifying the
    checksum first (a corrupted or tampered file is refused).  A fresh
    process finds entries by the sidecar manifest in ``directory``
    (default: the cache dir, then the repository's weight sets)."""
    # an explicit directory always wins over the in-process registry
    entry = None if directory else _REGISTRY.get((model_name, dataset))
    if entry is None:
        search = ([directory] if directory else
                  [cache_dir(), package_weights_dir()])
        for d in search:
            manifest = os.path.join(d, f"{model_name}_{dataset}.zip.json")
            if os.path.exists(manifest):
                with open(manifest) as f:
                    m = json.load(f)
                # the zip sits next to its manifest: a copied weight
                # directory keeps working
                entry = {"path": manifest[: -len(".json")],
                         "sha256": m["sha256"]}
                if not directory:   # don't poison the default cache
                    _REGISTRY[(model_name, dataset)] = entry
                break
        else:
            raise KeyError(
                f"No pretrained weights registered for "
                f"({model_name!r}, {dataset!r}); have "
                f"{sorted(_REGISTRY)} plus manifests in {search}")
    actual = sha256_of(entry["path"])
    if actual != entry["sha256"]:
        raise IOError(
            f"Checksum mismatch for {entry['path']}: expected "
            f"{entry['sha256'][:12]}…, got {actual[:12]}… — refusing to "
            "load corrupted weights")
    from deeplearning4j_torch.utils.model_serializer import restore_model
    return restore_model(entry["path"], device=device)
