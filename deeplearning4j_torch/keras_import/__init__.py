"""Keras model import (port of ``deeplearning4j_tpu.keras_import``).

Reference: ``deeplearning4j-modelimport
org.deeplearning4j.nn.modelimport.keras.KerasModelImport``.  The legacy
``.h5`` full-model format is parsed with h5py (imported inside the
reader, so the package imports without it) — config JSON → the port's
layer confs, weight groups → its parameter trees — with no Keras runtime
needed at import time.
"""
from deeplearning4j_torch.keras_import.keras_import import KerasModelImport

__all__ = ["KerasModelImport"]
