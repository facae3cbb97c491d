"""Dtype names -> torch dtypes (port of ``deeplearning4j_tpu/runtime/dtype.py``).

Configurations and checkpoints name dtypes as strings (``"float32"``,
``"bfloat16"``); the port maps them onto torch dtypes here.
"""
from __future__ import annotations

import torch

_DTYPES = {
    "float64": torch.float64, "double": torch.float64,
    "float32": torch.float32, "float": torch.float32,
    "float16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}


def canonical_dtype(d) -> torch.dtype:
    """Any dtype spec (torch dtype, or a name as the JSON configs store
    it) -> ``torch.dtype``."""
    if isinstance(d, torch.dtype):
        return d
    name = str(d).lower()
    if name.startswith("torch."):
        name = name[len("torch."):]
    if name not in _DTYPES:
        raise ValueError(f"Unsupported dtype: {d!r}")
    return _DTYPES[name]
