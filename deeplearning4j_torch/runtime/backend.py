"""Device resolution (port of ``deeplearning4j_tpu/runtime/backend.py``).

The JAX package discovers its platform through PJRT; the port names its
device explicitly.  Every entry point takes ``device=`` and defaults to
``"cuda"``.  A CUDA device on a machine without CUDA is an error, never a
silent CPU run: a number measured on the CPU must not pass for a number
from the card.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``device`` (default ``"cuda"``) -> ``torch.device``; raises when
    CUDA is asked for and ``torch.cuda.is_available()`` is False."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
