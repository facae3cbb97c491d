"""Device resolution and dtype names (port of ``deeplearning4j_tpu.runtime``)."""
from deeplearning4j_torch.runtime.backend import resolve_device
from deeplearning4j_torch.runtime.dtype import canonical_dtype

__all__ = ["resolve_device", "canonical_dtype"]
