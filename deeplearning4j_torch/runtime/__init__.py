"""Device resolution, dtype names and weight-only int8 inference (port
of ``deeplearning4j_tpu.runtime``)."""
from deeplearning4j_torch.runtime.backend import resolve_device
from deeplearning4j_torch.runtime.dtype import canonical_dtype
from deeplearning4j_torch.runtime.quantization import (QuantizedInference,
                                                       quantize_leaf)

__all__ = ["resolve_device", "canonical_dtype", "QuantizedInference",
           "quantize_leaf"]
