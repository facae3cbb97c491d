"""Hand-written Hopper kernels and their plain PyTorch versions (port of
``deeplearning4j_tpu.kernels``).

Each kernel's CUDA source lives under ``csrc/`` and builds at first use
(``_build``); importing this package builds nothing.  Ported: the paged
decode and verify attention (``paged_attention``) and flash attention,
forward and backward (``flash_attention``).
"""
from deeplearning4j_torch.kernels.flash_attention import (
    attention, flash_attention, mask_to_bias, reset_route_log, route_log,
    xla_attention)
from deeplearning4j_torch.kernels.paged_attention import (
    paged_decode_attention, paged_decode_attention_reference, paged_gather,
    paged_verify_attention, paged_verify_attention_reference)

__all__ = ["attention", "flash_attention", "mask_to_bias",
           "reset_route_log", "route_log", "xla_attention",
           "paged_decode_attention", "paged_decode_attention_reference",
           "paged_gather", "paged_verify_attention",
           "paged_verify_attention_reference"]
