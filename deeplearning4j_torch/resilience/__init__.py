"""Typed failure vocabulary (port of ``deeplearning4j_tpu.resilience``;
only ``errors`` so far — faults, retry and policy come with the watchdog)."""
from deeplearning4j_torch.resilience.errors import (CancelledError,
                                                    DeadlineExceededError,
                                                    RetryableServerError)

__all__ = ["CancelledError", "DeadlineExceededError",
           "RetryableServerError"]
