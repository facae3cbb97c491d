"""Typed failure vocabulary for the serving path (copied from
``deeplearning4j_tpu/resilience/errors.py``; the training-side types come
with the training slice).

Recovery code dispatches on TYPE, not message text: a load balancer
retries ``RetryableServerError`` but surfaces ``DeadlineExceededError``
to the caller.
"""
from __future__ import annotations

from concurrent.futures import CancelledError  # re-export  # noqa: F401


class RetryableServerError(RuntimeError):
    """The server failed this request through no fault of the request:
    a decode or admission dispatch failed and the slot pool was rebuilt.
    The request was NOT partially applied to any durable state —
    resubmitting is always safe."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline elapsed before it retired (queue wait +
    decode).  Deliberately NOT retryable: the caller's time budget is
    spent; retrying is the caller's call, not the transport's."""
