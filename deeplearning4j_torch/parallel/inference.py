"""Inference helpers (port of ``deeplearning4j_tpu/parallel/inference.py``;
``_bucket`` only — ``ParallelInference`` comes with a later slice)."""
from __future__ import annotations


def _bucket(n: int, limit: int) -> int:
    """Next power-of-two bucket (<= limit).  The server pads prefill
    lengths to these buckets, as the reference does, so the shapes a
    prefill sees stay few (the set a later CUDA-graph capture keys on)."""
    b = 1
    while b < n and b < limit:
        b *= 2
    return min(b, limit)
