"""ParallelInference: the dynamic-batching inference server (port of
``deeplearning4j_tpu/parallel/inference.py``;
``org.deeplearning4j.parallelism.ParallelInference`` in
``.inferenceMode(BATCHED)``).

Concurrent callers' requests are queued, coalesced up to
``batch_limit`` examples, run through the model's no-grad inference
forward (``_forward_infer``) on the model's own device by ONE worker
thread, and scattered back as numpy arrays.  A batch is padded to the
next power of two (``_bucket``), as in the reference: the port needs no
recompile bound, but the batches a caller's rows share and the
``inference_padding_waste`` series stay the reference's.  The nine
``inference_*`` series keep the reference's names.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch import telemetry

# every ParallelInference of a process shares these series (the
# reference's choice: "is THIS process saturated")
_REQS = telemetry.counter(
    "inference_requests_total", "requests accepted into the queue")
_BATCHES = telemetry.counter(
    "inference_batches_total", "coalesced batches run through the model")
_ERRORS = telemetry.counter(
    "inference_errors_total", "requests failed inside the batch worker")
_SHED = telemetry.counter(
    "inference_shed_total", "requests rejected because the queue was full")
_TIMEOUTS = telemetry.counter(
    "inference_timeout_total", "requests abandoned by their caller's "
    "deadline (result discarded)")
_LATENCY = telemetry.histogram(
    "inference_latency_seconds",
    "enqueue -> result wall time per request (queue wait + batch + "
    "forward + scatter)")
_QDEPTH = telemetry.gauge(
    "inference_queue_depth", "pending requests when the worker formed "
    "the last batch")
_OCCUPANCY = telemetry.histogram(
    "inference_batch_occupancy", "examples coalesced / batch_limit",
    buckets=telemetry.RATIO_BUCKETS)
_PAD_WASTE = telemetry.histogram(
    "inference_padding_waste", "padded-but-dead rows / bucket size per "
    "forward (the recompile-bounding cost)",
    buckets=telemetry.RATIO_BUCKETS)


def _bucket(n: int, limit: int) -> int:
    """Next power-of-two bucket (<= limit).  ParallelInference pads its
    batches, and the server its prefill lengths, to these buckets, as the
    reference does, so the shapes stay few."""
    b = 1
    while b < n and b < limit:
        b *= 2
    return min(b, limit)


def _host(t) -> np.ndarray:
    """A result tensor as a host numpy array (bf16 through f32)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


class _Request:
    __slots__ = ("x", "event", "result", "error")

    def __init__(self, x):
        self.x = x
        self.event = threading.Event()
        self.result = None
        self.error = None


class ParallelInference:
    """``ParallelInference.output(x)`` is thread-safe and blocking; a
    background worker batches concurrent requests.

    queue_limit / batch_limit mirror the DL4J builder knobs
    (``.inferenceMode(BATCHED).batchLimit(..).queueLimit(..)``)."""

    def __init__(self, model, batch_limit: int = 64, queue_limit: int = 64,
                 timeout_ms: float = 2.0, shed_on_full: bool = False):
        self.model = model
        model._check_init()
        self.batch_limit = int(batch_limit)
        self.timeout = timeout_ms / 1000.0
        self.shed_on_full = bool(shed_on_full)
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(
            maxsize=queue_limit)
        self._worker = threading.Thread(target=self._run, daemon=True)
        # an Event, not a bare bool: shutdown() sets it from the caller's
        # thread while output() reads it from others
        self._stop = threading.Event()
        self._worker.start()

    def output(self, x, timeout: Optional[float] = None):
        """Blocking single-example (or small-batch) inference; the result
        is a numpy array (a list of them for a multi-output graph).

        ``timeout`` (seconds): stop waiting after the deadline
        (``TimeoutError``, counted in ``inference_timeout_total``) — the
        worker may still compute the result, but nobody collects it.
        With ``shed_on_full=True`` a full queue rejects instead of
        blocking the caller (``inference_shed_total``)."""
        if self._stop.is_set():
            raise RuntimeError("ParallelInference has been shut down")
        req = _Request(np.asarray(x))
        t0 = time.perf_counter()
        if self.shed_on_full:
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                _SHED.inc()
                raise RuntimeError(
                    "ParallelInference queue full "
                    f"(queue_limit={self._queue.maxsize}); request shed"
                ) from None
        else:
            self._queue.put(req)
        _REQS.inc()
        if not req.event.wait(timeout):
            _TIMEOUTS.inc()
            raise TimeoutError(
                f"inference result not ready within {timeout}s")
        if req.error is not None:
            raise req.error
        _LATENCY.observe(time.perf_counter() - t0)
        return req.result

    def shutdown(self):
        self._stop.set()
        self._queue.put(None)
        self._worker.join(timeout=5)

    # ------------------------------------------------------------------
    def _drain(self):
        """Collect requests until batch_limit examples or a lull."""
        first = self._queue.get()
        if first is None:
            return None
        reqs = [first]
        n = first.x.shape[0] if first.x.ndim > 1 else 1
        while n < self.batch_limit:
            try:
                r = self._queue.get(timeout=self.timeout)
            except queue.Empty:
                break
            if r is None:
                self._queue.put(None)  # re-post the sentinel for the loop
                break
            reqs.append(r)
            n += r.x.shape[0] if r.x.ndim > 1 else 1
        _QDEPTH.set(self._queue.qsize())
        return reqs

    def _run(self):
        tracer = telemetry.get_tracer()
        while True:
            reqs = self._drain()
            if reqs is None:
                return
            try:
                feats = [r.x if r.x.ndim > 1 else r.x[None] for r in reqs]
                sizes = [f.shape[0] for f in feats]
                batch = np.concatenate(feats, axis=0)
                n = batch.shape[0]
                b = _bucket(n, max(self.batch_limit, n))
                _BATCHES.inc()
                _OCCUPANCY.observe(min(1.0, n / self.batch_limit))
                _PAD_WASTE.observe((b - n) / b)
                if b > n:  # pad to the bucket, as the reference does
                    pad = np.zeros((b - n,) + batch.shape[1:], batch.dtype)
                    batch = np.concatenate([batch, pad], axis=0)
                # a lazily synced trainer defers its unstack to this
                # hook: without it a train-while-serve loop would serve
                # stale weights
                hook = getattr(self.model, "_param_sync_hook", None)
                if hook is not None:
                    hook()
                with tracer.span("serve/forward", requests=len(reqs),
                                 examples=n, bucket=b), torch.no_grad():
                    out = self.model._forward_infer(self.model.params_tree,
                                                    self.model.state_tree,
                                                    batch)
                if isinstance(out, dict):  # ComputationGraph outputs
                    outs = self.model.conf.network_outputs
                    out = out[outs[0]] if len(outs) == 1 else \
                        [out[name] for name in outs]
                if isinstance(out, list):  # multi-output graph: per-output
                    arrs = [_host(a)[:n] for a in out]
                    off = 0
                    for r, s in zip(reqs, sizes):
                        parts = [a[off:off + s] for a in arrs]
                        r.result = (parts if r.x.ndim > 1
                                    else [p[0] for p in parts])
                        off += s
                else:
                    out = _host(out)[:n]
                    off = 0
                    for r, s in zip(reqs, sizes):
                        res = out[off:off + s]
                        r.result = res if r.x.ndim > 1 else res[0]
                        off += s
            except Exception as e:  # surface to every blocked caller
                _ERRORS.inc(len(reqs))
                for r in reqs:
                    r.error = e
            finally:
                for r in reqs:
                    r.event.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
