"""Preemption-safe training: cooperative SIGTERM/SIGINT handling and the
checkpoint-restart supervisor (port of
``deeplearning4j_tpu/resilience/preemption.py``).

A preempted machine gets SIGTERM and a grace window.  The signal handler
only sets a FLAG; ``run_fit`` polls it at batch boundaries, forces one
final ``ShardedCheckpointer.save`` + ``wait()`` and unwinds with
:class:`TrainingPreempted`, so the grace window is spent writing the
checkpoint, not finishing the epoch.  Saving from inside the handler
(async-signal context, arbitrary reentrancy) is what this design avoids.

``auto_resume_fit`` is the in-process supervisor: it re-enters a
resumable fit (``resume=True``) after preemptions and transient step
failures, bounded by ``max_restarts``.
"""
from __future__ import annotations

import logging
import signal
import threading
from typing import Callable, Tuple, Type

from deeplearning4j_torch import telemetry
from deeplearning4j_torch.resilience.errors import TrainingPreempted

log = logging.getLogger("deeplearning4j_torch")

PREEMPTIONS = telemetry.counter(
    "train_preemptions_total",
    "SIGTERM/SIGINT (or simulated) preemptions observed by run_fit")
RESUMES = telemetry.counter(
    "train_resumes_total",
    "training runs that restored state from a checkpoint on entry")

_FLAG = threading.Event()

# The installed fleet preemption coordinator, or None.  With one
# installed, the step-boundary poll or-reduces the flag over every
# process, so all ranks see a peer's SIGTERM at the same step.
_COORDINATOR = None


def install_coordinator(coordinator):
    """Install (None: remove) the fleet preemption coordinator consulted
    by :func:`poll_preemption` (an object with ``poll(flag) -> bool``);
    returns the previous one."""
    global _COORDINATOR
    previous = _COORDINATOR
    _COORDINATOR = coordinator
    return previous


def poll_preemption() -> bool:
    """The step-boundary check ``run_fit`` makes: the local flag alone,
    or, with a coordinator installed, the flag or-reduced over every
    process (a collective: every rank polls in lockstep)."""
    coordinator = _COORDINATOR
    if coordinator is None:
        preempted = _FLAG.is_set()
    else:
        preempted = coordinator.poll(_FLAG.is_set())
    if preempted:
        _dump_once()
    return preempted


#: one postmortem bundle per preemption round — reset by
#: clear_preemption so the next preemption dumps again
_DUMPED = threading.Event()


def _dump_once() -> None:
    """Freeze the flight recorder's black box for this preemption —
    called from the step-boundary poll, never from the signal handler
    (recording and dumping take ordinary locks and do file I/O)."""
    if _DUMPED.is_set():
        return
    _DUMPED.set()
    recorder = telemetry.get_flight_recorder()
    recorder.record("preemption")
    recorder.request_dump("preemption")


def request_preemption(signum=None, frame=None) -> None:
    """Set the preemption flag — the signal handler's whole body, also
    called directly by the fault injector's simulated SIGTERM."""
    if signum is not None:
        log.warning("preemption signal %s received; training will "
                    "checkpoint and exit at the next step boundary",
                    signum)
    _FLAG.set()


def preemption_requested() -> bool:
    return _FLAG.is_set()


def clear_preemption() -> None:
    _FLAG.clear()
    _DUMPED.clear()


class PreemptionGuard:
    """Scoped SIGTERM/SIGINT -> preemption-flag installation.

    >>> with PreemptionGuard():
    ...     model.fit(it, n_epochs=10)   # SIGTERM => checkpoint + raise

    Restores the previous handlers on exit.  Handlers can only be
    installed from the main thread; elsewhere the guard installs nothing
    and warns (``request_preemption`` still works from any thread)."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._previous = {}

    def __enter__(self):
        for s in self.signals:
            try:
                self._previous[s] = signal.signal(s, request_preemption)
            except ValueError:                 # not the main thread
                log.warning("PreemptionGuard: cannot install handler "
                            "for %s off the main thread", s)
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
        return False


def auto_resume_fit(fit_fn: Callable, max_restarts: int = 3,
                    retry_on: Tuple[Type[BaseException], ...] = ()):
    """Run ``fit_fn`` (a zero-arg callable driving a RESUMABLE fit: one
    that passes ``resume=True`` with a ``CheckpointListener`` attached)
    to completion across preemptions.

    ``TrainingPreempted`` always restarts; ``retry_on`` extends restart
    to transient step failures (e.g. ``InjectedFault``).  Each restart
    re-enters ``fit_fn``, whose ``resume=True`` path restores the newest
    checkpoint and fast-forwards the iterator.  After ``max_restarts``
    re-entries the last error propagates.

    >>> lst = CheckpointListener(dir, save_every_n_iterations=50)
    >>> model.set_listeners(lst)
    >>> auto_resume_fit(lambda: model.fit(it, n_epochs=10, resume=True))
    """
    restarts = 0
    while True:
        try:
            return fit_fn()
        except TrainingPreempted as e:
            clear_preemption()
            restarts += 1
            if restarts > max_restarts:
                raise
            log.warning("preempted at checkpoint step %s; restart "
                        "%d/%d resumes from it", e.step, restarts,
                        max_restarts)
        except retry_on as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            log.warning("training failed (%s: %s); restart %d/%d "
                        "resumes from the last checkpoint",
                        type(e).__name__, e, restarts, max_restarts)
