"""Deterministic, seed-driven fault injection (port of
``deeplearning4j_tpu/resilience/faults.py``).

Chaos engineering needs REPRODUCIBLE chaos: a fault schedule is data
(kind + the call index it fires at), not a coin flipped at runtime, so
a failing chaos run replays bit-for-bit under the same plan.  The
injector is consulted at fixed sites in the training loop, the
checkpointer and the decode scheduler; with no active injector every
site is a nearly-free attribute check, so the hooks stay compiled into
production code paths (the same property that makes them honest: the
injected failure traverses exactly the code a real one would).

Activation is either scoped::

    with FaultInjector(["nan_loss@3", "preempt@7"]):
        model.fit(it, n_epochs=2)

or environment-driven for chaos runs::

    DL4J_TORCH_FAULTS="step_exception@2,data_stall@1:0.5" python train.py

Every injection increments ``faults_injected_total{kind=...}``.
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import Iterable, List, Optional, Sequence, Union

from deeplearning4j_torch import telemetry
from deeplearning4j_torch.resilience.errors import InjectedFault

_INJECTED = telemetry.counter(
    "faults_injected_total", "chaos faults actually fired, by kind",
    labelnames=("kind",))

#: The injectable fault vocabulary (site locations in parentheses):
#:  step_exception   raise from the train step dispatch   (fit_loop)
#:  nan_loss         NaN-poison the batch -> NaN loss/grads (fit_loop)
#:  data_stall       sleep inside the data fetch            (fit_loop)
#:  checkpoint_fail  raise from ShardedCheckpointer.save    (checkpoint)
#:  preempt          simulated SIGTERM via the preemption flag (fit_loop)
#:  serve_tick_fail  raise in the decode scheduler loop -> worker dies
#:  serve_tick_stall sleep inside the tick window -> watchdog trips
FAULT_KINDS = ("step_exception", "nan_loss", "data_stall",
               "checkpoint_fail", "preempt",
               "serve_tick_fail", "serve_tick_stall")
DEFAULT_STALL_SECONDS = 0.25


class FaultSpec:
    """One scheduled fault: ``kind`` fires once when its site reaches
    call/iteration index ``at``; ``seconds`` is the stall duration for
    the *_stall kinds."""

    __slots__ = ("kind", "at", "seconds", "fired")

    def __init__(self, kind: str, at: int,
                 seconds: float = DEFAULT_STALL_SECONDS):
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(one of {FAULT_KINDS})")
        self.kind = kind
        self.at = int(at)
        self.seconds = float(seconds)
        self.fired = False

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """``kind@index`` or ``kind@index:seconds``."""
        kind, _, rest = text.strip().partition("@")
        if not rest:
            raise ValueError(
                f"fault spec {text!r} must look like 'kind@index' or "
                f"'kind@index:seconds'")
        at, _, secs = rest.partition(":")
        return cls(kind, int(at),
                   float(secs) if secs else DEFAULT_STALL_SECONDS)

    def __repr__(self):
        return (f"FaultSpec({self.kind}@{self.at}"
                f"{':%g' % self.seconds if 'stall' in self.kind else ''}"
                f"{' fired' if self.fired else ''})")


# Active-injector stack: context managers push/pop; the env-configured
# injector (chaos CI) sits below any scoped one.
_STACK: List["FaultInjector"] = []
_STACK_LOCK = threading.Lock()
_ENV_VAR = "DL4J_TORCH_FAULTS"
_env_cache = (None, None)          # (env string it was parsed from, injector)


class FaultInjector:
    """A deterministic fault plan plus the per-site call counters that
    make index-less sites reproducible.  Thread safe — serving sites
    fire from scheduler/watchdog threads."""

    def __init__(self, plan: Iterable[Union[str, FaultSpec]] = ()):
        self.specs: List[FaultSpec] = [
            s if isinstance(s, FaultSpec) else FaultSpec.parse(s)
            for s in plan]
        self._calls = {}               # kind -> site-call counter
        self._lock = threading.Lock()

    @classmethod
    def random_plan(cls, seed: int, horizon: int,
                    kinds: Sequence[str] = FAULT_KINDS,
                    n_faults: int = 3,
                    stall_seconds: float = DEFAULT_STALL_SECONDS):
        """Seed-driven schedule: ``n_faults`` draws of (kind, index)
        over ``[0, horizon)`` — the same seed always yields the same
        plan, so a failing chaos run is replayable."""
        rng = random.Random(seed)
        return cls([FaultSpec(rng.choice(list(kinds)),
                              rng.randrange(horizon), stall_seconds)
                    for _ in range(n_faults)])

    @classmethod
    def from_env(cls, value: Optional[str] = None):
        """Injector from ``DL4J_TORCH_FAULTS`` (None when unset/empty)."""
        value = os.environ.get(_ENV_VAR, "") if value is None else value
        if not value.strip():
            return None
        return cls(value.split(","))

    # -- activation ----------------------------------------------------
    def __enter__(self):
        with _STACK_LOCK:
            _STACK.append(self)
        return self

    def __exit__(self, *exc):
        with _STACK_LOCK:
            _STACK.remove(self)
        return False

    def pending(self) -> List[FaultSpec]:
        return [s for s in self.specs if not s.fired]

    # -- site API ------------------------------------------------------
    def _take(self, kind: str, index: Optional[int]) -> Optional[FaultSpec]:
        """Arm check: returns the spec (marked fired, counted) when
        ``kind`` is scheduled at this site visit.  ``index`` is the
        caller's own ordinal (training iteration); sites without a
        natural ordinal pass None and the injector counts calls."""
        with self._lock:
            if index is None:
                index = self._calls.get(kind, 0)
                self._calls[kind] = index + 1
            for s in self.specs:
                if not s.fired and s.kind == kind and s.at == index:
                    s.fired = True
                    _INJECTED.labels(kind=kind).inc()
                    return s
        return None

    def fires(self, kind: str, index: Optional[int] = None) -> bool:
        return self._take(kind, index) is not None

    def maybe_fail(self, kind: str, index: Optional[int] = None):
        spec = self._take(kind, index)
        if spec is not None:
            raise InjectedFault(kind, spec.at)

    def maybe_stall(self, kind: str, index: Optional[int] = None) -> float:
        spec = self._take(kind, index)
        if spec is not None:
            time.sleep(spec.seconds)
            return spec.seconds
        return 0.0

    def corrupt_batch(self, index: Optional[int], batch: dict) -> dict:
        """``nan_loss`` site: NaN-poison the batch so the REAL
        forward/backward produces the NaN loss and NaN gradients the
        bad-step machinery must absorb (nothing is mocked).  Only
        FLOATING leaves (numpy arrays or tensors) are poisoned — integer
        leaves (token ids for an embedding model) must keep their dtype
        or the gather would raise instead of producing the NaN; when the
        features are all-integer the float labels/masks carry the
        poison."""
        if self._take("nan_loss", index) is None:
            return batch
        import numpy as np
        import torch

        poisoned = [False]

        def poison(a):
            if torch.is_tensor(a):
                if a.is_floating_point():
                    poisoned[0] = True
                    return a * float("nan")
                return a
            a = np.asarray(a)
            if np.issubdtype(a.dtype, np.floating):
                poisoned[0] = True
                return a * np.nan
            return a

        def walk(v):
            if isinstance(v, dict):
                return {k: walk(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(walk(x) for x in v)
            return None if v is None else poison(v)

        out = {k: walk(v) for k, v in batch.items()}
        if not poisoned[0]:
            raise ValueError(
                "nan_loss injection found no floating leaf to poison "
                "in the batch (all-integer features AND labels)")
        return out


# -- module-level site helpers (no-ops without an active injector) ------
def active() -> Optional[FaultInjector]:
    """Innermost scoped injector, else the env-configured one."""
    # The env-cache check-parse-rebind must stay under the lock: the
    # decode scheduler and the watchdog both land here, and an
    # unguarded rebind let a caller return an injector parsed from a
    # DIFFERENT env string than the one it just compared (found by
    # concurrency_lint CONC205 once the cross-module pass could walk
    # GenerationServer._run -> maybe_stall -> active).
    global _env_cache
    with _STACK_LOCK:
        if _STACK:
            return _STACK[-1]
        env = os.environ.get(_ENV_VAR, "")
        if _env_cache[0] != env:
            _env_cache = (env, FaultInjector.from_env(env))
        return _env_cache[1]


def fires(kind: str, index: Optional[int] = None) -> bool:
    inj = active()
    return inj.fires(kind, index) if inj is not None else False


def maybe_fail(kind: str, index: Optional[int] = None) -> None:
    inj = active()
    if inj is not None:
        inj.maybe_fail(kind, index)


def maybe_stall(kind: str, index: Optional[int] = None) -> float:
    inj = active()
    return inj.maybe_stall(kind, index) if inj is not None else 0.0


def corrupt_batch(index: Optional[int], batch: dict) -> dict:
    inj = active()
    return inj.corrupt_batch(index, batch) if inj is not None else batch


# -- chaos-scenario helpers (shared by the recovery tests and chaos
# drives, so the scheduler-throttling recipes and the KV-poisoning
# protocol live in ONE place) -----------------------------------------------

def throttled_stall_plan(n_throttles: int, final: str,
                         enqueue_s: float = 0.3,
                         throttle_s: float = 0.05) -> List[str]:
    """The serve-chaos pass recipe: pass 0 stalls ``enqueue_s`` (every
    concurrent submit enqueues before the first admission), passes
    1..n_throttles throttle ``throttle_s`` each (slots fill and decode
    a few ticks without draining their budgets), then ``final`` — a
    ``serve_tick_fail@K`` crash or a past-deadline ``serve_tick_stall``
    hang at index ``n_throttles + 1``."""
    return ([f"serve_tick_stall@0:{enqueue_s:g}"] +
            [f"serve_tick_stall@{k}:{throttle_s:g}"
             for k in range(1, n_throttles + 1)] + [final])


def poison_slot_kv(server: "GenerationServer", slot: int,
                   timeout_s: float = 10.0) -> bool:
    """NaN-poison one slot's KV in a live ``GenerationServer`` —
    the deterministic stand-in for device memory corruption the
    salvage path's finiteness screen must catch.  The pool is paged:
    the poke targets one of the slot's own blocks through the host
    block registry, preferring a PRIVATE (refcount 1) block so a shared
    prefix block doesn't implicate innocent slots.  The pool is updated
    in place, so the write lands in the committed pool (stream-ordered
    behind every dispatch enqueued so far); a recovery may swap the
    pool meanwhile, so retry until the NaN verifiably sticks."""
    deadline = time.monotonic() + timeout_s
    blk = None
    while time.monotonic() < deadline:
        with server._lock:
            blocks = server._slot_blocks.get(slot, ())
            private = [b for b in blocks
                       if server._block_ref[b] == 1
                       and b not in server._block_hash]
            blk = (private or list(blocks) or [None])[0]
            if blk is not None:
                server._kc[:, blk, :, 0, :] = float("nan")
        time.sleep(0.12)              # > one throttled scheduler pass
        with server._lock:
            if blk is not None and bool(
                    server._kc[:, blk].isnan().any()):
                return True
    return False
