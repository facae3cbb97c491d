"""Per-tenant admission accounting: token buckets + concurrency caps
(copied from ``deeplearning4j_tpu/serving/tenancy.py``).

Multi-tenant fairness is an ADMISSION property, not a scheduling
nicety: one hot tenant spraying requests at an uncapped fleet owns
every KV block within seconds and everyone else's TTFT is its queue.
The accountant meters three things per tenant, all host-side and
cheap:

* a **token bucket** over request cost (prompt + budget tokens —
  the tokens the fleet will actually process): sustained rate
  ``tokens_per_s``, capacity ``burst_tokens``.  Over-rate traffic
  WAITS for refill (it is not an error to be briefly hot); a request
  whose cost exceeds the burst outright can never pass and is
  rejected immediately (:class:`~.errors.QuotaExceededError`);
* a **concurrency cap** (``max_concurrent``): dispatched-and-
  unfinished requests — the knob that bounds how many of the fleet's
  slots/blocks one tenant can pin at once;
* a **queue cap** (``max_queued``): waiting requests beyond it are
  rejected instead of building an unbounded backlog (the bounded-
  retry rule from ``resilience.retry``, applied to queues).

The accountant is its own small lock domain — it never calls into a
replica or the router while holding its lock, so lock ordering across
the fleet stays trivial (router lock and accountant lock never nest
the other way).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

_INF = float("inf")


class TenantQuota:
    """One tenant's admission limits (immutable config; the default
    constructed with no arguments is unlimited — the single-tenant
    degenerate where the fleet behaves like a bare server pool)."""

    __slots__ = ("tokens_per_s", "burst_tokens", "max_concurrent",
                 "max_queued", "klass")

    #: admission classes the degradation ladder dispatches on:
    #: ``batch`` work is sheddable at rung 4, ``interactive`` never is
    CLASSES = ("interactive", "batch")

    def __init__(self, tokens_per_s: float = _INF,
                 burst_tokens: Optional[float] = None,
                 max_concurrent: Optional[int] = None,
                 max_queued: Optional[int] = None,
                 klass: str = "interactive"):
        self.tokens_per_s = float(tokens_per_s)
        if self.tokens_per_s < 0:
            raise ValueError("tokens_per_s must be >= 0")
        if burst_tokens is None:
            # default capacity: 4 seconds of sustained rate — enough
            # that a well-behaved tenant's bursts ride through, small
            # enough that a hot one cannot bank minutes of tokens
            burst_tokens = (self.tokens_per_s * 4.0
                            if self.tokens_per_s != _INF else _INF)
        self.burst_tokens = float(burst_tokens)
        if self.burst_tokens <= 0:
            raise ValueError("burst_tokens must be > 0")
        self.max_concurrent = (None if max_concurrent is None
                               else int(max_concurrent))
        if self.max_concurrent is not None and self.max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        self.max_queued = (None if max_queued is None
                           else int(max_queued))
        if self.max_queued is not None and self.max_queued < 0:
            raise ValueError("max_queued must be >= 0")
        self.klass = str(klass)
        if self.klass not in self.CLASSES:
            raise ValueError(f"klass={klass!r} must be one of "
                             f"{self.CLASSES}")

    def __repr__(self):
        return (f"TenantQuota(tokens_per_s={self.tokens_per_s}, "
                f"burst_tokens={self.burst_tokens}, "
                f"max_concurrent={self.max_concurrent}, "
                f"max_queued={self.max_queued}, "
                f"klass={self.klass!r})")


class _Bucket:
    """One tenant's live accounting state (mutated only under the
    accountant's lock)."""

    __slots__ = ("level", "last", "concurrent", "queued")

    def __init__(self, quota: TenantQuota, now: float):
        self.level = quota.burst_tokens      # buckets start full
        self.last = now
        self.concurrent = 0
        self.queued = 0


class TenantAccountant:
    """Thread-safe per-tenant token buckets + concurrency/queue caps.

    The router calls :meth:`reserve_queued` at intake (structural
    rejects happen here, before the request ever waits),
    :meth:`try_dispatch` each scheduling pass (False = keep waiting —
    the bucket refills or a concurrent slot frees), and
    :meth:`release` when a dispatched request finishes however it
    finishes.  Unknown tenants get ``default_quota``."""

    def __init__(self, default_quota: Optional[TenantQuota] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None):
        self._lock = threading.Lock()
        self._default = default_quota or TenantQuota()
        self._quotas = dict(quotas or {})
        for t, q in self._quotas.items():
            if not isinstance(q, TenantQuota):
                raise TypeError(f"quota for tenant {t!r} must be a "
                                f"TenantQuota, got {type(q).__name__}")
        self._buckets: Dict[str, _Bucket] = {}

    def quota_for(self, tenant: str) -> TenantQuota:
        with self._lock:
            return self._quotas.get(tenant, self._default)

    def tenants_of_class(self, klass: str) -> tuple:
        """CONFIGURED tenants whose quota carries ``klass`` — the
        degradation ladder's default shed set (``"batch"``).  Only
        explicitly-quota'd tenants count: the default quota's class
        must not silently make every unknown tenant sheddable."""
        with self._lock:
            return tuple(sorted(
                t for t, q in self._quotas.items()
                if q.klass == str(klass)))

    def _bucket_locked(self, tenant: str, now: float) -> _Bucket:
        b = self._buckets.get(tenant)
        if b is None:
            b = _Bucket(self._quotas.get(tenant, self._default), now)
            self._buckets[tenant] = b
        return b

    def _refill_locked(self, tenant: str, b: _Bucket,
                       now: float) -> None:
        q = self._quotas.get(tenant, self._default)
        if q.tokens_per_s != _INF and now > b.last:
            b.level = min(q.burst_tokens,
                          b.level + (now - b.last) * q.tokens_per_s)
        b.last = now

    def reserve_queued(self, tenant: str, cost: float,
                       now: Optional[float] = None) -> Optional[str]:
        """Account one request entering the wait line.  Returns None
        on success (queued count taken) or a human-readable rejection
        reason for the structurally-unadmittable: cost above the burst
        (waiting can never help) or the tenant's queue cap is full."""
        now = time.monotonic() if now is None else now
        with self._lock:
            q = self._quotas.get(tenant, self._default)
            b = self._bucket_locked(tenant, now)
            if cost > q.burst_tokens:
                return (f"request cost {cost:g} tokens exceeds tenant "
                        f"{tenant!r} burst capacity "
                        f"{q.burst_tokens:g} — it can never pass")
            if q.max_queued is not None and b.queued >= q.max_queued:
                return (f"tenant {tenant!r} queue cap {q.max_queued} "
                        f"reached")
            b.queued += 1
            return None

    def drop_queued(self, tenant: str) -> None:
        """Undo a :meth:`reserve_queued` for a request leaving the
        wait line WITHOUT dispatching (cancel, expiry, shutdown)."""
        with self._lock:
            b = self._buckets.get(tenant)
            if b is not None and b.queued > 0:
                b.queued -= 1

    def try_dispatch(self, tenant: str, cost: float,
                     now: Optional[float] = None) -> bool:
        """Try to move one waiting request into flight: True deducts
        ``cost`` from the bucket and takes a concurrency slot; False
        means over-rate or at the concurrency cap — leave it waiting
        and try again next pass."""
        now = time.monotonic() if now is None else now
        with self._lock:
            q = self._quotas.get(tenant, self._default)
            b = self._bucket_locked(tenant, now)
            self._refill_locked(tenant, b, now)
            if (q.max_concurrent is not None
                    and b.concurrent >= q.max_concurrent):
                return False
            if b.level < cost:
                return False
            b.level -= cost
            b.concurrent += 1
            if b.queued > 0:
                b.queued -= 1
            return True

    def release(self, tenant: str) -> None:
        """A dispatched request finished (result, error, or was
        migrated INTO a terminal failure) — free its concurrency
        slot.  Token cost is NOT refunded: the work was (mostly)
        done, and refunds would let a cancel-storm tenant decode for
        free.  (:meth:`refund` exists for the one case where that
        rationale is false — charged but never dispatched anywhere.)"""
        with self._lock:
            b = self._buckets.get(tenant)
            if b is not None and b.concurrent > 0:
                b.concurrent -= 1

    def refund(self, tenant: str, cost: float) -> None:
        """Return ``cost`` tokens to the bucket for a request that
        was CHARGED but never dispatched to any replica (fleet-side
        cancel/expiry while every replica was down, no-healthy-
        replica failure): no decode happened, so the no-refund rule
        in :meth:`release` does not apply — without this, a
        rate-limited tenant facing a flapping fleet is throttled out
        of quota it never used."""
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                return
            q = self._quotas.get(tenant, self._default)
            b.level = min(q.burst_tokens, b.level + float(cost))

    def snapshot(self) -> Dict[str, dict]:
        """Per-tenant accounting view for ``ServingFleet.stats()``."""
        with self._lock:
            return {t: {"level": b.level, "concurrent": b.concurrent,
                        "queued": b.queued}
                    for t, b in self._buckets.items()}
