"""Graceful-degradation ladder for the serving fleet (port of
``deeplearning4j_tpu/serving/degrade.py``).

When the SLO engine projects a sustained error-budget burn, the fleet
should get CHEAPER before it gets smaller: shedding load is rung FIVE,
not the first response.  This module is the state machine between the
two — it reads the engine's admission projection (the same
store-backed burn history the alert condition folds) and walks the
fleet down a ladder of progressively lossier-but-reversible economies:

====  ==============  ==================================================
rung  name            effect while the rung holds
====  ==============  ==================================================
0     normal          nothing — the ladder is invisible
1     shrink_budget   new requests' ``n_new`` capped to
                      ``n_new_factor`` of what they asked for, and
                      already-waiting work is demoted the same way
2     force_greedy    sampling disabled (temperature 0): every decode
                      rides the greedy path, and speculative rounds
                      accept greedily
3     shrink_draft_k  the speculative draft depth capped to 1
                      (``set_draft_k_cap``): each round drafts ONE
                      token and verifies W = 2 rows (K2)
4     spec_off        speculative decoding suspended
                      (``set_spec_enabled(False)``): no draft compute,
                      no verify passes — only the decode kernel (K1)
5     shed_batch      the batch tenant class is rejected at admission
                      (typed ``AdmissionRejectedError`` with a
                      retry-after hint) and its waiting work cancelled
====  ==============  ==================================================

Rungs NEST: rung 3 implies 2 implies 1.  Ascent is immediate — a burn
spike that clears threshold N lands on rung N this pass.  Descent is
damped twice over: burn must fall below ``hysteresis`` x the rung's
own entry threshold AND stay there for ``hold_down_s`` before ONE
rung releases, then the clock re-arms for the next.

Reversibility is structural: every rung acts only on (a) requests
admitted WHILE it holds (shaped at admission from the current rung)
and (b) the waiting pool at entry.  A request admitted after the rung
clears is untouched on every path, so post-recovery outputs equal a
never-degraded run's.

Every rung entry/exit is a counted flight-recorder event
(``flight_events_total{kind="degrade_step"}``) and the current rung is
the ``fleet_degrade_rung`` gauge.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from deeplearning4j_torch import telemetry

log = logging.getLogger("deeplearning4j_torch")

#: the ladder's rungs, mildest first; index == rung number
RUNGS: Tuple[str, ...] = ("normal", "shrink_budget", "force_greedy",
                          "shrink_draft_k", "spec_off", "shed_batch")

_RUNG_GAUGE = telemetry.gauge(
    "fleet_degrade_rung",
    "current degradation-ladder rung: 0 normal, 1 shrink_budget "
    "(n_new capped), 2 force_greedy (sampling off), 3 shrink_draft_k "
    "(draft depth capped to 1), 4 spec_off (draft K dropped), "
    "5 shed_batch (batch class rejected at admission)")

_FLIGHT = telemetry.get_flight_recorder()


class DegradeLadder:
    """The burn-driven degradation state machine.

    >>> ladder = DegradeLadder(fleet, engine,
    ...                        thresholds=(2.0, 6.0, 8.0, 10.0, 14.4))
    >>> fleet.attach_degrade(ladder)     # admission shaping
    >>> ladder.start()                   # or: autoscaler drives it

    ``thresholds`` are the burn levels (units of the SLO budget-spend
    rate, like the alert windows') at which rungs 1..5 engage;
    ``burn`` is injectable into :meth:`evaluate` for tests, otherwise
    the worst covered projection across the engine's specs.  The
    ``batch_tenants`` shed set defaults to the fleet accountant's
    ``klass="batch"`` tenants."""

    def __init__(self, fleet=None, engine=None, *,
                 thresholds: Tuple[float, ...] = (2.0, 6.0, 8.0, 10.0,
                                                  14.4),
                 hysteresis: float = 0.7,
                 hold_down_s: float = 2.0,
                 n_new_factor: float = 0.25,
                 min_n_new: int = 1,
                 batch_tenants: Optional[Tuple[str, ...]] = None,
                 shed_retry_after_s: float = 1.0,
                 interval_s: float = 0.5):
        self.fleet = fleet
        self.engine = engine
        self.thresholds = tuple(float(t) for t in thresholds)
        if len(self.thresholds) != len(RUNGS) - 1:
            raise ValueError(
                f"need {len(RUNGS) - 1} thresholds (one per rung "
                f"above normal), got {len(self.thresholds)}")
        if any(b <= a for a, b in zip(self.thresholds,
                                      self.thresholds[1:])):
            raise ValueError("thresholds must strictly increase "
                             f"rung by rung: {self.thresholds}")
        if self.thresholds[0] <= 0:
            raise ValueError("thresholds must be > 0")
        self.hysteresis = float(hysteresis)
        if not 0.0 < self.hysteresis <= 1.0:
            raise ValueError(f"hysteresis={hysteresis} must be in "
                             "(0, 1] — a release point ABOVE the "
                             "entry threshold flaps by construction")
        self.hold_down_s = float(hold_down_s)
        if self.hold_down_s < 0:
            raise ValueError("hold_down_s must be >= 0")
        self.n_new_factor = float(n_new_factor)
        if not 0.0 < self.n_new_factor <= 1.0:
            raise ValueError("n_new_factor must be in (0, 1]")
        self.min_n_new = max(1, int(min_n_new))
        self._batch_tenants = (None if batch_tenants is None
                               else tuple(str(t) for t in batch_tenants))
        self.shed_retry_after_s = float(shed_retry_after_s)
        self.interval_s = float(interval_s)
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self._lock = threading.Lock()
        self._rung = 0
        self._below_since: Optional[float] = None
        self._last_burn = 0.0
        self._transitions: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _RUNG_GAUGE.set(0.0)

    # -- configuration reads -------------------------------------------
    def shed_tenants(self) -> Tuple[str, ...]:
        """The tenant set rung 5 sheds: the configured list, else the
        fleet accountant's batch-class tenants, else nothing (a fleet
        with no batch class has nothing safe to shed)."""
        if self._batch_tenants is not None:
            return self._batch_tenants
        acct = getattr(self.fleet, "_acct", None)
        if acct is None:
            return ()
        return tuple(acct.tenants_of_class("batch"))

    # -- state reads ---------------------------------------------------
    def rung(self) -> int:
        with self._lock:
            return self._rung

    def state(self) -> dict:
        """Snapshot for tests and postmortems: rung, rung name, last
        burn driven through, and the entry/exit transition counts."""
        with self._lock:
            return {"rung": self._rung, "name": RUNGS[self._rung],
                    "burn": self._last_burn,
                    "transitions": dict(self._transitions)}

    # -- the policy each rung implies ----------------------------------
    def policy(self, rung: Optional[int] = None) -> dict:
        """The fleet-facing knob settings for ``rung`` (default: the
        current rung) — what :meth:`ServingFleet.apply_degrade`
        actuates.  Rungs nest: each includes everything below it."""
        if rung is None:
            with self._lock:
                rung = self._rung
        rung = int(rung)
        return {
            "max_n_new_factor": (self.n_new_factor if rung >= 1
                                 else None),
            "min_n_new": self.min_n_new,
            "force_greedy": rung >= 2,
            "draft_k_cap": 1 if rung >= 3 else None,
            "spec": rung < 4,
            "shed_tenants": (self.shed_tenants() if rung >= 5
                             else ()),
        }

    # -- admission shaping ---------------------------------------------
    def shape_admission(self, tenant: str, n_new: int,
                        sampling: Optional[dict]
                        ) -> Tuple[int, Optional[dict], str]:
        """Shape ONE request at admission from the current rung:
        returns ``(n_new, sampling, verdict)`` with verdict one of
        ``admit`` / ``degraded`` / ``reject``.  Reject (rung 5, batch
        tenant) costs the pool nothing — the router raises before any
        reserve.  Requests admitted at rung 0 pass through untouched,
        which is the reversibility contract.  Rungs 3 and 4 act on
        the REPLICAS (draft depth cap / spec off via
        ``apply_degrade``), not on individual requests — nothing to
        shape here."""
        with self._lock:
            rung = self._rung
        if rung <= 0:
            return int(n_new), sampling, "admit"
        if rung >= 5 and str(tenant) in self.shed_tenants():
            return int(n_new), sampling, "reject"
        verdict = "admit"
        n_new = int(n_new)
        if rung >= 1:
            capped = max(self.min_n_new,
                         int(n_new * self.n_new_factor))
            if capped < n_new:
                n_new = capped
                verdict = "degraded"
        if rung >= 2:
            temp = (sampling or {}).get("temperature", None)
            if temp is None or float(temp) > 0.0:
                # greedy-only sampling dict: top_k/top_p with
                # temperature 0 is a typed error in the decode server
                sampling = {"temperature": 0.0}
                verdict = "degraded"
        return n_new, sampling, verdict

    # -- the walk ------------------------------------------------------
    def _read_burn(self, now: float) -> float:
        """The drive signal: worst covered projected burn across the
        engine's specs (a young/uncovered history drives 0 — the
        ladder can no more flap on a first blip than admission can
        reject on one)."""
        if self.engine is None:
            return 0.0
        try:
            rows = self.engine.projection(now=now)
        except Exception:
            log.exception("degrade ladder: projection read failed")
            return 0.0
        covered = [r["projected_burn"] for r in rows if r["covered"]]
        return max(covered) if covered else 0.0

    def evaluate(self, now: Optional[float] = None,
                 burn: Optional[float] = None) -> int:
        """One ladder pass; returns the rung after the pass.  ``now``
        and ``burn`` are injectable for tests — the production loop
        reads ``time.monotonic`` and the engine projection."""
        now = time.monotonic() if now is None else float(now)
        burn = self._read_burn(now) if burn is None else float(burn)
        target = sum(1 for t in self.thresholds if burn >= t)
        steps: List[Tuple[str, int]] = []
        with self._lock:
            self._last_burn = burn
            cur = self._rung
            if target > cur:
                # immediate ascent: every pass spent under-degraded
                # burns budget, so the spike lands on its rung NOW
                for r in range(cur + 1, target + 1):
                    steps.append(("enter", r))
                self._rung = target
                self._below_since = None
            elif cur > 0:
                # damped descent: below hysteresis x the CURRENT
                # rung's entry threshold, held hold_down_s, releases
                # ONE rung — then the clock re-arms
                release = self.thresholds[cur - 1] * self.hysteresis
                if burn < release:
                    if self._below_since is None:
                        self._below_since = now
                    elif now - self._below_since >= self.hold_down_s:
                        steps.append(("exit", cur))
                        self._rung = cur - 1
                        self._below_since = now
                else:
                    self._below_since = None
            rung = self._rung
            for direction, r in steps:
                key = f"{direction}:{RUNGS[r]}"
                self._transitions[key] = \
                    self._transitions.get(key, 0) + 1
        # actuation OUTSIDE the ladder lock: apply_degrade takes the
        # fleet lock and demotes replica queues — never nest ours
        # around theirs
        _RUNG_GAUGE.set(float(rung))
        for direction, r in steps:
            _FLIGHT.record("degrade_step", rung=int(r),
                           name=RUNGS[r], direction=direction,
                           burn=float(burn))
            log.info("degrade ladder: %s rung %d (%s) at burn %.3g",
                     direction, r, RUNGS[r], burn)
        if steps and self.fleet is not None:
            try:
                self.fleet.apply_degrade(**self.policy(rung))
            except Exception:
                log.exception("degrade ladder: apply_degrade failed")
        return rung

    # -- standalone loop ----------------------------------------------
    def _loop(self, stop: threading.Event) -> None:
        while not stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception:
                # one bad pass must not silence the overload defense
                log.exception("degrade ladder evaluation failed")

    def start(self) -> "DegradeLadder":
        # fresh stop event: re-armable after a close() (a set() event
        # would end the new loop on its first wait); the thread
        # closes over ITS OWN event
        stop = threading.Event()
        thread = threading.Thread(target=self._loop, args=(stop,),
                                  name="dl4j-torch-degrade-ladder",
                                  daemon=True)
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self          # already running
            self._stop = stop
            self._thread = thread
        thread.start()
        return self

    def close(self) -> None:
        with self._lock:
            stop = self._stop
            thread = self._thread
            self._thread = None
        stop.set()
        if thread is not None:
            thread.join(timeout=max(5.0, 2 * self.interval_s))

    def __enter__(self) -> "DegradeLadder":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
