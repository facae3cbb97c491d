"""Replica placement: prefix-affinity first, least-loaded fallback (copied
from ``deeplearning4j_tpu/serving/placement.py``).

The placement decision is two SORTS over advisory snapshots — it has
no lock of its own and holds nobody else's: each candidate view is
one ``GenerationServer.stats()`` call (lock-consistent per replica)
plus one ``prefix_warmth()`` membership probe.  Staleness is benign
by construction: routing a same-prefix request to a replica whose
cache just evicted costs a suffix prefill, never correctness, and a
full replica queues the request internally rather than failing it.

Policy:

* **affinity** — among candidates with ``warmth > 0`` (>= 1 of the
  prompt's leading full blocks resident in that replica's prefix
  cache), pick the warmest; the cached blocks map copy-free and only
  the suffix prefills, which is the dominant serving win when many
  requests share a system prompt.  Ties break toward more free KV
  blocks (affinity must not pile onto a starved replica when a twin
  is equally warm);
* **least_loaded** — otherwise pick the replica with the most free
  KV blocks (BLOCKS are the admission-scarce resource, not slots),
  ties toward fewer live-plus-queued requests, then the lowest
  index (deterministic, and keeps a cold fleet filling replica 0
  first so its cache warms fastest).

``failover`` is not chosen here — the router stamps it when it
re-places a request off a dead or hard-drained replica.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from deeplearning4j_torch.parallel.generation_server import GenerationServer

#: dispatch-reason labels on ``fleet_replica_dispatch_total``
AFFINITY = "affinity"
LEAST_LOADED = "least_loaded"
FAILOVER = "failover"
#: disaggregated serving: a long-prompt request's prefill
#: stage landing on a prefill-role replica, and its decode stage
#: landing on a decode replica carrying the exported prefix blocks
PREFILL = "prefill"
HANDOFF = "handoff"

#: per-replica roles (``ServingFleet(roles=...)``): a ``prefill``
#: replica only takes prefill stages of long-prompt requests, a
#: ``decode`` replica only decode traffic, ``unified`` (the default)
#: takes everything — existing fleets are untouched
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_UNIFIED = "unified"
ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_UNIFIED)


def replica_view(idx: int, server: GenerationServer,
                 prompt=None) -> Optional[dict]:
    """One candidate's advisory placement view, or None when the
    replica is not dispatchable (unhealthy or draining).  ``prompt``
    enables the affinity probe; omit it for prompt-less ranking."""
    st = server.stats()
    if not st["healthy"] or st["draining"]:
        return None
    warmth = server.prefix_warmth(prompt) if prompt is not None else 0
    return {"idx": idx, "warmth": warmth,
            "free_blocks": st["free_blocks"],
            "load": st["live_slots"] + st["queue_depth"],
            # speculative view: spec_k > 0 means an admission
            # on this replica pins ~2x blocks (target + draft tables)
            # — the router's per-pass block-claim compensation uses
            # it — and the acceptance rate is the replica's effective
            # tokens-per-verification multiplier (surfaced for fleet
            # stats/bench; deliberately NOT a ranking key, so a cold
            # replica's 0.0 cannot fight prefix affinity)
            "spec_k": st.get("spec_k", 0),
            "spec_acceptance": st.get("spec_acceptance_rate", 0.0)}


def choose_replica(views: Sequence[dict]) -> Tuple[int, str]:
    """Pick the target replica from non-None :func:`replica_view`
    snapshots; returns ``(replica index, reason label)``."""
    if not views:
        raise ValueError("no dispatchable replica views")
    warm = [v for v in views if v["warmth"] > 0]
    if warm:
        best = max(warm, key=lambda v: (v["warmth"], v["free_blocks"],
                                        -v["load"], -v["idx"]))
        return best["idx"], AFFINITY
    best = max(views, key=lambda v: (v["free_blocks"], -v["load"],
                                     -v["idx"]))
    return best["idx"], LEAST_LOADED
