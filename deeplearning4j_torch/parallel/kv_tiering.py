"""Tiered KV block cache: the host-RAM tier under the device pool (copied
from ``deeplearning4j_tpu/parallel/kv_tiering.py``).

Device memory is the binding serving constraint, and the prefix cache
is capped at the device pool size: an
LRU-evicted prefix block simply DIED, so the effective prefix cache
could never exceed HBM.  This module adds the next tier down the
memory hierarchy — :class:`HostKVTier`, a capacity-bounded host-RAM
LRU of spilled KV blocks:

* **spill** — when ``GenerationServer`` admission evicts a refcount-0
  prefix-cache block to reclaim pool space, the block's raw K/V bytes
  (one D2H copy of ``[n_layers, h, block_size, dh]`` per leaf) land
  here instead of dying, keyed by the SAME chain hash the device
  prefix map uses and carrying the block's raw token bytes;
* **fetch** — when a later admission's chain-hash walk misses the
  device map but hits the tier, the server claims a free pool block
  and restores the spilled bytes with ONE batched H2D copy inside the
  admission (one tensor of the stacked entries) — the
  request prefills only the still-uncached suffix, paying a block copy
  instead of a full re-prefill, which multiplies the effective prefix
  cache far past HBM-resident blocks;
* **handoff** — disaggregated prefill/decode serving rides the same
  store: ``GenerationServer.export_prefix`` serializes a finished
  prefix's blocks (hash + token bytes + K/V bytes) and
  ``import_blocks`` lands them in the TARGET replica's tier, where the
  handed-off request's admission restores them exactly like a tier
  hit; once restored they are device-resident prefix-cache entries
  every later same-prefix admission maps copy-free.

Entries are verified on every lookup against the block's RAW TOKEN
BYTES (the prefix-cache rule: ``hash()`` is 64-bit and non-cryptographic — a
collision must degrade to a miss, never map another prompt's KV into a
request), and the tier keeps its own LRU independent of the device
pool's (a block can be hot host-side while cold device-side and vice
versa).

Concurrency: the tier is shared cross-thread state — the owning
server's scheduler thread spills/fetches under the SERVER lock while
router threads import handoffs concurrently — so every public method
takes the tier's own ``_lock``.  Lock order is always server lock →
tier lock (the tier never calls back into a server), so the nesting
cannot deadlock.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_torch import telemetry

#: resident host-tier entries (one spilled/imported KV block each) —
#: the footprint knob ``host_tier_blocks`` bounds
_TIER_BLOCKS = telemetry.gauge(
    "kv_host_tier_blocks",
    "KV blocks resident in the host-RAM tier (spilled device "
    "evictions + imported handoffs; capacity-bounded LRU)")
_TIER_EVICTED = telemetry.counter(
    "kv_tier_evictions_total",
    "host-tier entries dropped by the tier's OWN capacity LRU (the "
    "block is now gone from both tiers — the next same-prefix "
    "admission re-prefills)")
#: flight recorder: capacity evictions are the allocator
#: decisions a postmortem wants beside the server's spill/fetch events
_FLIGHT = telemetry.get_flight_recorder()


class HostKVTier:
    """Capacity-bounded host-RAM LRU of spilled KV blocks.

    One entry per chain hash: ``(token_bytes, k, v)`` with ``k``/``v``
    host numpy arrays of shape ``[n_layers, h, block_size, dh]`` in
    the pool's compute dtype — the exact bytes the device block held,
    so a spill→fetch round trip is byte-stable by construction.

    ``capacity_blocks`` bounds residency; inserting past it evicts the
    true-LRU entry (least-recently inserted OR fetched — ``get``
    touches, ``peek`` does not)."""

    def __init__(self, capacity_blocks: int):
        self.capacity_blocks = int(capacity_blocks)
        if self.capacity_blocks < 1:
            raise ValueError("capacity_blocks must be >= 1")
        self._lock = threading.Lock()
        self._entries: "OrderedDict[int, Tuple[bytes, np.ndarray, np.ndarray]]" \
            = OrderedDict()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def put(self, hsh: int, tok: bytes, k, v) -> int:
        """Insert/refresh the entry for chain hash ``hsh`` (MRU
        position); returns how many LRU entries the capacity bound
        evicted to make room.  A same-hash insert overwrites — lookups
        verify ``tok``, so a hash-colliding overwrite degrades the
        OTHER prompt's lookup to a miss, never to wrong bytes."""
        k = np.asarray(k)
        v = np.asarray(v)
        n_evicted = 0
        with self._lock:
            self._entries[hsh] = (bytes(tok), k, v)
            self._entries.move_to_end(hsh)
            while len(self._entries) > self.capacity_blocks:
                self._entries.popitem(last=False)
                n_evicted += 1
            n_resident = len(self._entries)
        if n_evicted:
            _TIER_EVICTED.inc(n_evicted)
            _FLIGHT.record("tier_evict", evicted=n_evicted,
                           resident=n_resident)
        _TIER_BLOCKS.set(n_resident)
        return n_evicted

    def get(self, hsh: int, tok: bytes
            ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Verified lookup WITH an LRU touch (the fetch path).
        Returns ``(k, v)`` or None — a token-bytes mismatch (hash
        collision) is a miss, and the colliding entry is left in
        place for its rightful prompt."""
        with self._lock:
            entry = self._entries.get(hsh)
            if entry is None or entry[0] != tok:
                return None
            self._entries.move_to_end(hsh)
            return entry[1], entry[2]

    def peek(self, hsh: int, tok: bytes
             ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Verified lookup WITHOUT the LRU touch — warmth probes and
        exports must not reorder the eviction queue."""
        with self._lock:
            entry = self._entries.get(hsh)
            if entry is None or entry[0] != tok:
                return None
            return entry[1], entry[2]

    def touch(self, hsh: int) -> None:
        """Promote one entry to MRU — the COMMIT-time companion of
        ``peek``: admission planning peeks (a plan that never commits
        must not reorder the eviction queue), and the admit commit
        touches exactly the entries it restored."""
        with self._lock:
            if hsh in self._entries:
                self._entries.move_to_end(hsh)

    def discard(self, hsh: int) -> bool:
        """Drop one entry (True when it existed)."""
        with self._lock:
            existed = self._entries.pop(hsh, None) is not None
            n = len(self._entries)
        _TIER_BLOCKS.set(n)
        return existed

    def hashes(self):
        """Snapshot of resident chain hashes in LRU→MRU order
        (tests/introspection)."""
        with self._lock:
            return list(self._entries)

    def stats(self) -> dict:
        with self._lock:
            n = len(self._entries)
            nbytes = sum(e[1].nbytes + e[2].nbytes
                         for e in self._entries.values())
        return {"blocks": n, "capacity_blocks": self.capacity_blocks,
                "bytes": nbytes}
