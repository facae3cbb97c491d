"""Random-number management (port of ``deeplearning4j_tpu/runtime/rng.py``).

The reference hands out never-reused jax PRNG keys; the port hands out
never-reused integer seeds from a counter (splitmix64 of (seed,
counter)), from which callers build explicit ``torch.Generator`` s
(``generator``).  Streams are reproducible per seed and checkpointable
(``state``/``set_state``), but are not the reference's threefry bits:
compare dropout and other draws by their statistics.
"""
from __future__ import annotations

import threading
from typing import List

import torch

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and an integer (``jax.random.fold_in``'s
    role): deterministic, and distinct keys for distinct data."""
    # 63 bits: a non-negative seed for torch.Generator.manual_seed
    return _splitmix64((int(key) * 0x9E3779B97F4A7C15 + int(data))
                       & _MASK) >> 1


def split(key: int, n: int) -> List[int]:
    """``n`` keys derived from ``key`` (``jax.random.split``'s role)."""
    return [fold_in(key, i + 1) for i in range(n)]


def generator(key: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``key``."""
    return torch.Generator(device=device).manual_seed(int(key))


class RngKeyManager:
    """Stateful facade over counter-derived keys: every ``next_key()``
    returns a fresh, never-reused integer key.  Thread safe."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self.seed = int(seed)
        self._counter = 0

    def next_key(self) -> int:
        with self._lock:
            self._counter += 1
            return fold_in(self.seed, self._counter)

    def next_keys(self, n: int) -> List[int]:
        return [self.next_key() for _ in range(n)]

    def reset(self, seed: int):
        with self._lock:
            self.seed = int(seed)
            self._counter = 0

    def state(self) -> List[int]:
        """``[seed, counter]`` — all a resumed run needs to replay the
        same key stream (the reference's key data plays this role), so a
        model built from another seed resumes the checkpointed stream."""
        with self._lock:
            return [self.seed, self._counter]

    def set_state(self, state) -> None:
        """Restore a ``state()``."""
        seed, counter = (int(v) for v in state)
        with self._lock:
            self.seed = seed
            self._counter = counter
