"""MDP protocol (``org.deeplearning4j.rl4j.mdp.MDP``) + an in-repo test
environment (the gym-java-client dependency has no analogue offline).
Port of ``deeplearning4j_tpu/rl/mdp.py``: the same code, host only."""
from __future__ import annotations

from typing import Tuple

import numpy as np


class MDP:
    """reset() -> observation; step(action) -> (obs, reward, done);
    ``n_actions``/``obs_size`` describe the spaces."""

    n_actions: int
    obs_size: int

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> Tuple[np.ndarray, float, bool]:
        raise NotImplementedError

    def close(self):
        pass


class SimpleGridWorld(MDP):
    """Deterministic n x n grid: start at (0,0), goal at (n-1,n-1),
    actions U/D/L/R, -0.01 per step, +1 at the goal, episode cap
    4*n steps.  Observation = normalized (row, col)."""

    def __init__(self, n: int = 5):
        self.n = int(n)
        self.n_actions = 4
        self.obs_size = 2
        self._pos = (0, 0)
        self._steps = 0

    def _obs(self) -> np.ndarray:
        return np.asarray([self._pos[0] / (self.n - 1),
                           self._pos[1] / (self.n - 1)], np.float32)

    def reset(self) -> np.ndarray:
        self._pos = (0, 0)
        self._steps = 0
        return self._obs()

    def step(self, action: int):
        dr, dc = [(-1, 0), (1, 0), (0, -1), (0, 1)][int(action)]
        r = min(max(self._pos[0] + dr, 0), self.n - 1)
        c = min(max(self._pos[1] + dc, 0), self.n - 1)
        self._pos = (r, c)
        self._steps += 1
        at_goal = self._pos == (self.n - 1, self.n - 1)
        done = at_goal or self._steps >= 4 * self.n
        reward = 1.0 if at_goal else -0.01
        return self._obs(), reward, done
