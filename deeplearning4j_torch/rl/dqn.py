"""Deep Q-learning (``org.deeplearning4j.rl4j.learning.sync.qlearning
.discrete.QLearningDiscreteDense`` + ``QLearning.QLConfiguration``,
``ExpReplay``, ``DQNPolicy``/``EpsGreedy``).  Port of
``deeplearning4j_tpu/rl/dqn.py``: the Q-networks live on ``device``
(default the card); actions and TD targets are read back to the host
through ``_host_output``."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.rl.mdp import MDP
from deeplearning4j_torch.utils.trees import map_leaves


@dataclasses.dataclass
class QLearningConfiguration:
    """``QLearning.QLConfiguration`` surface (subset)."""

    seed: int = 123
    max_epoch_step: int = 200
    max_step: int = 5000
    exp_replay_size: int = 10000
    batch_size: int = 64
    target_dqn_update_freq: int = 100
    update_start: int = 100
    gamma: float = 0.99
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 2000
    learning_rate: float = 1e-3


class ReplayBuffer:
    """``ExpReplay``: fixed-size ring of (s, a, r, s', done)."""

    def __init__(self, capacity: int, obs_size: int, seed: int = 0):
        self.capacity = int(capacity)
        self._s = np.zeros((capacity, obs_size), np.float32)
        self._a = np.zeros(capacity, np.int32)
        self._r = np.zeros(capacity, np.float32)
        self._s2 = np.zeros((capacity, obs_size), np.float32)
        self._d = np.zeros(capacity, np.float32)
        self._n = 0
        self._i = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self._n

    def add(self, s, a, r, s2, done):
        i = self._i
        self._s[i], self._a[i], self._r[i] = s, a, r
        self._s2[i], self._d[i] = s2, float(done)
        self._i = (i + 1) % self.capacity
        self._n = min(self._n + 1, self.capacity)

    def sample(self, batch_size: int):
        idx = self._rng.integers(0, self._n, batch_size)
        return (self._s[idx], self._a[idx], self._r[idx], self._s2[idx],
                self._d[idx])


class DQNPolicy:
    """Greedy policy over a trained Q-network (``DQNPolicy``)."""

    def __init__(self, q_net):
        self.q_net = q_net

    def next_action(self, obs: np.ndarray) -> int:
        q = self.q_net._host_output(obs[None])
        return int(q[0].argmax())

    def play(self, mdp: MDP, max_steps: int = 1000) -> float:
        obs = mdp.reset()
        total = 0.0
        for _ in range(max_steps):
            obs, r, done = mdp.step(self.next_action(obs))
            total += r
            if done:
                break
        return total


class QLearningDiscrete:
    """Synchronous DQN: epsilon-greedy exploration, replay buffer,
    target-network bootstrapping, Q-regression through the framework's
    train step (mse head), all on ``device``."""

    def __init__(self, mdp: MDP, conf: Optional[QLearningConfiguration]
                 = None, hidden: int = 64, device="cuda"):
        from deeplearning4j_torch.models.multi_layer_network import (
            MultiLayerNetwork)
        from deeplearning4j_torch.nn.conf import (DenseLayer,
                                                  NeuralNetConfiguration,
                                                  OutputLayer)
        from deeplearning4j_torch.optimize.updaters import Adam

        self.mdp = mdp
        self.conf = conf or QLearningConfiguration()
        c = self.conf

        def build():
            cfg = (NeuralNetConfiguration.builder().seed(c.seed)
                   .updater(Adam(learning_rate=c.learning_rate)).list()
                   .layer(DenseLayer(n_in=mdp.obs_size, n_out=hidden,
                                     activation="relu"))
                   .layer(DenseLayer(n_out=hidden, activation="relu"))
                   .layer(OutputLayer(n_out=mdp.n_actions,
                                      activation="identity", loss="mse"))
                   .build())
            return MultiLayerNetwork(cfg).init(device=device)

        self.q_net = build()
        self.target_net = build()
        self._sync_target()
        self.replay = ReplayBuffer(c.exp_replay_size, mdp.obs_size, c.seed)
        self._rng = np.random.default_rng(c.seed)
        self.step_count = 0
        self.episode_rewards: List[float] = []

    def _sync_target(self):
        # DEEP copy: q_net.fit updates its parameters in place every step
        self.target_net.params_tree = map_leaves(torch.clone,
                                                 self.q_net.params_tree)

    def _epsilon(self) -> float:
        c = self.conf
        frac = min(1.0, self.step_count / max(1, c.eps_decay_steps))
        return c.eps_start + frac * (c.eps_end - c.eps_start)

    def _act(self, obs) -> int:
        if self._rng.random() < self._epsilon():
            return int(self._rng.integers(0, self.mdp.n_actions))
        q = self.q_net._host_output(obs[None])
        return int(q[0].argmax())

    def _learn_batch(self):
        c = self.conf
        s, a, r, s2, d = self.replay.sample(c.batch_size)
        q_next = self.target_net._host_output(s2)
        target_value = r + c.gamma * (1.0 - d) * q_next.max(-1)
        # regression target: current Q with the taken action replaced
        target = self.q_net._host_output(s).copy()
        target[np.arange(len(a)), a] = target_value
        self.q_net.fit(DataSet(s, target.astype(np.float32)))

    def train(self) -> List[float]:
        """Run until ``max_step`` env steps; returns per-episode
        rewards."""
        c = self.conf
        while self.step_count < c.max_step:
            obs = self.mdp.reset()
            ep_reward, done, ep_steps = 0.0, False, 0
            while not done and ep_steps < c.max_epoch_step:
                action = self._act(obs)
                obs2, r, done = self.mdp.step(action)
                self.replay.add(obs, action, r, obs2, done)
                obs = obs2
                ep_reward += r
                ep_steps += 1
                self.step_count += 1
                if (self.step_count >= c.update_start
                        and len(self.replay) >= c.batch_size):
                    self._learn_batch()
                if self.step_count % c.target_dqn_update_freq == 0:
                    self._sync_target()
                if self.step_count >= c.max_step:
                    break
            self.episode_rewards.append(ep_reward)
        return self.episode_rewards

    def get_policy(self) -> DQNPolicy:
        return DQNPolicy(self.q_net)
