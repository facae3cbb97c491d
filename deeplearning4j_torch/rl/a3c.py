"""Asynchronous advantage actor-critic (A3C) + async n-step Q-learning
(port of ``deeplearning4j_tpu/rl/a3c.py``).

Parity surface: ``rl4j-core org.deeplearning4j.rl4j.learning.async.**``
(``A3CDiscrete``, ``AsyncNStepQLearningDiscrete``) — actor THREADS with
local parameter snapshots applying asynchronous gradients to a shared
global network.

Actors are host threads (environment stepping is cheap numpy control
flow; the interpreter lock is released while the device works): each
takes a parameter snapshot, collects a t_max rollout, computes gradients
with ``torch.autograd`` over the network's forward on ``device``
(default the card), and applies them to the shared parameters under a
lock.  An update builds new parameter tensors (``p - u``), so a snapshot
a thread still reads is never written.  Both learners share the
``_AsyncActorLearner`` scaffolding; they differ only in action
selection, the bootstrap value and the loss.

The shared step count is read under its own lock everywhere (the
reference's unlocked reads are baselined as CONC202); ``_lock`` and
``_step_lock`` are never held together.

THROUGHPUT CAVEAT: Python thread actors are interpreter-bound by
construction — this module exists for semantic parity with rl4j's async
learners (gridworld-scale convergence), not speed.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from deeplearning4j_torch.rl.mdp import MDP
from deeplearning4j_torch.runtime.backend import resolve_device
from deeplearning4j_torch.utils.trees import iter_leaves, map_leaves, set_path


def discounted_returns(rewards, bootstrap, dones, gamma):
    """Backward-accumulated n-step returns; a True in ``dones`` resets
    the accumulator (rollouts break at terminal steps, so at most the
    final entry is True)."""
    out = np.zeros(len(rewards), np.float32)
    acc = bootstrap
    for i in range(len(rewards) - 1, -1, -1):
        acc = rewards[i] + gamma * (0.0 if dones[i] else acc)
        out[i] = acc
    return out


def tree_grad(loss_fn, params, *args):
    """The gradient tree of ``loss_fn(params, *args)`` (a scalar tensor)
    with respect to every leaf of ``params`` — ``jax.grad``'s role.  The
    leaves are detached copies marked for grad; ``params`` is not
    touched."""
    live = map_leaves(lambda p: p.detach().requires_grad_(True), params)
    paths, leaves = zip(*iter_leaves(live))
    grads = torch.autograd.grad(loss_fn(live, *args), leaves)
    out = map_leaves(lambda p: None, params)
    for path, g in zip(paths, grads):
        set_path(out, path, g)
    return out


class _AsyncActorLearner:
    """Shared async-learning scaffolding.  Subclasses set, in __init__:
    ``conf`` (n_threads/t_max/gamma/max_step/max_epoch_step/seed),
    ``mdp_factory``, ``device``, ``_updater``, ``_opt_state``, and
    implement ``_get_params``/``_set_params``, ``_snapshot``,
    ``_select_action``, ``_bootstrap_value``, ``_rollout_grads``, and
    optionally ``_post_apply`` (e.g. target-network sync)."""

    def _init_shared(self):
        self._lock = threading.Lock()
        self._step_lock = threading.Lock()  # cheap, never held with _lock
        self.step_count = 0
        self.episode_rewards: List[float] = []

    def _steps(self) -> int:
        """The shared step count, read under its lock."""
        with self._step_lock:
            return self.step_count

    # -- subclass surface ----------------------------------------------
    def _get_params(self):
        raise NotImplementedError

    def _set_params(self, params):
        raise NotImplementedError

    def _snapshot(self):
        with self._lock:
            return self._get_params()

    def _select_action(self, snap, obs, rng) -> int:
        raise NotImplementedError

    def _bootstrap_value(self, snap, obs) -> float:
        raise NotImplementedError

    def _rollout_grads(self, snap, obs_batch, actions, returns):
        raise NotImplementedError

    def _post_apply(self, step: int):
        pass

    # -- shared machinery ----------------------------------------------
    def _obs(self, obs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(obs, np.float32),
                               device=self.device)

    def _apply(self, grads):
        step = self._steps()
        with self._lock, torch.no_grad():
            params = self._get_params()
            updates, self._opt_state = self._updater.update(
                grads, self._opt_state, params, step)
            params = map_leaves(lambda p, u: p - u, params, updates)
            self._opt_state = self._updater.finalize(self._opt_state,
                                                     params)
            self._set_params(params)
            self._post_apply(step)

    def _actor(self, tid: int):
        c = self.conf
        mdp = self.mdp_factory()
        rng = np.random.default_rng(c.seed * 1009 + tid)
        obs = mdp.reset()
        ep_reward, ep_steps = 0.0, 0
        while self._steps() < c.max_step:
            snap = self._snapshot()
            os_, as_, rs_, ds_ = [], [], [], []
            boot_obs = obs     # state to bootstrap from if truncated
            for _ in range(c.t_max):
                a = self._select_action(snap, obs, rng)
                obs2, r, done = mdp.step(a)
                os_.append(obs)
                as_.append(a)
                rs_.append(r)
                ds_.append(done)
                obs = boot_obs = obs2
                ep_reward += r
                ep_steps += 1
                with self._step_lock:  # += is a lost-update race
                    self.step_count += 1
                if done or ep_steps >= c.max_epoch_step:
                    with self._lock:
                        self.episode_rewards.append(ep_reward)
                    # boot_obs keeps the PRE-reset state: an epoch-limit
                    # truncation still bootstraps from where the
                    # rollout actually stopped
                    obs, ep_reward, ep_steps = mdp.reset(), 0.0, 0
                    break
            bootstrap = 0.0 if ds_[-1] else \
                self._bootstrap_value(snap, boot_obs)
            returns = discounted_returns(rs_, bootstrap, ds_, c.gamma)
            grads = self._rollout_grads(
                snap, self._obs(np.stack(os_)),
                torch.as_tensor(np.asarray(as_), dtype=torch.int64,
                                device=self.device),
                self._obs(returns))
            self._apply(grads)
        mdp.close()

    def train(self) -> List[float]:
        threads = [threading.Thread(target=self._actor, args=(t,))
                   for t in range(self.conf.n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return self.episode_rewards


# ---------------------------------------------------------------------------
# A3C
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class A3CConfiguration:
    n_threads: int = 2
    t_max: int = 8                 # rollout length per async update
    gamma: float = 0.95
    entropy_beta: float = 0.01
    value_coef: float = 0.5
    learning_rate: float = 3e-3
    max_step: int = 6000           # total env steps across all actors
    max_epoch_step: int = 100
    seed: int = 0


def _build_ac_graph(obs_size: int, n_actions: int, hidden: int,
                    lr: float, seed: int, device):
    from deeplearning4j_torch.models.computation_graph import ComputationGraph
    from deeplearning4j_torch.nn.conf import (DenseLayer, InputType,
                                              NeuralNetConfiguration,
                                              OutputLayer)
    from deeplearning4j_torch.optimize.updaters import Adam

    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(Adam(learning_rate=lr))
            .graph()
            .add_inputs("obs")
            .set_input_types(InputType.feed_forward(obs_size))
            .add_layer("h1", DenseLayer(n_out=hidden, activation="relu"),
                       "obs")
            .add_layer("h2", DenseLayer(n_out=hidden, activation="relu"),
                       "h1")
            .add_layer("policy", OutputLayer(n_out=n_actions,
                                             activation="identity",
                                             loss="mse"), "h2")
            .add_layer("value", OutputLayer(n_out=1,
                                            activation="identity",
                                            loss="mse"), "h2")
            .set_outputs("policy", "value")
            .build())
    return ComputationGraph(conf).init(device=device)


class A3CDiscrete(_AsyncActorLearner):
    """A3C over a discrete-action MDP; ``mdp_factory()`` builds one
    environment per actor thread.  The actor-critic network is a
    framework ``ComputationGraph`` with policy/value heads on ``device``;
    the A3C loss (policy-gradient x advantage + entropy bonus + value
    regression — rl4j ``ActorCriticLoss``) is differentiated through the
    graph's forward by ``torch.autograd``."""

    def __init__(self, mdp_factory: Callable[[], MDP],
                 conf: Optional[A3CConfiguration] = None,
                 hidden: int = 64, device="cuda"):
        from deeplearning4j_torch.optimize.updaters import Adam

        self.conf = conf or A3CConfiguration()
        c = self.conf
        self.device = resolve_device(device)
        self.mdp_factory = mdp_factory
        probe = mdp_factory()
        self.n_actions = probe.n_actions
        self.graph = _build_ac_graph(probe.obs_size, self.n_actions,
                                     hidden, c.learning_rate, c.seed,
                                     self.device)
        probe.close()
        self._updater = Adam(learning_rate=c.learning_rate)
        self._opt_state = self._updater.init_state(self.graph.params_tree)
        self._init_shared()

    def _heads(self, params, obs):
        return self.graph._forward_infer(params, self.graph.state_tree,
                                         {"obs": obs})

    def _loss(self, params, obs, actions, returns):
        c = self.conf
        outs = self._heads(params, obs)
        logits = outs["policy"].float()
        value = outs["value"].float()[:, 0]
        logp = torch.log_softmax(logits, -1)
        p = torch.exp(logp)
        adv = (returns - value).detach()
        taken = torch.take_along_dim(logp, actions[:, None], 1)[:, 0]
        policy_loss = -torch.mean(taken * adv)
        entropy = -torch.mean(torch.sum(p * logp, -1))
        value_loss = torch.mean(torch.square(returns - value))
        return policy_loss - c.entropy_beta * entropy \
            + c.value_coef * value_loss

    @torch.no_grad()
    def _policy_fwd(self, params, obs):
        return torch.softmax(self._heads(params, obs)["policy"].float(), -1)

    @torch.no_grad()
    def _value_fwd(self, params, obs):
        return self._heads(params, obs)["value"].float()

    def _get_params(self):
        return self.graph.params_tree

    def _set_params(self, params):
        self.graph.params_tree = params

    def _select_action(self, snap, obs, rng) -> int:
        probs = self._policy_fwd(snap, self._obs(obs[None])).cpu().numpy()[0]
        return int(rng.choice(self.n_actions, p=probs / probs.sum()))

    def _bootstrap_value(self, snap, obs) -> float:
        return float(self._value_fwd(snap, self._obs(obs[None]))[0, 0])

    def _rollout_grads(self, snap, obs_batch, actions, returns):
        return tree_grad(self._loss, snap, obs_batch, actions, returns)

    def get_policy(self):
        return ACPolicy(self)


class ACPolicy:
    """Greedy policy over the trained actor head (rl4j ``ACPolicy``)."""

    def __init__(self, learner: A3CDiscrete):
        self.learner = learner

    def next_action(self, obs: np.ndarray) -> int:
        ln = self.learner
        probs = ln._policy_fwd(ln.graph.params_tree, ln._obs(obs[None]))
        return int(probs.cpu().numpy()[0].argmax())

    def play(self, mdp: MDP, max_steps: int = 1000) -> float:
        obs = mdp.reset()
        total = 0.0
        for _ in range(max_steps):
            obs, r, done = mdp.step(self.next_action(obs))
            total += r
            if done:
                break
        return total


# ---------------------------------------------------------------------------
# Async n-step Q-learning
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class AsyncNStepQConfiguration:
    n_threads: int = 2
    t_max: int = 5                 # the n of n-step
    gamma: float = 0.95
    learning_rate: float = 3e-3
    max_step: int = 6000
    max_epoch_step: int = 100
    target_update_freq: int = 200
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 3000
    seed: int = 0


class AsyncNStepQLearningDiscrete(_AsyncActorLearner):
    """Async n-step Q-learning (rl4j ``AsyncNStepQLearningDiscrete``):
    actors collect n-step rollouts, compute TD targets against a shared
    target network, and apply gradients to the shared Q-network —
    replay-free asynchronous Q-learning."""

    def __init__(self, mdp_factory: Callable[[], MDP],
                 conf: Optional[AsyncNStepQConfiguration] = None,
                 hidden: int = 64, device="cuda"):
        from deeplearning4j_torch.models.multi_layer_network import (
            MultiLayerNetwork)
        from deeplearning4j_torch.nn.conf import (DenseLayer,
                                                  NeuralNetConfiguration,
                                                  OutputLayer)
        from deeplearning4j_torch.optimize.updaters import Adam

        self.conf = conf or AsyncNStepQConfiguration()
        c = self.conf
        self.device = resolve_device(device)
        self.mdp_factory = mdp_factory
        probe = mdp_factory()
        self.n_actions = probe.n_actions

        cfg = (NeuralNetConfiguration.builder().seed(c.seed)
               .updater(Adam(learning_rate=c.learning_rate)).list()
               .layer(DenseLayer(n_in=probe.obs_size, n_out=hidden,
                                 activation="relu"))
               .layer(DenseLayer(n_out=hidden, activation="relu"))
               .layer(OutputLayer(n_out=self.n_actions,
                                  activation="identity", loss="mse"))
               .build())
        self.q_net = MultiLayerNetwork(cfg).init(device=self.device)
        probe.close()
        self._target = map_leaves(torch.clone, self.q_net.params_tree)
        self._updater = Adam(learning_rate=c.learning_rate)
        self._opt_state = self._updater.init_state(self.q_net.params_tree)
        self._init_shared()

    def _q_of(self, params, obs):
        net = self.q_net
        return net._forward_layers(params, net.state_tree, obs, False,
                                   None)[0]

    def _loss(self, params, obs, actions, targets):
        q = self._q_of(params, obs).float()
        taken = torch.take_along_dim(q, actions[:, None], 1)[:, 0]
        return torch.mean(torch.square(targets - taken))

    @torch.no_grad()
    def _q_fwd(self, params, obs):
        return self._q_of(params, obs).float()

    def _get_params(self):
        return self.q_net.params_tree

    def _set_params(self, params):
        self.q_net.params_tree = params

    def _snapshot(self):
        with self._lock:
            return (self.q_net.params_tree, self._target)

    def _epsilon(self) -> float:
        c = self.conf
        frac = min(1.0, self._steps() / max(1, c.eps_decay_steps))
        return c.eps_start + frac * (c.eps_end - c.eps_start)

    def _select_action(self, snap, obs, rng) -> int:
        if rng.random() < self._epsilon():
            return int(rng.integers(0, self.n_actions))
        q = self._q_fwd(snap[0], self._obs(obs[None])).cpu().numpy()
        return int(q[0].argmax())

    def _bootstrap_value(self, snap, obs) -> float:
        q = self._q_fwd(snap[1], self._obs(obs[None]))
        return float(q[0].max())

    def _rollout_grads(self, snap, obs_batch, actions, returns):
        return tree_grad(self._loss, snap[0], obs_batch, actions, returns)

    def _post_apply(self, step: int):
        if step % self.conf.target_update_freq < self.conf.t_max:
            self._target = map_leaves(torch.clone, self.q_net.params_tree)
