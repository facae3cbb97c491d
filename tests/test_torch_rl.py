"""The port's RL4J counterparts (``deeplearning4j_torch.rl``: DQN, A3C,
async n-step Q-learning) against the JAX package's on the CPU.

Held across packages on numpy-seeded inputs: the gridworld, the n-step
returns, one A3C gradient and one n-step-Q gradient on a fixed rollout
(the port's networks carry the JAX networks' parameters), and one DQN
fit on a fixed replay buffer — gradients and parameters within 1e-5.
Convergence on the reference tests' gridworld configurations is checked
in the port only: actor threads interleave differently in every run.
"""
import importlib
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.rl import (A3CConfiguration, A3CDiscrete,  # noqa
                                     AsyncNStepQConfiguration,
                                     AsyncNStepQLearningDiscrete,
                                     QLearningConfiguration,
                                     QLearningDiscrete, ReplayBuffer,
                                     SimpleGridWorld)
from deeplearning4j_torch.rl import a3c as pa3c  # noqa: E402
from deeplearning4j_torch.utils import load_numpy_params  # noqa: E402
from deeplearning4j_torch.utils.trees import iter_leaves  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread: tiny CPU ops whose thread pools would
    starve each other (and the actor threads) under parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jrl():
    jax = pytest.importorskip("jax")
    return jax, importlib.import_module("deeplearning4j_tpu.rl")


def _np_tree(jax, tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(got, want, tol=TOL):
    """``got`` (port tensors) against ``want`` (numpy) leaf by leaf."""
    g = dict(iter_leaves(got))
    w = dict(iter_leaves(want))
    assert set(g) == set(w)
    for path in g:
        np.testing.assert_allclose(g[path].detach().numpy(), w[path],
                                   rtol=0, atol=tol, err_msg=str(path))


def _rollout(n, seed):
    r = np.random.default_rng(seed)
    obs = r.random((n, 2)).astype(np.float32)
    actions = r.integers(0, 4, n).astype(np.int32)
    returns = r.normal(size=n).astype(np.float32)
    return obs, actions, returns


def test_gridworld_and_returns_equal_jax():
    _, J = _jrl()
    jm, pm = J.SimpleGridWorld(4), SimpleGridWorld(4)
    np.testing.assert_array_equal(pm.reset(), jm.reset())
    for a in np.random.default_rng(0).integers(0, 4, 30):
        for x, y in zip(pm.step(int(a)), jm.step(int(a))):
            np.testing.assert_array_equal(x, y)
    ja3c = importlib.import_module("deeplearning4j_tpu.rl.a3c")
    rs, ds = [0.1, -0.01, 1.0, -0.01], [False, False, True, False]
    np.testing.assert_array_equal(
        pa3c.discounted_returns(rs, 0.7, ds, 0.95),
        ja3c.discounted_returns(rs, 0.7, ds, 0.95))


def test_a3c_gradient_matches_jax():
    """The A3C loss's gradient (policy gradient x advantage, entropy
    bonus, value regression) on one fixed rollout: every leaf within
    1e-5 of ``jax.grad``'s."""
    jax, J = _jrl()
    import jax.numpy as jnp
    conf = dict(n_threads=1, seed=3)
    ja = J.A3CDiscrete(lambda: J.SimpleGridWorld(4),
                       J.A3CConfiguration(**conf), hidden=16)
    pa = A3CDiscrete(lambda: SimpleGridWorld(4), A3CConfiguration(**conf),
                     hidden=16, device="cpu")
    load_numpy_params(pa.graph, _np_tree(jax, ja.graph.params_tree),
                      device="cpu")
    obs, actions, returns = _rollout(8, 1)
    jg = ja._rollout_grads(ja.graph.params_tree, jnp.asarray(obs),
                           jnp.asarray(actions), jnp.asarray(returns))
    pg = pa._rollout_grads(pa.graph.params_tree, torch.from_numpy(obs),
                           torch.from_numpy(actions).long(),
                           torch.from_numpy(returns))
    _assert_trees_close(pg, _np_tree(jax, jg))
    # the policy and value heads the actors read
    np.testing.assert_allclose(
        pa._policy_fwd(pa.graph.params_tree, torch.from_numpy(obs)).numpy(),
        np.asarray(ja._policy_fwd(ja.graph.params_tree, jnp.asarray(obs))),
        rtol=0, atol=TOL)


def test_nstep_q_gradient_matches_jax():
    jax, J = _jrl()
    import jax.numpy as jnp
    ja = J.AsyncNStepQLearningDiscrete(
        lambda: J.SimpleGridWorld(4), J.AsyncNStepQConfiguration(seed=5),
        hidden=16)
    pa = AsyncNStepQLearningDiscrete(
        lambda: SimpleGridWorld(4), AsyncNStepQConfiguration(seed=5),
        hidden=16, device="cpu")
    load_numpy_params(pa.q_net, _np_tree(jax, ja.q_net.params_tree),
                      device="cpu")
    obs, actions, targets = _rollout(5, 2)
    jg = ja._rollout_grads((ja.q_net.params_tree, None), jnp.asarray(obs),
                           jnp.asarray(actions), jnp.asarray(targets))
    pg = pa._rollout_grads((pa.q_net.params_tree, None),
                           torch.from_numpy(obs),
                           torch.from_numpy(actions).long(),
                           torch.from_numpy(targets))
    _assert_trees_close(pg, _np_tree(jax, jg))


def test_dqn_fit_on_a_fixed_replay_matches_jax():
    """One TD update: the same replay contents, the same seeded sample
    (the buffers' numpy generators), the same target network; the
    Q-network's parameters after ``_learn_batch`` within 1e-5."""
    jax, J = _jrl()
    kw = dict(seed=7, batch_size=16, exp_replay_size=64, gamma=0.9)
    jq = J.QLearningDiscrete(J.SimpleGridWorld(4),
                             J.QLearningConfiguration(**kw), hidden=16)
    pq = QLearningDiscrete(SimpleGridWorld(4), QLearningConfiguration(**kw),
                           hidden=16, device="cpu")
    for net in ("q_net", "target_net"):
        load_numpy_params(getattr(pq, net),
                          _np_tree(jax, getattr(jq, net).params_tree),
                          device="cpu")
    r = np.random.default_rng(11)
    for _ in range(40):
        s, s2 = r.random(2), r.random(2)
        a, rew, done = int(r.integers(0, 4)), float(r.normal()), \
            bool(r.random() < 0.2)
        jq.replay.add(s, a, rew, s2, done)
        pq.replay.add(s, a, rew, s2, done)
    for q in (jq, pq):
        q._learn_batch()
    _assert_trees_close(pq.q_net.params_tree,
                        _np_tree(jax, jq.q_net.params_tree))


def test_replay_buffer_ring():
    rb = ReplayBuffer(4, 2, seed=0)
    for i in range(6):
        rb.add([i, i], i % 4, float(i), [i + 1, i + 1], False)
    assert len(rb) == 4
    s, a, r, s2, d = rb.sample(8)
    assert s.shape == (8, 2) and (r >= 2).all()  # oldest overwritten


# -- convergence, in the port only --------------------------------------
def test_dqn_solves_gridworld():
    mdp = SimpleGridWorld(4)
    conf = QLearningConfiguration(
        seed=7, max_step=2500, batch_size=32, update_start=64,
        target_dqn_update_freq=50, eps_decay_steps=1500,
        learning_rate=2e-3, exp_replay_size=4000)
    ql = QLearningDiscrete(mdp, conf, hidden=32, device="cpu")
    rewards = ql.train()
    assert len(rewards) > 5
    total = ql.get_policy().play(SimpleGridWorld(4), max_steps=40)
    assert total > 0.8, total


def test_a3c_converges_on_gridworld():
    a3c = A3CDiscrete(
        lambda: SimpleGridWorld(4),
        A3CConfiguration(n_threads=2, max_step=5000, t_max=8,
                         learning_rate=5e-3, seed=1), device="cpu")
    rewards = a3c.train()
    assert len(rewards) > 50
    early, late = np.mean(rewards[:10]), np.mean(rewards[-10:])
    assert late > 0.8, (early, late)          # optimal is 0.95
    assert late > early + 0.3
    score = a3c.get_policy().play(SimpleGridWorld(4), max_steps=50)
    assert score > 0.8, score


def test_async_nstep_q_converges_on_gridworld():
    """Async learning under thread-scheduling nondeterminism: any of three
    seeds, as the reference's test accepts."""
    lates = []
    for seed in (2, 12, 22):
        nq = AsyncNStepQLearningDiscrete(
            lambda: SimpleGridWorld(4),
            AsyncNStepQConfiguration(n_threads=2, max_step=6000, seed=seed),
            device="cpu")
        rewards = nq.train()
        assert len(rewards) > 50
        lates.append(np.mean(rewards[-10:]))
        if lates[-1] > 0.8:
            return
    raise AssertionError(f"no seed converged: {lates}")


def test_actor_threads_lose_no_step_under_contention():
    """Six actor threads (more than this box's workers give a test) with a
    short switch interval: every environment step is counted once in the
    shared step count, and every thread contributed episodes."""
    steps = []
    lock = threading.Lock()

    class Counted(SimpleGridWorld):
        def step(self, action):
            with lock:
                steps.append(threading.get_ident())
            return super().step(action)

    conf = A3CConfiguration(n_threads=6, max_step=600, t_max=5, seed=3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        a3c = A3CDiscrete(lambda: Counted(3), conf, hidden=8, device="cpu")
        done = threading.Event()
        runner = threading.Thread(target=lambda: (a3c.train(), done.set()))
        runner.start()
        runner.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert done.is_set() and not runner.is_alive()
    assert a3c.step_count == len(steps) >= conf.max_step
    assert len(set(steps)) == conf.n_threads
    assert len(a3c.episode_rewards) > 5
