"""The port's serving-side fault tolerance, held to the JAX package's
``tests/test_resilience.py`` serving cases (same names, same numpy inputs,
same fault plans, same assertions) at the same tiny Gpt on the CPU:
deterministic fault injection, bounded retry, the watchdog (crash and
stuck-tick recovery, the k-scaled deadline), block-granular salvage
(only the poisoned or never-committed slot fails), drain and cancel.

Outputs are held to the port's offline ``generate()`` under the near-tie
rule of ``torch_serving_util``.  The reference's donation-sanitizer case
has no counterpart (nothing is donated in the port); in its place,
``test_superseded_scheduler_writes_only_the_old_pool`` shows the epoch
fence on the device side: a dispatch abandoned by the watchdog keeps
writing the OLD pool tensors, never the salvaged pool the new scheduler
serves from.

The training cases (``tests/test_resilience.py``'s preemption, resume,
bad-step policy and checkpoint robustness) run each scenario in BOTH
packages on the same numpy data, the port's MLP starting from the JAX
one's parameters: the two agree on ``TrainingPreempted.step``,
``all_steps()``, the counters, the batch position and the deltas of the
training series, and the final params within 1e-5 (f32: the two sum in
different orders).  Inside each package a resumed run equals the
uninterrupted one bit for bit, with dropout too (the RNG position
travels with the checkpoint; the two packages draw different masks, so
the dropout case compares params only inside each).  The reference's
orbax import guard has no counterpart: the port writes its own format."""
import os
import signal
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_serving_util import (CPU, assert_stream,  # noqa: E402
                                offline_ref, tiny_net)

from deeplearning4j_torch import resilience, telemetry  # noqa: E402
from deeplearning4j_torch.models.generation import (  # noqa: E402
    TransformerGenerator)
from deeplearning4j_torch.parallel import GenerationServer  # noqa: E402
from deeplearning4j_torch.resilience import (  # noqa: E402
    CancelledError, DeadlineExceededError, FaultInjector, InjectedFault,
    RetryableServerError)

REG = telemetry.get_registry()


@pytest.fixture(scope="module")
def net():
    return tiny_net()


@pytest.fixture(scope="module")
def offline(net):
    return TransformerGenerator(net, device="cpu")


def test_fault_injector_deterministic_and_scoped():
    a = FaultInjector.random_plan(seed=7, horizon=100, n_faults=4)
    b = FaultInjector.random_plan(seed=7, horizon=100, n_faults=4)
    assert [(s.kind, s.at) for s in a.specs] == \
           [(s.kind, s.at) for s in b.specs]
    inj = FaultInjector(["nan_loss@3", "data_stall@1:0.01"])
    from deeplearning4j_torch.resilience import faults
    assert faults.active() is not inj
    with inj:
        assert faults.active() is inj
        assert not faults.fires("nan_loss", 2)
        assert faults.fires("nan_loss", 3)
        assert not faults.fires("nan_loss", 3)      # fires once
        assert faults.maybe_stall("data_stall", 1) > 0
        with FaultInjector(["step_exception@0"]):   # shadows `inj`
            with pytest.raises(InjectedFault, match="step_exception"):
                faults.maybe_fail("step_exception", 0)
        assert faults.active() is inj               # stack popped
    assert faults.active() is not inj
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultInjector(["meteor_strike@2"])
    env = FaultInjector.from_env("preempt@5, nan_loss@2:0.5")
    assert [(s.kind, s.at) for s in env.specs] == [("preempt", 5),
                                                   ("nan_loss", 2)]
    assert FaultInjector.from_env("") is None
    # the nan_loss site poisons floating leaves only, numpy and torch
    with FaultInjector(["nan_loss@0"]) as inj2:
        out = inj2.corrupt_batch(0, {"x": np.ones(3, np.float32),
                                     "ids": np.arange(3),
                                     "y": torch.ones(2)})
    assert np.isnan(out["x"]).all() and out["ids"].dtype.kind == "i"
    assert torch.isnan(out["y"]).all()


def test_retry_call_bounded_backoff():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RetryableServerError("transient")
        return "ok"

    assert resilience.retry_call(flaky, retries=3, base_delay=0.001,
                                 seed=0) == "ok"
    assert len(calls) == 3
    calls.clear()
    with pytest.raises(RetryableServerError):
        resilience.retry_call(flaky, retries=1, base_delay=0.001, seed=0)
    assert len(calls) == 2                    # 1 try + 1 retry, bounded
    with pytest.raises(ValueError):
        resilience.retry_call(lambda: (_ for _ in ()).throw(
            ValueError("not retryable")), retries=5, base_delay=0.001)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_recovers_scheduler_crash_concurrent_callers(net,
                                                              offline):
    """An injected scheduler crash with requests mid-decode: the
    watchdog salvages the unimplicated slots into a new pool and
    restarts the scheduler, so every concurrent caller — two decoding,
    one queued — completes without resubmission, as offline."""
    restarts = REG.counter("serve_watchdog_restarts_total")
    salvaged = REG.counter("kv_slots_salvaged_total")
    dropped = REG.counter("kv_slots_dropped_total")
    w0, s0, d0 = restarts.value, salvaged.value, dropped.value
    p = np.asarray([1, 2, 3, 4], np.int32)
    with GenerationServer(net, n_slots=2, max_len=32, tick_timeout_s=60,
                          **CPU) as srv:
        srv.submit(p, n_new=2, timeout=300)
        plan = (["serve_tick_stall@0:0.3"] +
                [f"serve_tick_stall@{k}:0.05" for k in range(1, 5)] +
                ["serve_tick_fail@5"])
        with FaultInjector(plan):
            hs = [srv.submit_async(p, n_new=24) for _ in range(3)]
            ref = offline_ref(offline, p, 24)
            for h in hs:
                assert_stream(offline, h.result(timeout=300), ref)
        assert restarts.value - w0 == 1
        assert salvaged.value - s0 == 2    # both decoding slots kept
        assert dropped.value - d0 == 0     # nobody failed
        assert srv.healthy()
        assert srv._healthy.value == 1
    assert not srv.healthy()
    assert srv._healthy.value == 0


def test_watchdog_scan_deadline_scales_with_k(net, offline):
    """A stall LONGER than tick_timeout_s but inside the K-scaled
    deadline of an 8-tick scan must NOT trip a recovery."""
    restarts = REG.counter("serve_watchdog_restarts_total")
    p = np.asarray([1, 2, 3], np.int32)
    with GenerationServer(net, n_slots=1, max_len=32, tick_timeout_s=60,
                          tick_batch=8, **CPU) as srv:
        srv.submit(p, n_new=8, timeout=300)
        srv.tick_timeout_s = 0.4
        w0 = restarts.value
        # 1.2s > tick_timeout_s, but the dispatch is marked k=8 -> 3.2s
        with FaultInjector(["serve_tick_stall@0:1.2"]):
            out = srv.submit(p, n_new=8, timeout=300)
        assert restarts.value - w0 == 0
        assert srv.healthy()
    assert_stream(offline, out, offline_ref(offline, p, 8))


def test_watchdog_recovers_stuck_tick_with_submit_retry(net, offline):
    """A hung tick (stall past tick_timeout_s): the watchdog fences the
    stuck scheduler out, and a blocking submit with retries rides
    through the recovery."""
    restarts = REG.counter("serve_watchdog_restarts_total")
    w0 = restarts.value
    p = np.asarray([5, 6, 7], np.int32)
    with GenerationServer(net, n_slots=2, max_len=32, tick_timeout_s=1.0,
                          tick_batch=1, submit_retries=4,
                          retry_backoff_s=0.02, **CPU) as srv:
        srv.submit(p, n_new=2, timeout=300)
        with FaultInjector(["serve_tick_stall@0:4.0"]):
            out = srv.submit(p, n_new=8, timeout=300)
        assert_stream(offline, out, offline_ref(offline, p, 8))
    assert restarts.value - w0 >= 1


def test_shutdown_drain_finishes_in_flight(net, offline):
    p = np.asarray([9, 8, 7], np.int32)
    srv = GenerationServer(net, n_slots=1, max_len=32, tick_timeout_s=None,
                           **CPU)
    hs = [srv.submit_async(p, n_new=10) for _ in range(3)]
    srv.shutdown(drain=True, timeout=300)
    with pytest.raises(RuntimeError, match="shut down"):
        srv.submit_async(p, n_new=2)                 # admission closed
    ref = offline_ref(offline, p, 10)
    for h in hs:
        assert_stream(offline, h.result(timeout=5), ref)


def test_cancel_and_deadline_release_queue_entries(net, offline):
    p = np.asarray([3, 1, 4], np.int32)
    with GenerationServer(net, n_slots=1, max_len=32, tick_timeout_s=None,
                          **CPU) as srv:
        h1 = srv.submit_async(p, n_new=25)           # holds the only slot
        h2 = srv.submit_async(p, n_new=25)           # waits in line
        hd = srv.submit_async(p, n_new=20, deadline_s=0.001)
        h3 = srv.submit_async(p, n_new=6)            # behind h2/hd
        assert h2.cancel() is True
        with pytest.raises(CancelledError):
            h2.result(timeout=300)
        with pytest.raises(DeadlineExceededError):   # expired in line
            hd.result(timeout=300)
        assert_stream(offline, h3.result(timeout=300),
                      offline_ref(offline, p, 6))
        h1.result(timeout=300)
        assert h1.cancel() is False                  # already done


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_salvage_drops_only_poisoned_slot(net, offline):
    """A stuck-tick watchdog restart with 2 live + 1 poisoned slot: the
    two unaffected callers complete as offline without resubmission
    (kv_slots_salvaged_total == 2), only the poisoned slot's caller
    fails retryably and rides a submit retry through
    (kv_slots_dropped_total == 1)."""
    from deeplearning4j_torch.resilience.faults import (
        poison_slot_kv, throttled_stall_plan)
    salvaged = REG.counter("kv_slots_salvaged_total")
    dropped = REG.counter("kv_slots_dropped_total")
    s0, d0 = salvaged.value, dropped.value
    p = np.asarray([1, 2, 3, 4], np.int32)
    ref = offline_ref(offline, p, 26)
    plan = throttled_stall_plan(15, "serve_tick_stall@16:2.2")
    res = {}
    with GenerationServer(net, n_slots=3, max_len=32, tick_timeout_s=0.8,
                          tick_batch=1, submit_retries=4,
                          retry_backoff_s=0.02, **CPU) as srv:
        srv.submit(p, n_new=2, timeout=300)
        with FaultInjector(plan):
            h0 = srv.submit_async(p, n_new=26)
            h1 = srv.submit_async(p, n_new=26)
            t = threading.Thread(target=lambda: res.update(
                v=srv.submit(p, n_new=26, timeout=300, retries=4)))
            t.start()                 # third admission -> slot 2
            for _ in range(2000):
                with srv._lock:
                    n = len(srv._active)
                if n == 3:
                    break
                time.sleep(0.005)
            assert n == 3
            with srv._lock:           # the victim thread's slot
                vslot = [s for s, r in srv._active.items()
                         if r not in (h0, h1)][0]
            assert poison_slot_kv(srv, vslot)
            o0 = h0.result(timeout=300)
            o1 = h1.result(timeout=300)
            t.join(timeout=300)
            assert not t.is_alive()
        assert_stream(offline, o0, ref)
        assert_stream(offline, o1, ref)
        assert_stream(offline, res["v"], ref)        # retried through
    assert salvaged.value - s0 == 2
    assert dropped.value - d0 == 1


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_salvage_never_admits_a_staged_uncommitted_slot(net, offline):
    """A request staged into ``_active`` whose prefill never COMMITTED
    must NOT be salvaged — its device rows are a previous occupant's.
    Recovery fails it retryably and salvages the live slot."""
    from deeplearning4j_torch.parallel.generation_server import _Pending
    from deeplearning4j_torch.resilience.faults import throttled_stall_plan
    salvaged = REG.counter("kv_slots_salvaged_total")
    dropped = REG.counter("kv_slots_dropped_total")
    s0, d0 = salvaged.value, dropped.value
    p = np.asarray([1, 2, 3, 4], np.int32)
    ref = offline_ref(offline, p, 26)
    plan = throttled_stall_plan(15, "serve_tick_stall@16:2.2")
    with GenerationServer(net, n_slots=2, max_len=32, tick_timeout_s=0.8,
                          tick_batch=1, **CPU) as srv:
        wa = srv.submit_async(p, n_new=2)
        wb = srv.submit_async(p, n_new=2)
        wa.result(timeout=300), wb.result(timeout=300)
        with FaultInjector(plan):
            h0 = srv.submit_async(p, n_new=26)
            for _ in range(2000):
                with srv._lock:
                    n = len(srv._active)
                if n == 1:
                    break
                time.sleep(0.005)
            assert n == 1
            staged = False
            for _ in range(4000):
                with srv._lock:
                    started = srv._tick_started
                if started is not None and \
                        time.monotonic() - started[1] > 0.35:
                    staged = True
                    break
                time.sleep(0.005)
            assert staged
            ghost = _Pending(p, 8, -1, 0)
            with srv._lock:
                gslot = srv._free.pop()
                srv._active[gslot] = ghost
                srv._staged.add(gslot)
            with pytest.raises(RetryableServerError):
                ghost.result(timeout=300)
            assert_stream(offline, h0.result(timeout=300), ref)
    assert salvaged.value - s0 == 1                  # only the live slot
    assert dropped.value - d0 == 1                   # the staged ghost


def test_superseded_scheduler_writes_only_the_old_pool(net, offline):
    """The epoch fence on the device side: a decode dispatch that holds
    the pool when it stalls past the deadline is abandoned by the
    watchdog, which salvages the live slot into a NEW pool and restarts
    the scheduler.  The abandoned dispatch then wakes and runs its ticks
    into the OLD pool tensors — the served stream (decoded from the new
    pool) still equals offline, and the new pool's tensors are not the
    ones the old thread wrote."""
    restarts = REG.counter("serve_watchdog_restarts_total")
    salvaged = REG.counter("kv_slots_salvaged_total")
    w0, s0 = restarts.value, salvaged.value
    p = np.asarray([2, 4, 6, 8, 1], np.int32)
    with GenerationServer(net, n_slots=2, max_len=32, tick_timeout_s=0.5,
                          tick_batch=1, **CPU) as srv:
        srv.submit(p, n_new=2, timeout=300)
        orig = srv._decode_scan
        held = {}
        woke = threading.Event()

        def stall_once(K, sampled, kc, vc, state):
            if not held:
                held["kc"] = kc
                held["before"] = kc.clone()
                time.sleep(2.0)       # past 0.5 s: the watchdog takes over
                out = orig(K, sampled, kc, vc, state)
                woke.set()
                return out
            return orig(K, sampled, kc, vc, state)

        srv._decode_scan = stall_once
        out = srv.submit(p, n_new=12, timeout=300)
        assert woke.wait(timeout=60)
        assert_stream(offline, out, offline_ref(offline, p, 12))
        assert restarts.value - w0 == 1
        assert salvaged.value - s0 == 1
        # the abandoned dispatch wrote its tick into the old pool ...
        assert not torch.equal(held["kc"], held["before"])
        # ... which is no longer the server's
        assert srv._kc.data_ptr() != held["kc"].data_ptr()
        assert srv.healthy()


# -- training: preemption, resume, the bad-step policy, checkpoints -------
@pytest.fixture
def one_torch_thread():
    """Torch on one intra-op thread for the test: its many small CPU ops
    otherwise spin a thread pool per test worker, and under the suite's
    parallel workers those pools starve each other (a 5 s case took over
    100 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COUNTERS = ("train_resumes_total", "train_preemptions_total",
            "bad_steps_skipped_total", "bad_steps_rolled_back_total",
            "checkpoint_saves_total", "checkpoint_failures_total")


def _side(name):
    """What a training scenario takes from one package.  ``model(seed)``
    builds the same 8-16-4 MLP in both: the port's from the JAX
    configuration and parameters of that seed."""
    import jax

    from deeplearning4j_tpu import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf.layers_core import (DenseLayer as JDense,
                                                        OutputLayer as JOut)

    def jax_model(seed, updater, dropout):
        conf = (JNNC.builder().seed(seed)
                .updater(updater or {"type": "Adam", "learning_rate": 1e-2})
                .list()
                .layer(JDense(n_in=8, n_out=16, activation="relu",
                              dropout=dropout))
                .layer(JOut(n_out=4, activation="softmax", loss="mcxent"))
                .build())
        return JMLN(conf).init()

    if name == "jax":
        from deeplearning4j_tpu import resilience as R
        from deeplearning4j_tpu import telemetry as T
        from deeplearning4j_tpu.data.dataset import DataSet as D
        from deeplearning4j_tpu.data.iterator import ListDataSetIterator as L
        from deeplearning4j_tpu.optimize.listeners import TrainingListener
        from deeplearning4j_tpu.parallel import (CheckpointListener,
                                                 ShardedCheckpointer)
        model = jax_model

        def leaves(tree):
            return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
    else:
        from deeplearning4j_torch import resilience as R
        from deeplearning4j_torch import telemetry as T
        from deeplearning4j_torch.data import DataSet as D
        from deeplearning4j_torch.data import ListDataSetIterator as L
        from deeplearning4j_torch.models.multi_layer_network import (
            MultiLayerNetwork)
        from deeplearning4j_torch.nn.conf.builder import (
            MultiLayerConfiguration)
        from deeplearning4j_torch.optimize.listeners import TrainingListener
        from deeplearning4j_torch.parallel import (CheckpointListener,
                                                   ShardedCheckpointer)
        from deeplearning4j_torch.utils import load_numpy_params
        from deeplearning4j_torch.utils.trees import iter_leaves

        def model(seed, updater, dropout):
            jnet = jax_model(seed, updater, dropout)
            net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
                jnet.conf.to_dict())).init(seed=seed, device="cpu")
            return load_numpy_params(net, jax.tree_util.tree_map(
                np.asarray, jnet.params_tree), device="cpu")

        def leaves(tree):
            # copies: the solver updates the live leaves in place
            return [t.numpy().copy() for _, t in iter_leaves(tree)]
    reg = T.get_registry()
    return types.SimpleNamespace(
        R=R, DataSet=D, TrainingListener=TrainingListener,
        CheckpointListener=CheckpointListener,
        ShardedCheckpointer=ShardedCheckpointer, leaves=leaves,
        model=lambda seed=3, updater=None, dropout=None: model(
            seed, updater, dropout),
        it=lambda x, y, bs=16: L(D(x, y).batch_by(bs)),
        counts=lambda: {c: reg.counter(c).value for c in COUNTERS})


def _data(n=96, seed=42):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def _same(S, a, b):
    return all(np.array_equal(p, q) for p, q in
               zip(S.leaves(a.params_tree), S.leaves(b.params_tree)))


def _kill_and_resume(S, tmp, dropout=None):
    """Checkpoint every 5 -> simulated preemption after iteration 8 ->
    a fresh model resumes; equal to the uninterrupted run."""
    x, y = _data()
    ref = S.model(dropout=dropout)
    ref_loss = ref.fit(S.it(x, y), n_epochs=3, async_prefetch=False)
    m = S.model(dropout=dropout)
    ck = S.CheckpointListener(tmp / "ck", save_every_n_iterations=5)
    m.set_listeners(ck)
    with pytest.raises(S.R.TrainingPreempted) as ei:
        with S.R.FaultInjector(["preempt@8"]):
            m.fit(S.it(x, y), n_epochs=3, async_prefetch=False)
    killed = (m.iteration_count, m.epoch_count, m.batch_in_epoch)
    S.R.clear_preemption()
    m2 = S.model(seed=99, dropout=dropout)
    m2._build_solver()
    m2.set_listeners(S.CheckpointListener(tmp / "ck"))
    loss2 = m2.fit(S.it(x, y), n_epochs=3, async_prefetch=False,
                   resume=True)
    assert float(loss2) == float(ref_loss)
    assert _same(S, ref, m2)
    return {"step": ei.value.step, "killed": killed,
            "steps": ck.ckpt.all_steps(), "loss": float(loss2),
            "counters": (m2.iteration_count, m2.epoch_count),
            "params": S.leaves(m2.params_tree)}


def _mid_step_state(S, tmp):
    """The restored snapshot equals the state the preempted model held."""
    x, y = _data(64)
    m = S.model()
    m.set_listeners(S.CheckpointListener(tmp / "ck2",
                                         save_every_n_iterations=100))
    with pytest.raises(S.R.TrainingPreempted):
        with S.R.FaultInjector(["preempt@5"]):
            m.fit(S.it(x, y), n_epochs=4, async_prefetch=False)
    S.R.clear_preemption()
    m2 = S.model(seed=42)
    m2._build_solver()
    step = S.CheckpointListener(tmp / "ck2").restore_into(m2)
    assert _same(S, m, m2)
    np.testing.assert_array_equal(np.asarray(m._rng.state()),
                                  np.asarray(m2._rng.state()))
    return {"step": step, "counters": (m2.iteration_count, m2.epoch_count,
                                       m2.batch_in_epoch),
            "params": S.leaves(m2.params_tree)}


def _real_sigterm(S, tmp):
    """A real SIGTERM mid-fit forces the final checkpoint and raises."""
    x, y = _data(64)
    m = S.model()
    ck = S.CheckpointListener(tmp / "sig", save_every_n_iterations=100)

    class Killer(S.TrainingListener):
        def iteration_done(self, model, iteration, epoch, loss):
            if iteration == 3:
                os.kill(os.getpid(), signal.SIGTERM)

    m.set_listeners(ck, Killer())
    with S.R.PreemptionGuard():
        with pytest.raises(S.R.TrainingPreempted) as ei:
            m.fit(S.it(x, y), n_epochs=5, async_prefetch=False)
    return {"step": ei.value.step, "steps": ck.ckpt.all_steps(),
            "counters": (m.iteration_count, m.epoch_count,
                         m.batch_in_epoch),
            "params": S.leaves(m.params_tree)}


def _auto_resume(S, tmp):
    """The supervisor re-enters a resumable fit across a step crash and a
    preemption, and reaches the uninterrupted run's exact state."""
    x, y = _data()
    ref = S.model()
    ref_loss = ref.fit(S.it(x, y), n_epochs=3, async_prefetch=False)
    m = S.model()
    ck = S.CheckpointListener(tmp / "sup", save_every_n_iterations=2)
    m.set_listeners(ck)
    with S.R.FaultInjector(["step_exception@7", "preempt@12"]):
        loss = S.R.auto_resume_fit(
            lambda: m.fit(S.it(x, y), n_epochs=3, async_prefetch=False,
                          resume=True),
            max_restarts=3, retry_on=(S.R.InjectedFault,))
    assert float(loss) == float(ref_loss)
    assert _same(S, ref, m)
    return {"loss": float(loss), "steps": ck.ckpt.all_steps(),
            "counters": (m.iteration_count, m.epoch_count),
            "params": S.leaves(m.params_tree)}


def _nan_skip_and_backoff(S, tmp):
    x, y = _data(32)
    m = S.model()
    m.fit(S.DataSet(x, y))
    before = S.leaves(m.params_tree)
    m.set_listeners(S.R.BadStepPolicy(max_consecutive=5))
    with S.R.FaultInjector([f"nan_loss@{m.iteration_count}"]):
        loss = m.fit(S.DataSet(x, y))
    assert np.isnan(loss)                     # reported, not hidden
    for a, b in zip(before, S.leaves(m.params_tree)):
        np.testing.assert_array_equal(a, b)   # update fully skipped
    backoff = m._lr_backoff
    m.set_listeners(S.R.BadStepPolicy(max_consecutive=5, recover_after=1))
    m.fit(S.DataSet(x, y), n_epochs=2)
    return {"backoff": (backoff, m._lr_backoff),
            "counters": (m.iteration_count, m.epoch_count),
            "params": S.leaves(m.params_tree)}


def _nan_rollback(S, tmp):
    x, y = _data()
    m = S.model()
    ck = S.CheckpointListener(tmp / "rb", save_every_n_iterations=2)
    m.set_listeners(ck, S.R.BadStepPolicy(max_consecutive=2, checkpoint=ck))
    with S.R.FaultInjector(["nan_loss@4", "nan_loss@5"]):
        loss = m.fit(S.it(x, y), n_epochs=2, async_prefetch=False)
    assert np.isfinite(loss)                  # training recovered
    ck.ckpt.wait()
    return {"loss": float(loss), "steps": ck.ckpt.all_steps(),
            "backoff": m._lr_backoff,
            "counters": (m.iteration_count, m.epoch_count),
            "params": S.leaves(m.params_tree)}


def _nan_without_checkpoint(S, tmp):
    x, y = _data(64)
    m = S.model()
    m.set_listeners(S.R.BadStepPolicy(max_consecutive=2))
    with S.R.FaultInjector(["nan_loss@0", "nan_loss@1"]):
        with pytest.raises(FloatingPointError, match="consecutive"):
            m.fit(S.it(x, y), n_epochs=2, async_prefetch=False)
    return {"counters": (m.iteration_count, m.epoch_count),
            "params": S.leaves(m.params_tree)}


def _lr_scale(S, tmp):
    """lr_scale=0.5 halves the applied SGD update."""
    x, y = _data(16)
    a, b = (S.model(updater={"type": "Sgd", "learning_rate": 0.1})
            for _ in range(2))
    for m in (a, b):
        m._check_init()
        m._build_solver()
    batch = a._batch_dict(S.DataSet(x, y))
    p0 = S.leaves(a.params_tree)
    for m, scale in ((a, 1.0), (b, 0.5)):
        (m.params_tree, m.opt_state, m.state_tree, _) = m._solver.step(
            m.params_tree, m.opt_state, m.state_tree, 0, batch,
            m._rng.next_key(), lr_scale=scale)
    for q0, qa, qb in zip(p0, S.leaves(a.params_tree),
                          S.leaves(b.params_tree)):
        np.testing.assert_allclose(qb - q0, (qa - q0) * 0.5, rtol=0,
                                   atol=1e-7)
    return {"params": S.leaves(b.params_tree)}


def _failed_write(S, tmp):
    x, y = _data()
    m = S.model()
    ck = S.CheckpointListener(tmp / "cf", save_every_n_iterations=2)
    m.set_listeners(ck)
    with S.R.FaultInjector(["checkpoint_fail@4"]):
        loss = m.fit(S.it(x, y), n_epochs=1, async_prefetch=False)
    assert np.isfinite(loss)
    ck.ckpt.wait()
    return {"loss": float(loss), "steps": ck.ckpt.all_steps(),
            "params": S.leaves(m.params_tree)}


def _legacy_step(S, tmp):
    """A step without the rng leaf and batch_in_epoch restores
    epoch-aligned."""
    x, y = _data(32)
    m = S.model()
    m.fit(S.DataSet(x, y))
    ck = S.ShardedCheckpointer(tmp / "legacy", async_save=False)
    ck.save(4, {"params": m.params_tree, "opt_state": m.opt_state,
                "model_state": m.state_tree,
                "counters": {"iteration": 5, "epoch": 1}})
    ck.wait()
    ck.close()
    fresh = S.model(seed=11)
    fresh._build_solver()
    step = S.CheckpointListener(tmp / "legacy").restore_into(fresh)
    assert _same(S, m, fresh)
    return {"step": step, "counters": (fresh.iteration_count,
                                       fresh.epoch_count,
                                       fresh.batch_in_epoch),
            "params": S.leaves(fresh.params_tree)}


_SCENARIOS = {
    "kill_and_resume": _kill_and_resume,
    "kill_and_resume_dropout": lambda S, tmp: _kill_and_resume(
        S, tmp, dropout=0.3),
    "mid_step_state": _mid_step_state,
    "real_sigterm": _real_sigterm,
    "auto_resume_fit": _auto_resume,
    "nan_skip_and_backoff": _nan_skip_and_backoff,
    "nan_rollback": _nan_rollback,
    "nan_without_checkpoint": _nan_without_checkpoint,
    "lr_scale": _lr_scale,
    "failed_write": _failed_write,
    "legacy_step": _legacy_step,
}


@pytest.mark.parametrize("case", list(_SCENARIOS))
def test_training_resilience_matches_jax(case, tmp_path, one_torch_thread):
    """The scenario in both packages: the same step labels, counters,
    batch positions and training-series deltas, and the final params
    within 1e-5 (the dropout case only inside each package)."""
    pytest.importorskip("jax")
    got = {}
    for name in ("jax", "port"):
        S = _side(name)
        S.R.clear_preemption()
        c0 = S.counts()
        try:
            obs = _SCENARIOS[case](S, tmp_path / name)
        finally:
            S.R.clear_preemption()
        obs["deltas"] = {k: v - c0[k] for k, v in S.counts().items()}
        got[name] = obs
    jp, pp = got["jax"].pop("params"), got["port"].pop("params")
    if "loss" in got["jax"] and case != "kill_and_resume_dropout":
        np.testing.assert_allclose(got["port"].pop("loss"),
                                   got["jax"].pop("loss"), rtol=1e-5)
    if case == "kill_and_resume_dropout":
        got["jax"].pop("loss"), got["port"].pop("loss")
    else:
        for a, b in zip(pp, jp):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert got["port"] == got["jax"]


# -- the port's checkpoint format ---------------------------------------
def _port_mlp():
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf import (DenseLayer,
                                              NeuralNetConfiguration,
                                              OutputLayer)
    conf = (NeuralNetConfiguration.builder().seed(3)
            .updater({"type": "Adam", "learning_rate": 1e-2}).list()
            .layer(DenseLayer(n_in=8, n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=4, activation="softmax",
                               loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def test_checkpoint_copies_at_save_and_keeps_bf16_bits(tmp_path):
    """``save`` returns with host copies taken (an in-place update after
    it does not reach the file); a bfloat16 leaf round-trips bit for bit
    as its raw 16-bit pattern; the sidecar records the world; a template
    of another shape or dtype is refused; a half-written step from a
    killed process is cleared and never listed."""
    from deeplearning4j_torch.parallel import ShardedCheckpointer
    w = torch.randn(5, 3)
    h = torch.randn(7).to(torch.bfloat16)
    state = {"w": w, "h": h, "empty": {}, "n": 3, "rng": [1, 2]}
    ck = ShardedCheckpointer(tmp_path / "fmt", keep_last=2)
    want = w.clone()
    ck.save(0, state)
    w.add_(1.0)                         # the live leaf moves on
    ck.wait()
    like = {"w": torch.zeros(5, 3), "h": torch.zeros(7, dtype=torch.bfloat16),
            "empty": {}, "n": 0, "rng": [0, 0]}
    step, got = ck.restore_latest(like)
    assert step == 0 and got["n"] == 3 and got["rng"] == [1, 2]
    assert torch.equal(got["w"], want)
    assert got["h"].dtype == torch.bfloat16
    assert torch.equal(got["h"].view(torch.int16), h.view(torch.int16))
    assert ck.world_at(0) == {"world": 1, "processes": 1, "devices": 1}
    assert ck.last_save["bytes"] > 0 and ck.last_save["host_copy_s"] >= 0
    with pytest.raises(ValueError, match="dtype"):
        ck.restore_latest({**like, "h": torch.zeros(7)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore_latest({**like, "w": torch.zeros(3, 5)})
    with pytest.raises(ValueError, match="template"):
        ck.restore_latest({k: v for k, v in like.items() if k != "n"})
    (tmp_path / "fmt" / "7.tmp").mkdir()
    assert ShardedCheckpointer(tmp_path / "fmt").all_steps() == [0]
    assert not (tmp_path / "fmt" / "7.tmp").exists()


def test_async_write_failure_surfaces_at_wait(tmp_path, monkeypatch):
    """A write that fails on the writer thread commits nothing, and the
    next ``wait()`` raises it; the listener counts it as a failed save
    and training goes on."""
    from deeplearning4j_torch.parallel import ShardedCheckpointer
    ck = ShardedCheckpointer(tmp_path / "af")
    ck.save(1, {"w": torch.ones(2)})
    ck.wait()

    def disk_full(*a, **kw):
        raise OSError("no space left on device")

    monkeypatch.setattr(np, "savez", disk_full)
    ck.save(2, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="no space"):
        ck.wait()
    ck.wait()                            # raised once
    assert ck.all_steps() == [1]
    assert sorted(p.name for p in (tmp_path / "af").iterdir()) == [
        "1", "world_1.json", "world_2.json"]


def test_all_steps_lists_a_write_that_lands_during_the_call(tmp_path,
                                                           monkeypatch):
    """A write that commits (and rotates) while ``all_steps()`` runs is
    still listed, as orbax lists a save from the moment it is taken: the
    write in flight is read before the directory.  Here the writer lands
    right after the directory is listed — reading the directory first
    would give [1, 2] and miss step 3, which made ``fit``'s forced
    preemption save collide with the periodic save of the same step."""
    from deeplearning4j_torch.parallel import ShardedCheckpointer
    ck = ShardedCheckpointer(tmp_path / "race", keep_last=2,
                             async_save=False)
    for step in (1, 2):
        ck.save(step, {"w": torch.ones(2)})
    listed = ck._committed

    def list_then_land():
        before = listed()
        (tmp_path / "race" / "3").mkdir()          # the writer commits
        ck.delete_step(1)                          # rotates
        ck._pending = None                         # and clears
        return before

    ck._pending = 3
    monkeypatch.setattr(ck, "_committed", list_then_land)
    assert ck.all_steps() == [2, 3]


def test_preemption_stops_the_prefetch_thread(tmp_path):
    """fit with async prefetch, preempted: the producer thread is gone
    when TrainingPreempted reaches the caller."""
    from deeplearning4j_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_torch.parallel import CheckpointListener
    x, y = _data(256)
    m = _port_mlp()
    m.set_listeners(CheckpointListener(tmp_path / "pf"))
    before = set(threading.enumerate())
    try:
        with pytest.raises(resilience.TrainingPreempted) as ei:
            with FaultInjector(["preempt@2"]):
                m.fit(ListDataSetIterator(DataSet(x, y).batch_by(8)),
                      n_epochs=1)
    finally:
        resilience.clear_preemption()
    assert ei.value.step == 2
    assert set(threading.enumerate()) <= before


def test_resume_phase_rehearsal_on_cpu(tmp_path, monkeypatch,
                                       one_torch_thread):
    """``chip_smoke.py``'s resume phase whole, on a tiny Gpt at t 1024
    (the K3 route) on the CPU, with counting stand-ins for the flash
    wrappers: preempted at 5 with steps [4, 5], the resumed run equal to
    the uninterrupted one bit for bit, 2 launches of K3/K5/K6 per
    resumed step, the bad-step rollback."""
    import importlib

    import chip_smoke
    from deeplearning4j_torch.zoo import Gpt
    fa = importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")

    def counted(orig):
        def wrapper(*a, **kw):
            wrapper.launches += 1
            return orig(*a, **kw)
        wrapper.launches = 0
        return wrapper

    for name in chip_smoke.FLASH_WRAPPERS:
        monkeypatch.setattr(fa, name, counted(getattr(fa, name)))
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    kw = dict(vocab_size=50, d_model=32, n_layers=2, n_heads=2, d_ff=64,
              seq_len=1024, max_len=1024, dropout=0.1)
    counts = chip_smoke.resume_parts(
        torch, np, lambda seed: Gpt(seed=seed, **kw).init_graph(
            device="cpu"),
        chip_smoke.resume_batches(np, 1, 1024, 50),
        chip_smoke.resume_batches(np, 1, 1024, 50, masked=True), 2,
        lambda: None, "cpu", str(tmp_path))
    assert counts == {"flash_fwd": 4, "flash_fwd_single": 0,
                      "flash_bwd_dkdv": 4, "flash_bwd_dq": 4}
    (row,) = lines
    assert row["a_uninterrupted"]["runs_equal_bitwise"]
    assert row["c_resumed"]["equal_bitwise"]
    assert row["checkpoint_steps"] == [4, 5] and row["bytes_per_step"] > 0
    assert row["d_bad_steps"]["rolled_back_to_checkpoint_4"]


def test_graph_kill_and_resume_bit_identical(tmp_path, one_torch_thread):
    """A ComputationGraph with a parameterless vertex (an empty subtree in
    every tree) and batch-norm state resumes after a preemption equal to
    the uninterrupted run, bit for bit."""
    from deeplearning4j_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_torch.nn.conf import (BatchNormalization, DenseLayer,
                                              ElementWiseVertex, InputType,
                                              NeuralNetConfiguration,
                                              OutputLayer)
    from deeplearning4j_torch.parallel import CheckpointListener
    from deeplearning4j_torch.utils.trees import iter_leaves

    def graph(seed):
        conf = (NeuralNetConfiguration.builder().seed(seed)
                .updater({"type": "AMSGrad", "learning_rate": 1e-2})
                .graph().add_inputs("in")
                .set_input_types(InputType.feed_forward(8))
                .add_layer("d1", DenseLayer(n_out=12, activation="tanh"),
                           "in")
                .add_layer("bn", BatchNormalization(), "d1")
                .add_layer("d2", DenseLayer(n_out=12, activation="tanh"),
                           "bn")
                .add_vertex("res", ElementWiseVertex("add"), "d1", "d2")
                .add_layer("out", OutputLayer(n_out=4, activation="softmax",
                                              loss="mcxent"), "res")
                .set_outputs("out").build())
        return ComputationGraph(conf).init(device="cpu")

    x, y = _data(64)
    it = lambda: ListDataSetIterator(DataSet(x, y).batch_by(16))
    ref = graph(3)
    ref_loss = ref.fit(it(), n_epochs=2, async_prefetch=False)
    m = graph(3)
    m.set_listeners(CheckpointListener(tmp_path / "g",
                                       save_every_n_iterations=3))
    try:
        with pytest.raises(resilience.TrainingPreempted) as ei:
            with FaultInjector(["preempt@4"]):
                m.fit(it(), n_epochs=2, async_prefetch=False)
    finally:
        resilience.clear_preemption()
    assert ei.value.step == 4
    m2 = graph(7)
    m2.set_listeners(CheckpointListener(tmp_path / "g"))
    assert m2.fit(it(), n_epochs=2, async_prefetch=False,
                  resume=True) == ref_loss
    for tree in ("params_tree", "state_tree", "opt_state"):
        a = list(iter_leaves(getattr(ref, tree)))
        b = list(iter_leaves(getattr(m2, tree)))
        assert [p for p, _ in a] == [p for p, _ in b] and a
        assert all(torch.equal(u, v) for (_, u), (_, v) in zip(a, b)), tree
    assert m2.params_tree["res"] == {}


PANGRAM_TEXT = "the quick brown fox jumps over the lazy dog. " * 40


def _char_rnn(seed):
    """A small TextGenerationLSTM (2 x 16 GravesLSTM, tBPTT 10) and a
    fresh iterator maker: t 30 in batches of 4, so 3 chunks a batch and
    14 batches (42 iterations) an epoch."""
    from deeplearning4j_torch.data import CharacterIterator
    from deeplearning4j_torch.zoo import TextGenerationLSTM
    it = lambda: CharacterIterator(PANGRAM_TEXT, seq_length=30, batch=4,
                                   seed=1)
    return TextGenerationLSTM(vocab_size=it().vocab_size, hidden=16,
                              tbptt_length=10, seed=seed).init_graph(
                                  device="cpu"), it


def _equal_trees(a, b):
    from deeplearning4j_torch.utils.trees import iter_leaves
    la, lb = list(iter_leaves(a)), list(iter_leaves(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(u, v) for (_, u), (_, v) in zip(la, lb))


@pytest.mark.parametrize("preempt,steps", [(5, [3, 5]),
                                           (50, [45, 48, 50])])
def test_tbptt_kill_and_resume_bit_identical(tmp_path, one_torch_thread,
                                             preempt, steps):
    """A char-RNN trained with truncated BPTT (3 chunks a batch) and
    preempted at a batch boundary — after iteration 5, the second
    batch's last chunk, or after iteration 50, the third batch of the
    SECOND epoch, whose order the iterator's rolling RNG draws afresh —
    resumes in a fresh model from another seed, over a fresh iterator,
    equal to the uninterrupted run bit for bit: params, Adam state and
    every loss.  The checkpoints hold no recurrent carry, so the fresh
    model restores them (port-only: the JAX package's checkpoint keeps
    the batch-sized carry, which a fresh model cannot restore)."""
    from deeplearning4j_torch.optimize import CollectScoresListener
    from deeplearning4j_torch.parallel import CheckpointListener
    ref, it = _char_rnn(5)
    ref_scores = CollectScoresListener()
    ref.set_listeners(ref_scores)
    ref.fit(it(), n_epochs=2)
    assert ref.iteration_count == 84
    m, _ = _char_rnn(5)
    ck = CheckpointListener(tmp_path / "rnn", save_every_n_iterations=3)
    m.set_listeners(ck, CollectScoresListener())
    try:
        with pytest.raises(resilience.TrainingPreempted) as ei:
            with FaultInjector([f"preempt@{preempt}"]):
                m.fit(it(), n_epochs=2)
    finally:
        resilience.clear_preemption()
    assert ei.value.step == preempt and ck.ckpt.all_steps() == steps
    assert m.listeners[1].scores == ref_scores.scores[:preempt + 1]
    with np.load(tmp_path / "rnn" / str(preempt) / "state.npz") as z:
        assert not [k for k in z.files if "rnn_" in k]
    m2, _ = _char_rnn(11)
    scores = CollectScoresListener()
    m2.set_listeners(CheckpointListener(tmp_path / "rnn"), scores)
    m2.fit(it(), n_epochs=2, resume=True)
    assert scores.scores == ref_scores.scores[preempt + 1:]
    assert (m2.iteration_count, m2.epoch_count) == (84, 2)
    for tree in ("params_tree", "opt_state", "state_tree"):
        assert _equal_trees(getattr(m2, tree), getattr(ref, tree)), tree


def test_tbptt_mid_batch_checkpoint_resumes_from_the_batch_start(
        tmp_path, one_torch_thread):
    """A periodic save between two chunks of a batch (iteration 3, the
    second batch's first chunk) resumes from that batch's start, with
    the params of the four chunks taken — the batch-granular rule."""
    from deeplearning4j_torch.optimize import CollectScoresListener
    from deeplearning4j_torch.optimize.listeners import TrainingListener
    from deeplearning4j_torch.parallel import CheckpointListener
    from deeplearning4j_torch.utils.trees import map_leaves

    class Snap(TrainingListener):
        def iteration_done(self, model, iteration, epoch, loss):
            if iteration == 3:
                self.params = map_leaves(torch.clone, model.params_tree)

    m, it = _char_rnn(5)
    snap = Snap()
    m.set_listeners(CheckpointListener(tmp_path / "mid",
                                       save_every_n_iterations=3), snap)
    try:
        with pytest.raises(resilience.TrainingPreempted):
            with FaultInjector(["preempt@5"]):
                m.fit(it(), n_epochs=1)
    finally:
        resilience.clear_preemption()
    ck = CheckpointListener(tmp_path / "mid")
    ck.ckpt.delete_step(5)
    m2, _ = _char_rnn(11)
    m2._build_solver()
    assert ck.restore_into(m2) == 3
    assert (m2.iteration_count, m2.batch_in_epoch) == (4, 1)
    assert _equal_trees(m2.params_tree, snap.params)
    scores = CollectScoresListener()
    m2.set_listeners(ck, scores)
    m2.fit(it(), n_epochs=1, resume=True)
    # batch 1 replays from its first chunk: 13 batches x 3 chunks
    assert [i for i, _ in scores.scores] == list(range(4, 43))
    assert m2.iteration_count == 43 and m2.epoch_count == 1


@pytest.mark.parametrize("make", ["char", "array"])
def test_set_epoch_gives_that_epochs_order(make):
    """``set_epoch(k)`` on a fresh iterator (what ``fit(resume=True)``
    calls) yields what the k-th pass of an uninterrupted one yields,
    for the rolling-RNG char iterator and a shuffling array iterator,
    whichever passes the iterator made before."""
    from deeplearning4j_torch.data import (ArrayDataSetIterator,
                                           CharacterIterator)
    if make == "char":
        new = lambda: CharacterIterator(PANGRAM_TEXT, seq_length=30,
                                        batch=4, seed=1)
    else:
        feats = np.arange(60, dtype=np.float32).reshape(20, 3)
        new = lambda: ArrayDataSetIterator(
            feats, np.eye(20, dtype=np.float32), 4, shuffle=True, seed=3)
    run = new()
    passes = [[ds.features.copy() for ds in run] for _ in range(3)]
    assert not np.array_equal(passes[0][0], passes[2][0])
    used = new()
    list(used)
    for k in (2, 0, 1):
        used.set_epoch(k)
        got = [ds.features for ds in used]
        assert len(got) == len(passes[k])
        assert all(np.array_equal(a, b) for a, b in zip(got, passes[k]))


# -- BERT MLM masks across epochs (BertIterator.set_epoch) ---------------
MLM_T = 16


def _mlm_iterator(package, seed=4):
    """``package``'s BertIterator over 24 tiny_sentiment sentences in
    the MLM task (batches of 8, t 16): three batches an epoch, every
    mask drawn from one rolling RNG."""
    import importlib
    ts = importlib.import_module(f"{package}.data.tiny_sentiment")
    bi = importlib.import_module(f"{package}.data.bert_iterator")
    tok = ts.make_tokenizer()
    rows = [s for s, _ in ts.load_tiny_sentiment()[:24]]
    return bi.BertIterator(tok, rows, 8, MLM_T, task="unsupervised",
                           seed=seed), len(tok.vocab)


def _masks(it):
    return [(mds.features[0].copy(), mds.labels[1].copy()) for mds in it]


def test_bert_iterator_masks_over_two_epochs_match_jax():
    """The port's MLM iterator draws the reference's masked ids and
    selections, epoch after epoch (the same numpy RNG stream); epoch 1's
    differ from epoch 0's."""
    pytest.importorskip("jax")
    got, _ = _mlm_iterator("deeplearning4j_torch")
    want, _ = _mlm_iterator("deeplearning4j_tpu")
    epochs = []
    for _ in range(2):
        g, w = _masks(got), _masks(want)
        assert len(g) == len(w) == 3
        for (gi, gs), (wi, ws) in zip(g, w):
            assert np.array_equal(gi, wi) and np.array_equal(gs, ws)
        epochs.append(g)
    assert not all(np.array_equal(a[1], b[1])
                   for a, b in zip(*epochs))


def test_bert_iterator_set_epoch_replays_the_rolling_rng():
    """``set_epoch(k)`` on a fresh iterator yields the k-th pass of an
    uninterrupted one, whichever passes it made before."""
    run, _ = _mlm_iterator("deeplearning4j_torch")
    passes = [_masks(run) for _ in range(3)]
    used, _ = _mlm_iterator("deeplearning4j_torch")
    _masks(used)
    for k in (2, 0, 1):
        used.set_epoch(k)
        for (gi, gs), (wi, ws) in zip(_masks(used), passes[k]):
            assert np.array_equal(gi, wi) and np.array_equal(gs, ws)


class _MlmBatches:
    """An MLM BertIterator as DataSets for a token classifier: features
    the masked ids, labels the one-hot targets, the attention mask as
    the features mask and the selection as the labels mask.  It offers
    ``set_epoch`` exactly when the wrapped iterator does."""

    def __init__(self, it, vocab):
        self.it, self.vocab = it, vocab

    def __iter__(self):
        from deeplearning4j_torch.data import DataSet
        eye = np.eye(self.vocab, dtype=np.float32)
        for mds in self.it:
            ids, mask, _ = mds.features
            tgt, sel = mds.labels
            yield DataSet(ids, eye[tgt], features_mask=mask.astype(
                np.float32), labels_mask=sel.astype(np.float32))

    def reset(self):
        self.it.reset()

    def __getattr__(self, name):
        if name == "set_epoch":
            return getattr(self.it, name)
        raise AttributeError(name)


def _tiny_mlm_bert(vocab, seed):
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf import (EmbeddingSequenceLayer,
                                              InputType,
                                              NeuralNetConfiguration,
                                              RnnOutputLayer,
                                              TransformerEncoderBlock)
    from deeplearning4j_torch.optimize.updaters import Adam
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(Adam(learning_rate=1e-2)).list()
            .set_input_type(InputType.feed_forward(MLM_T))
            .layer(EmbeddingSequenceLayer(n_in=vocab, n_out=16,
                                          max_len=MLM_T))
            .layer(TransformerEncoderBlock(n_heads=2, d_ff=32,
                                           use_flash=False))
            .layer(RnnOutputLayer(n_out=vocab, activation="softmax",
                                  loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def test_bert_mlm_kill_and_resume_in_the_second_epoch(tmp_path,
                                                     one_torch_thread):
    """A tiny BERT trained on the MLM task (3 batches an epoch, 2
    epochs), preempted after iteration 4 — the second epoch's second
    batch — resumes in a fresh model from another seed over a fresh
    iterator equal to the uninterrupted run bit for bit: every loss,
    params and Adam state.  ``fit(resume=True)`` calls the iterator's
    ``set_epoch(1)``, so the resumed batches mask with epoch 1's
    draws."""
    from deeplearning4j_torch.optimize import CollectScoresListener
    from deeplearning4j_torch.parallel import CheckpointListener
    it, vocab = _mlm_iterator("deeplearning4j_torch")
    ref = _tiny_mlm_bert(vocab, 5)
    ref_scores = CollectScoresListener()
    ref.set_listeners(ref_scores)
    ref.fit(_MlmBatches(it, vocab), n_epochs=2)
    assert ref.iteration_count == 6
    m = _tiny_mlm_bert(vocab, 5)
    ck = CheckpointListener(tmp_path / "mlm", save_every_n_iterations=2)
    m.set_listeners(ck)
    try:
        with pytest.raises(resilience.TrainingPreempted) as ei:
            with FaultInjector(["preempt@4"]):
                m.fit(_MlmBatches(_mlm_iterator("deeplearning4j_torch")[0],
                                  vocab), n_epochs=2)
    finally:
        resilience.clear_preemption()
    assert ei.value.step == 4
    m2 = _tiny_mlm_bert(vocab, 11)
    scores = CollectScoresListener()
    m2.set_listeners(CheckpointListener(tmp_path / "mlm"), scores)
    m2.fit(_MlmBatches(_mlm_iterator("deeplearning4j_torch")[0], vocab),
           n_epochs=2, resume=True)
    assert scores.scores == ref_scores.scores[5:]
    assert (m2.iteration_count, m2.epoch_count) == (6, 2)
    for tree in ("params_tree", "opt_state", "state_tree"):
        assert _equal_trees(getattr(m2, tree), getattr(ref, tree)), tree
