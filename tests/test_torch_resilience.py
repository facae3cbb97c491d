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
serves from.  The training-side preemption and bad-step cases come with
their slice."""
import threading
import time

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
