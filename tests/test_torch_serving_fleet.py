"""The port's ServingFleet, held to the JAX package's
``tests/test_serving_fleet.py`` case by case (same names, same numpy
inputs, same assertions) at the same tiny Gpt on the CPU.

Greedy outputs routed through the admission layer (quotas, deadlines,
affinity / least-loaded placement, replica death and migration, elastic
scale) must equal the port's offline ``generate()`` — the router decides
only WHERE a request decodes, never WHAT (up to the near-tie rule of
``torch_serving_util``).  The reference's slow chaos matrix runs here in
the tier-1 suite: the eager CPU port has no compiles to amortize."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_serving_util import (CPU, assert_stream,  # noqa: E402
                                offline_ref, tiny_net)

from deeplearning4j_torch import telemetry  # noqa: E402
from deeplearning4j_torch.models.generation import (  # noqa: E402
    TransformerGenerator)
from deeplearning4j_torch.resilience import DeadlineExceededError  # noqa: E402
from deeplearning4j_torch.serving import (  # noqa: E402
    DeadlineInfeasibleError, QuotaExceededError, ServingFleet,
    TenantAccountant, TenantQuota)


@pytest.fixture(scope="module")
def net():
    return tiny_net()


@pytest.fixture(scope="module")
def offline(net):
    return TransformerGenerator(net, device="cpu")


def _outcome_total(outcome: str) -> float:
    fam = telemetry.get_registry().counter(
        "fleet_requests_total", labelnames=("tenant", "outcome"))
    return sum(c.value for vals, c in fam._items()
               if vals[1] == outcome)


def _dispatch_total(replica: int, reason: str) -> float:
    fam = telemetry.get_registry().counter(
        "fleet_replica_dispatch_total", labelnames=("replica", "reason"))
    return fam.labels(replica=str(replica), reason=reason).value


def test_tenancy_accounting_pure_host():
    """Token-bucket math with an injected clock: refill rate, burst
    cap, concurrency cap, queue cap, and the structural rejects —
    no servers, no compiles."""
    with pytest.raises(ValueError, match="tokens_per_s"):
        TenantQuota(tokens_per_s=-1)
    with pytest.raises(ValueError, match="burst"):
        TenantQuota(burst_tokens=0)
    acct = TenantAccountant(quotas={
        "metered": TenantQuota(tokens_per_s=10.0, burst_tokens=20.0,
                               max_concurrent=2, max_queued=2)})
    t = 1000.0
    # structural reject: cost above burst can never pass
    assert "never pass" in acct.reserve_queued("metered", 21.0, now=t)
    # queue cap
    assert acct.reserve_queued("metered", 5.0, now=t) is None
    assert acct.reserve_queued("metered", 5.0, now=t) is None
    assert "queue cap" in acct.reserve_queued("metered", 5.0, now=t)
    acct.drop_queued("metered")
    # bucket starts full at burst: 20 tokens available
    assert acct.try_dispatch("metered", 15.0, now=t) is True
    assert acct.try_dispatch("metered", 10.0, now=t) is False  # 5 left
    # refill at 10 tokens/s
    assert acct.try_dispatch("metered", 10.0, now=t + 0.6) is True
    # concurrency cap: 2 in flight
    assert acct.try_dispatch("metered", 1.0, now=t + 10.0) is False
    acct.release("metered")
    assert acct.try_dispatch("metered", 1.0, now=t + 10.0) is True
    # unknown tenants ride the (unlimited) default
    assert acct.reserve_queued("other", 1e9, now=t) is None
    assert acct.try_dispatch("other", 1e9, now=t) is True
    snap = acct.snapshot()
    assert snap["metered"]["concurrent"] == 2
    # refund: a charged-but-never-dispatched request returns its cost
    # (zero refill rate, so only the refund can restore the level)
    acct2 = TenantAccountant(quotas={
        "m": TenantQuota(tokens_per_s=0.0, burst_tokens=10.0)})
    assert acct2.try_dispatch("m", 8.0, now=t) is True
    assert acct2.try_dispatch("m", 9.0, now=t) is False   # 2 left
    acct2.release("m")
    acct2.refund("m", 8.0)
    assert acct2.try_dispatch("m", 9.0, now=t) is True    # restored


def test_parity_affinity_least_loaded_and_drain(net, offline):
    """ONE 2-replica fleet proves the routing matrix: byte parity on
    the affinity path (repeat rides to the warm replica; its — and
    only its — per-instance prefix-hit count rises) and the
    least-loaded path (distinct prompts spread across replicas), then
    drain(): the warm replica stops receiving even same-prefix
    traffic, its own admission closes, and in-flight work finishes."""
    reg = telemetry.get_registry()
    hits = reg.counter("prefix_cache_hits_total")
    p = np.arange(1, 14, dtype=np.int32)         # 3 full blocks @ bs=4
    ref = offline_ref(offline, p, 6)
    ref12 = offline_ref(offline, p, 12)
    with ServingFleet(net, n_replicas=2, n_slots=2, max_len=32,
                      block_size=4, tick_batch=1,
                      tick_timeout_s=None, **CPU) as fleet:
        h_seed = fleet.submit_async(p, n_new=6, tenant="hot")
        assert_stream(offline, h_seed.result(timeout=300), ref)
        warm = h_seed.replica
        cold = 1 - warm
        aff0 = _dispatch_total(warm, "affinity")
        hits0 = hits.value
        wh0 = fleet.replica(warm).stats()["prefix_hits"]
        ch0 = fleet.replica(cold).stats()["prefix_hits"]
        h_hit = fleet.submit_async(p, n_new=6, tenant="hot")
        assert_stream(offline, h_hit.result(timeout=300), ref)
        # affinity-routed to the warm replica, and the prefix-cache
        # hit landed THERE (per-instance split proves "only there")
        assert h_hit.replica == warm
        assert _dispatch_total(warm, "affinity") - aff0 >= 1
        assert fleet.replica(warm).stats()["prefix_hits"] - wh0 == 1
        assert fleet.replica(cold).stats()["prefix_hits"] - ch0 == 0
        assert hits.value - hits0 >= 1
        assert fleet.replica(warm).prefix_warmth(p) == 3
        assert fleet.replica(cold).prefix_warmth(p) == 0
        # least-loaded: two distinct prompts land on distinct replicas
        q1 = np.asarray([7, 8, 9, 4, 2], np.int32)
        q2 = np.asarray([9, 9, 1, 2, 3, 4], np.int32)
        h1 = fleet.submit_async(q1, n_new=5, tenant="cold")
        h2 = fleet.submit_async(q2, n_new=5, tenant="cold")
        assert_stream(
            offline, h1.result(timeout=300),
            offline_ref(offline, q1, 5))
        assert_stream(
            offline, h2.result(timeout=300),
            offline_ref(offline, q2, 5))
        assert {h1.replica, h2.replica} == {0, 1}
        assert fleet.stats()["healthy_replicas"] == 2
        # drain the warm replica with work in flight on it
        h_live = fleet.submit_async(p, n_new=12)
        fleet.drain(warm)
        with pytest.raises(RuntimeError, match="draining"):
            fleet.replica(warm).submit(p, n_new=2)
        # same-prefix request now routes to the OTHER replica (cold
        # cache there — still byte-identical, just a full prefill)
        h_after = fleet.submit_async(p, n_new=6)
        assert_stream(offline, h_after.result(timeout=300),
                                      ref)
        assert h_after.replica == cold
        # in-flight work was NOT migrated by a soft drain
        assert_stream(offline, h_live.result(timeout=300),
                                      ref12)
        assert h_live.migrations == 0
        st = fleet.stats()
        assert st["replicas"][warm]["draining"] is True
        assert st["healthy_replicas"] == 1


def test_quota_hot_tenant_capped_cold_still_schedules(net, offline):
    """A hot tenant capped at max_concurrent=1 serializes ITS OWN
    backlog; a cold tenant arriving behind that backlog dispatches
    immediately (the dispatch pass walks all tenants each pass — no
    FIFO head-of-line blocking across tenants)."""
    p_hot = np.asarray([3, 1, 4, 1, 5], np.int32)
    p_cold = np.asarray([2, 7, 1, 8], np.int32)
    ref_hot = offline_ref(offline, p_hot, 12)
    ref_cold = offline_ref(offline, p_cold, 4)
    q0 = _outcome_total("queued")
    with ServingFleet(net, n_replicas=1, n_slots=2, max_len=32,
                      tick_batch=1, tick_timeout_s=None, **CPU,
                      quotas={"hot": TenantQuota(max_concurrent=1)}
                      ) as fleet:
        hot = [fleet.submit_async(p_hot, n_new=12, tenant="hot")
               for _ in range(3)]
        h_cold = fleet.submit_async(p_cold, n_new=4, tenant="cold")
        assert_stream(offline, h_cold.result(timeout=300),
                                      ref_cold)
        # the cold tenant finished while the capped hot backlog was
        # still draining — it was not delayed behind it
        assert sum(not h.done() for h in hot) >= 1
        for h in hot:
            assert_stream(offline, h.result(timeout=300),
                                          ref_hot)
    assert _outcome_total("queued") - q0 >= 1   # the hot backlog waited


def test_deadline_infeasible_rejected_before_burning_blocks(net):
    """An unmeetable deadline fails at submit with the typed error —
    no queue entry, no KV blocks, no prefill (and no decode at all in
    this test: rejection must cost nothing)."""
    p = np.asarray([5, 9, 2, 7], np.int32)
    rej0 = _outcome_total("rejected_deadline")
    rejq0 = _outcome_total("rejected_quota")
    with ServingFleet(net, n_replicas=1, n_slots=2, max_len=32,
                      est_token_s=100.0, tick_batch=1,
                      tick_timeout_s=None, **CPU,
                      quotas={"capped": TenantQuota(tokens_per_s=1.0,
                                                    burst_tokens=5.0)}
                      ) as fleet:
        free0 = fleet.replica(0).stats()["free_blocks"]
        with pytest.raises(DeadlineInfeasibleError, match="floor"):
            fleet.submit_async(p, n_new=8, deadline_s=1.0)  # 800s floor
        with pytest.raises(DeadlineInfeasibleError):
            fleet.submit_async(p, n_new=8, deadline_s=-3.0)
        # a cost-above-burst quota violation is the same shape: typed,
        # immediate, nothing spent (cost 12 > burst 5 can never pass)
        with pytest.raises(QuotaExceededError, match="never pass"):
            fleet.submit_async(p, n_new=8, tenant="capped")
        assert fleet.replica(0).stats()["free_blocks"] == free0
        assert fleet.stats()["waiting"] == 0
    assert _outcome_total("rejected_deadline") - rej0 == 2
    assert _outcome_total("rejected_quota") - rejq0 == 1
    # typed vocabulary: infeasible-at-admission is NOT the resilience
    # layer's mid-flight expiry
    assert issubclass(DeadlineInfeasibleError, RuntimeError)
    assert not issubclass(DeadlineInfeasibleError, DeadlineExceededError)


def test_kill_one_of_two_replicas_migrates_mid_flight(net, offline):
    """SIGKILL-equivalent death of one replica with requests queued
    AND decoding on it: every affected request re-places onto the
    survivor and completes byte-identical to offline decode; the
    migrated outcome is counted and the fleet keeps serving."""
    p = np.arange(1, 14, dtype=np.int32)
    ref = offline_ref(offline, p, 12)
    mig0 = _outcome_total("migrated")
    with ServingFleet(net, n_replicas=2, n_slots=2, max_len=32,
                      block_size=4, tick_batch=1,
                      tick_timeout_s=None, **CPU) as fleet:
        h_seed = fleet.submit_async(p, n_new=2)
        h_seed.result(timeout=300)
        warm = h_seed.replica               # affinity routes the rest
        hs = [fleet.submit_async(p, n_new=12) for _ in range(3)]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if any(h.emitted > 0 for h in hs):
                break                       # mid-decode on the victim
            time.sleep(0.001)
        fleet.kill(warm)
        for h in hs:
            assert_stream(offline, h.result(timeout=300), ref)
        survivor = 1 - warm
        assert all(h.replica == survivor for h in hs if h.migrations)
        assert fleet.stats()["healthy_replicas"] == 1
        # the fleet keeps serving on the survivor
        assert_stream(
            offline, fleet.submit(p, n_new=12, timeout=300), ref)
    assert _outcome_total("migrated") - mig0 >= 1


def test_organic_replica_death_migrates_unresolved_handles(net,
                                                           offline):
    """A replica whose scheduler dies WITHOUT failing its handles
    (no watchdog armed — the handles would hang forever): the fleet's
    health sweep must declare it dead after ``dead_after_s`` and
    migrate its in-flight requests by ABANDONING the unresolved
    handles, not by waiting on a scheduler that resolves nothing."""
    p = np.arange(1, 14, dtype=np.int32)
    ref = offline_ref(offline, p, 12)
    with ServingFleet(net, n_replicas=2, n_slots=2, max_len=32,
                      block_size=4, tick_batch=1, tick_timeout_s=None,
                      **CPU,
                      dead_after_s=0.2) as fleet:
        h_seed = fleet.submit_async(p, n_new=2)
        h_seed.result(timeout=300)
        warm = h_seed.replica               # affinity pins the rest
        hs = [fleet.submit_async(p, n_new=12) for _ in range(3)]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if any(h.emitted > 0 for h in hs):
                break
            time.sleep(0.001)
        srv = fleet.replica(warm)
        with srv._lock:
            srv._epoch += 1       # the scheduler silently exits at
                                  # its next epoch check — in-flight
                                  # handles are NEVER resolved
        for h in hs:
            assert_stream(offline, h.result(timeout=300), ref)
        assert any(h.migrations >= 1 for h in hs)
        assert fleet.stats()["healthy_replicas"] == 1


def test_add_and_remove_replica_live_scale(net, offline):
    """Elastic serving: ``remove_replica`` rolls a replica
    out through the drain→migrate machinery (its in-flight work
    completes on the survivor, byte-identical), ``add_replica`` joins
    a newcomer that enters the dispatch candidate set only after its
    first successful ``stats()`` — and then serves byte-identical
    outputs; ``fleet_replicas_healthy`` tracks both transitions, and
    removing an unknown index raises typed."""
    reg = telemetry.get_registry()
    gauge = reg.gauge("fleet_replicas_healthy")
    p = np.arange(1, 14, dtype=np.int32)
    ref = offline_ref(offline, p, 12)
    with ServingFleet(net, n_replicas=2, n_slots=2, max_len=32,
                      block_size=4, tick_batch=1,
                      tick_timeout_s=None, **CPU) as fleet:
        with pytest.raises(ValueError, match="out of range"):
            fleet.remove_replica(7)
        # pin work on one replica via the affinity seed, then scale it
        # in mid-flight: the work must migrate and finish byte-equal
        h_seed = fleet.submit_async(p, n_new=2)
        h_seed.result(timeout=300)
        victim = h_seed.replica
        survivor = 1 - victim
        hs = [fleet.submit_async(p, n_new=12) for _ in range(2)]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if any(h.emitted > 0 for h in hs):
                break
            time.sleep(0.001)
        fleet.remove_replica(victim)
        for h in hs:
            assert_stream(offline, h.result(timeout=300), ref)
        st = fleet.stats()
        assert st["replicas"][victim]["removed"] is True
        assert st["healthy_replicas"] == 1
        # a removed index never rejoins the candidate set
        assert_stream(
            offline, fleet.submit(p, n_new=12, timeout=300), ref)
        # scale out: the newcomer joins only after a successful
        # stats() (the scheduler's health sweep promotes it)
        idx = fleet.add_replica()
        assert idx == 2 and fleet.n_replicas == 3
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if fleet.stats()["healthy_replicas"] == 2:
                break
            time.sleep(0.005)
        st = fleet.stats()
        assert st["healthy_replicas"] == 2
        assert st["replicas"][idx]["joining"] is False
        assert gauge.value == 2
        # route through the newcomer exclusively: byte parity holds
        fleet.drain(survivor)
        h_new = fleet.submit_async(p, n_new=12)
        assert_stream(offline, h_new.result(timeout=300), ref)
        assert h_new.replica == idx


def test_fleet_chaos_matrix_kill_and_hard_drain(net, offline):
    """3-replica churn soak (scan fusion ON — the default
    tick_batch): 12 mixed-tenant requests over two shared prefixes
    while one replica is killed and another hard-drained mid-flight —
    every output byte-identical, the fleet ends serving on the single
    survivor."""
    rng = np.random.default_rng(17)
    prefixes = [rng.integers(0, 50, 9).astype(np.int32)
                for _ in range(2)]
    with ServingFleet(net, n_replicas=3, n_slots=2, max_len=32,
                      block_size=4, tick_timeout_s=None, **CPU) as fleet:
        reqs, handles = [], []
        for i in range(12):
            tail = rng.integers(0, 50, int(rng.integers(1, 4))) \
                .astype(np.int32)
            prompt = np.concatenate([prefixes[i % 2], tail])
            n_new = int(rng.integers(8, 16))
            reqs.append((prompt, n_new))
            handles.append(fleet.submit_async(
                prompt, n_new, tenant=("hot", "cold")[i % 2]))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if any(h.emitted > 0 for h in handles):
                break
            time.sleep(0.001)
        busy = sorted({h.replica for h in handles
                       if h.replica is not None})
        victim = busy[0] if busy else 0
        fleet.kill(victim)
        fleet.drain((victim + 1) % 3, hard=True)
        for (prompt, n_new), h in zip(reqs, handles):
            assert_stream(
                offline, h.result(timeout=300),
                offline_ref(offline, prompt, n_new))
        assert fleet.stats()["healthy_replicas"] == 1
