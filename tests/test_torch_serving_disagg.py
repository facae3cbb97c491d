"""The port's disaggregated prefill/decode serving, held to the JAX
package's ``tests/test_serving_disagg.py`` case by case (same names, same
numpy inputs) at the same tiny Gpt on the CPU: per-replica ``roles``
split the fleet, the router stages long prompts prefill replica ->
block handoff (``export_prefix`` -> ``import_blocks``) -> decode replica,
and the output equals the port's offline ``generate()`` (near-tie rule
of ``torch_serving_util``) across block sizes.  Unlike the reference,
the block-boundary case throttles nothing: its assertions do not depend
on which requests batch together.  A prefill replica killed mid-handoff
re-places its requests through the migration machinery."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_serving_util import (CPU, assert_stream,  # noqa: E402
                                offline_ref, tiny_net)

from deeplearning4j_torch import telemetry  # noqa: E402
from deeplearning4j_torch.models.generation import (  # noqa: E402
    TransformerGenerator)
from deeplearning4j_torch.serving import ServingFleet  # noqa: E402


@pytest.fixture(scope="module")
def net():
    return tiny_net()


@pytest.fixture(scope="module")
def offline(net):
    return TransformerGenerator(net, device="cpu")


def _dispatch_total(replica: int, reason: str) -> float:
    fam = telemetry.get_registry().counter(
        "fleet_replica_dispatch_total", labelnames=("replica", "reason"))
    return fam.labels(replica=str(replica), reason=reason).value


def _outcome_total(outcome: str) -> float:
    fam = telemetry.get_registry().counter(
        "fleet_requests_total", labelnames=("tenant", "outcome"))
    return sum(c.value for vals, c in fam._items()
               if vals[1] == outcome)


def test_roles_validation(net):
    """Bad role configs fail BEFORE any replica (and its scheduler
    thread) is constructed."""
    with pytest.raises(ValueError, match="roles has 1"):
        ServingFleet(net, n_replicas=2, roles=("prefill",))
    with pytest.raises(ValueError, match="unknown role"):
        ServingFleet(net, n_replicas=2, roles=("prefill", "bogus"))
    with pytest.raises(ValueError, match="prefill-only"):
        ServingFleet(net, n_replicas=1, roles=("prefill",))


@pytest.mark.parametrize("bs", [8, 16])
def test_disagg_byte_parity_at_block_boundaries(net, offline, bs):
    """The acceptance pin: greedy disagg output == offline
    ``generate()`` at prompts straddling every block_size x chunk
    boundary — one full block + 1 (minimal handoff), just-under-two
    and two-full-blocks (bs=8) — for block_size in {8, 16}.  The
    decode side runs CHUNKED prefill over the handed-off prefix (the
    suffix-only path); the unified reference is the UNCHUNKED offline
    scan; short prompts route direct (below the threshold) and cover
    the unchunked fleet path too."""
    # prompt lengths around the block/chunk boundaries, capped by
    # max_len=32 budget room
    lengths = [bs + 1, 2 * bs, 2 * bs + 1] if bs == 8 else [bs + 1]
    rng = np.random.default_rng(bs)
    prompts = [rng.integers(0, 50, L).astype(np.int32)
               for L in lengths]
    short = rng.integers(0, 50, 3).astype(np.int32)
    p_pre0 = _dispatch_total(0, "prefill")
    h_pre0 = _dispatch_total(1, "handoff")
    with ServingFleet(net, n_replicas=2, roles=("prefill", "decode"),
                      prefill_threshold=bs + 1, n_slots=2, max_len=32,
                      block_size=bs, tick_batch=1,
                      tick_timeout_s=None, **CPU) as fleet:
        # no timing enters the checks: each long prompt is distinct, its
        # blocks reach the decode replica's tier (import_blocks) before
        # its decode admission is submitted, so every admission restores
        # exactly its own full blocks whichever requests batch together
        handles = [fleet.submit_async(p, n_new=4) for p in prompts]
        h_short = fleet.submit_async(short, n_new=4)
        for p, h in zip(prompts, handles):
            assert_stream(offline, h.result(timeout=300),
                          offline_ref(offline, p, 4))
            # the disagg route: staged through the prefill replica,
            # decoded on the decode replica
            assert h.replica == 1
            assert h.prefill_replica == 0
        assert_stream(offline, h_short.result(timeout=300),
                      offline_ref(offline, short, 4))
        assert h_short.replica == 1 and h_short.prefill_replica is None
        st = fleet.stats()
        assert st["replicas"][0]["role"] == "prefill"
        assert st["replicas"][1]["role"] == "decode"
        # the handoff landed: the decode replica RESTORED every full
        # prompt block (one batched copy per admission), it did not
        # re-prefill them
        assert st["replicas"][1]["tier_fetches"] == sum(
            (len(p) - 1) // bs for p in prompts)
        assert st["replicas"][1]["tier_hits"] == len(prompts)
    assert _dispatch_total(0, "prefill") - p_pre0 >= len(prompts)
    assert _dispatch_total(1, "handoff") - h_pre0 >= len(prompts)


def test_warm_decode_replica_skips_prefill_stage(net, offline):
    """A repeat of a handed-off prompt finds the decode replica warm
    (the imported blocks re-registered device-resident) and the
    router classifies it DIRECT — no second prefill stage, no second
    handoff, copy-free admission."""
    p = np.arange(1, 14, dtype=np.int32)     # 13 tokens >= 9 threshold
    ref = offline_ref(offline, p, 6)
    with ServingFleet(net, n_replicas=2, roles=("prefill", "decode"),
                      n_slots=2, max_len=32, block_size=4,
                      tick_batch=1, tick_timeout_s=None, **CPU) as fleet:
        assert_stream(
            offline, fleet.submit(p, n_new=6, timeout=300), ref)
        pre = _dispatch_total(0, "prefill")
        fetches = fleet.replica(1).stats()["tier_fetches"]
        assert_stream(
            offline, fleet.submit(p, n_new=6, timeout=300), ref)
        assert _dispatch_total(0, "prefill") == pre
        st = fleet.replica(1).stats()
        assert st["tier_fetches"] == fetches     # copy-free, no H2D
        assert st["prefix_hits"] >= 2
        # scale-in guard: the last decode-capable replica of a disagg
        # fleet can never be removed (the surviving prefill replica
        # cannot decode) — the constructor invariant holds end to end
        with pytest.raises(ValueError, match="decode-capable"):
            fleet.remove_replica(1)
    assert _outcome_total("handed_off") >= 1


def test_prefill_replica_kill_migrates_and_degrades(net, offline):
    """SIGKILL the only prefill replica with long-prompt requests in
    flight on it: every request re-places through the existing
    migration machinery — reclassified DIRECT against the surviving
    decode replica (no prefill replica left) — and completes
    as offline; the migrated outcome is counted."""
    base = np.arange(1, 10, dtype=np.int32)
    longs = [np.concatenate([base, np.asarray(
        [i + 1, i + 2, i + 3, i + 4], np.int32)]) for i in range(3)]
    refs = [offline_ref(offline, p, 6) for p in longs]
    mig0 = _outcome_total("migrated")
    # the kill races the (fast) prefill stage: on a quick box every
    # request can finish its prefill between the poll and the kill,
    # migrating nothing — retry on a fresh fleet until it lands
    # (byte parity is asserted on EVERY attempt regardless)
    for attempt in range(3):
        with ServingFleet(net, n_replicas=2,
                          roles=("prefill", "decode"), n_slots=2,
                          max_len=32, block_size=4, tick_batch=1,
                          tick_timeout_s=None, **CPU) as fleet:
            hs = [fleet.submit_async(p, n_new=6) for p in longs]
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if any(h.replica == 0 for h in hs):
                    break                # staged on the prefill replica
                if all(h.done() for h in hs):
                    break                # lost the race: retry cheaply
                time.sleep(0.0005)
            fleet.kill(0)
            for h, ref in zip(hs, refs):
                assert_stream(offline, h.result(timeout=300), ref)
            assert fleet.stats()["healthy_replicas"] == 1
            # the fleet keeps serving long prompts WITHOUT a prefill
            # replica: classification degrades to direct decode
            assert_stream(offline, fleet.submit(longs[0], n_new=6,
                                                timeout=300), refs[0])
        if _outcome_total("migrated") - mig0 >= 1:
            break
    assert _outcome_total("migrated") - mig0 >= 1
