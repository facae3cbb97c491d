"""The port's host KV tier and prefix handoff, held to the JAX package's
``tests/test_kv_tiering.py`` case by case (same names, same numpy
inputs, same assertions) at the same tiny Gpt on the CPU.

LRU-evicted prefix blocks SPILL to a host-RAM tier, a later same-prefix
admission restores them with one batched copy, and every spill -> fetch
-> re-spill round trip is byte-stable: the served stream equals the
port's offline ``generate()`` (up to the near-tie rule of the server
tests: torch's CPU matmul rows depend on the batch size).  Beyond the
reference's cases: a CROSS-PACKAGE handoff — a JAX server's
``export_prefix`` payload lands in the port's server through
``import_blocks`` (the same weights, restored from one checkpoint zip)
and the port decodes the handed-off request equal to its own offline
``generate()``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_serving_util import (TINY, assert_stream,  # noqa: E402
                                offline_ref, tiny_net)

from deeplearning4j_torch import telemetry  # noqa: E402
from deeplearning4j_torch.models.generation import (  # noqa: E402
    TransformerGenerator)
from deeplearning4j_torch.parallel import GenerationServer  # noqa: E402
from deeplearning4j_torch.parallel.kv_tiering import HostKVTier  # noqa: E402

CPU = dict(device="cpu", tick_timeout_s=None)


@pytest.fixture(scope="module")
def net():
    return tiny_net()


@pytest.fixture(scope="module")
def offline(net):
    return TransformerGenerator(net, device="cpu")


def test_host_tier_lru_collision_and_capacity():
    """Pure host-side tier semantics: verified get/peek, true-LRU
    capacity eviction (get touches, peek does not), and the collision
    rule — same hash, different token bytes is a MISS."""
    with pytest.raises(ValueError, match="capacity"):
        HostKVTier(0)
    tier = HostKVTier(2)
    k1, v1 = np.full((2, 4), 1.0), np.full((2, 4), -1.0)
    k2, v2 = np.full((2, 4), 2.0), np.full((2, 4), -2.0)
    tier.put(11, b"tok-a", k1, v1)
    tier.put(22, b"tok-b", k2, v2)
    got = tier.get(11, b"tok-a")
    np.testing.assert_array_equal(got[0], k1)
    np.testing.assert_array_equal(got[1], v1)
    assert tier.get(11, b"tok-X") is None
    assert tier.peek(11, b"tok-a") is not None
    tier.put(33, b"tok-c", k1, v1)
    assert len(tier) == 2
    assert tier.get(22, b"tok-b") is None          # true-LRU evicted
    assert tier.peek(11, b"tok-a") is not None
    assert tier.peek(33, b"tok-c") is not None
    tier.put(44, b"tok-d", k2, v2)
    assert tier.peek(11, b"tok-a") is None
    assert tier.peek(33, b"tok-c") is not None
    assert tier.stats()["blocks"] == 2
    assert tier.discard(33) is True and len(tier) == 1


def test_spill_fetch_respill_byte_stable(net, offline):
    """A decodes cold, B's admission EVICTS A's cached blocks (spill),
    A's re-admission FETCHES them back and decodes as offline — three
    cycles, so the spilled bytes survive repeated round trips; the
    allocator is whole at the end."""
    fetches = telemetry.get_registry().counter("kv_tier_fetches_total")
    pa = np.asarray([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9], np.int32)
    pb = np.asarray([2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5, 9], np.int32)
    ref_a = offline_ref(offline, pa, 12)
    ref_b = offline_ref(offline, pb, 12)
    f0 = fetches.value
    with GenerationServer(net, n_slots=2, max_len=32, block_size=4,
                          kv_blocks=8, host_tier_blocks=8, tick_batch=1,
                          **CPU) as srv:
        outs = []
        for _ in range(3):
            outs.append(srv.submit(pa, n_new=12, timeout=300))
            outs.append(srv.submit(pb, n_new=12, timeout=300))
        for i, out in enumerate(outs):
            assert_stream(offline, out, (ref_a, ref_b)[i % 2])
        # a fetched block holds exactly the spilled bytes: the cycles
        # that restore A's blocks from the tier serve it the same tokens
        np.testing.assert_array_equal(outs[4], outs[2])
        st = srv.stats()
        assert st["tier_spills"] >= 2
        assert st["tier_fetches"] >= 1
        assert st["tier_hits"] >= 1
        assert st["host_tier_blocks"] >= 1
        assert (st["free_list_blocks"] + st["evictable_blocks"]
                == st["free_blocks"])
        with srv._lock:
            assert int(srv._block_ref[1:].max(initial=0)) == 0
            assert (len(srv._blocks_free) + len(srv._evictable)
                    == srv.kv_blocks)
    assert fetches.value - f0 >= 1


def test_tier_collision_degrades_to_miss(net, offline):
    """Host-tier entries with the prompt's chain hashes but WRONG token
    bytes (forced collisions) are misses: the admission prefills cold
    and the output equals offline."""
    p = np.arange(1, 14, dtype=np.int32)
    ref = offline_ref(offline, p, 6)
    with GenerationServer(net, n_slots=2, max_len=32, block_size=4,
                          host_tier_blocks=8, tick_batch=1, **CPU) as srv:
        hashes = srv._chain_hashes(p)
        assert len(hashes) == 3
        nl, _, h, bs, dh = srv._kc.shape
        junk = np.full((nl, h, bs, dh), 7.0, np.float32)
        for hsh, _tok in hashes:
            srv._tier.put(hsh, b"not-these-tokens", junk, junk)
        assert_stream(offline, srv.submit(p, n_new=6, timeout=300), ref)
        st = srv.stats()
        assert st["tier_fetches"] == 0 and st["tier_hits"] == 0
        assert st["prefix_misses"] >= 1


def test_export_import_handoff_parity(net, offline):
    """A prefill-only request registers the prompt's full blocks,
    ``export_prefix`` serializes them, ``import_blocks`` lands them on a
    SECOND server whose admission restores them (tier fetch) and decodes
    as offline; a second same-prefix admission there maps the now
    device-resident blocks copy-free."""
    handoff = telemetry.get_registry().counter("kv_handoff_blocks_total")
    p = np.arange(2, 19, dtype=np.int32)     # 17 tokens: 4 full @bs=4
    ref = offline_ref(offline, p, 6)
    h0 = handoff.value
    with GenerationServer(net, n_slots=2, max_len=32, block_size=4,
                          tick_batch=1, **CPU) as src:
        hp = src.prefill_async(p)
        np.testing.assert_array_equal(hp.result(timeout=300), p)
        assert hp.ttft is None and hp.emitted == 0
        payload = src.export_prefix(p)
        assert len(payload) == 4
        assert all(isinstance(k, np.ndarray) and k.shape == (2, 4, 4, 8)
                   for _, _, k, _ in payload)
        st = src.stats()
        assert st["live_slots"] == 0 and st["cached_blocks"] == 4
    with GenerationServer(net, n_slots=2, max_len=32, block_size=4,
                          tick_batch=1, **CPU) as dst:
        assert dst.import_blocks(payload) == 4
        assert dst.prefix_warmth(p) == 4
        first = dst.submit(p, n_new=6, timeout=300)
        assert_stream(offline, first, ref)
        st = dst.stats()
        assert st["tier_fetches"] == 4 and st["tier_hits"] == 1
        np.testing.assert_array_equal(dst.submit(p, n_new=6, timeout=300),
                                      first)
        st = dst.stats()
        assert st["tier_fetches"] == 4       # second hit was copy-free
        assert st["prefix_hits"] == 2
        assert dst.import_blocks(payload) == 0
    assert handoff.value - h0 == 4


def test_host_tier_validation(net):
    with pytest.raises(ValueError, match="host_tier_blocks"):
        GenerationServer(net, n_slots=1, max_len=32, host_tier_blocks=-1,
                         **CPU)
    with pytest.raises(ValueError, match="prefix_cache"):
        GenerationServer(net, n_slots=1, max_len=32, prefix_cache=False,
                         host_tier_blocks=4, **CPU)
    with GenerationServer(net, n_slots=1, max_len=32, prefix_cache=False,
                          **CPU) as srv:
        with pytest.raises(ValueError, match="prefill_async"):
            srv.prefill_async(np.asarray([1, 2, 3], np.int32))


def test_spec_prefill_only_claims_no_draft_blocks(net):
    """A speculative server's prefill-ONLY admission claims no draft
    table and runs no draft prefill."""
    p = np.arange(1, 14, dtype=np.int32)
    with GenerationServer(net, n_slots=2, max_len=32, block_size=4,
                          speculative={"k": 2, "rounds": 1,
                                       "draft_layers": 2}, **CPU) as srv:
        h = srv.prefill_async(p)
        np.testing.assert_array_equal(h.result(timeout=300), p)
        with srv._lock:
            assert int(srv._block_ref[1:].max(initial=0)) == 0
            assert len(srv._evictable) == 3      # target blocks ONLY
            assert (len(srv._blocks_free) + len(srv._evictable)
                    == srv.kv_blocks)
        assert len(srv.export_prefix(p)) == 3


def test_tier_churn_soak(net, offline):
    """Distinct prefixes through a tight pool + small tier: constant
    spill / fetch / tier-LRU churn, every output as offline, allocator
    whole at the end (the reference's soak at half its rounds)."""
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 50, 13).astype(np.int32) for _ in range(4)]
    refs = [offline_ref(offline, p, 12) for p in prompts]
    with GenerationServer(net, n_slots=2, max_len=32, block_size=4,
                          kv_blocks=8, host_tier_blocks=4, tick_batch=1,
                          **CPU) as srv:
        for i in range(8):
            j = i % len(prompts)
            assert_stream(offline, srv.submit(prompts[j], n_new=12,
                                              timeout=300), refs[j])
        with srv._lock:
            assert int(srv._block_ref[1:].max(initial=0)) == 0
            assert (len(srv._blocks_free) + len(srv._evictable)
                    == srv.kv_blocks)
        assert len(srv._tier) <= 4


def test_cross_package_handoff(tmp_path):
    """A JAX server's ``export_prefix`` payload (the reference's format:
    chain hash, token bytes, numpy K/V) lands in the PORT's server: the
    port imports it, restores the blocks on admission (4 tier fetches,
    no prefill of them) and decodes the request equal to its own offline
    ``generate()``.  Both packages serve the same weights: the JAX tiny
    Gpt written to a zip and restored by the port."""
    pytest.importorskip("jax")
    from deeplearning4j_tpu.parallel import (
        GenerationServer as JaxGenerationServer)
    from deeplearning4j_tpu.utils.model_serializer import write_model
    from deeplearning4j_tpu.zoo.gpt import Gpt as JaxGpt

    from deeplearning4j_torch.utils import restore_model
    path = str(tmp_path / "tiny_gpt.zip")
    write_model(JaxGpt(**TINY).init_graph(), path)
    tnet = restore_model(path, device="cpu")
    offline = TransformerGenerator(tnet, device="cpu")
    p = np.arange(2, 19, dtype=np.int32)
    with JaxGenerationServer(restore_model_jax(path), n_slots=2,
                             max_len=32, block_size=4, tick_batch=1,
                             tick_timeout_s=None) as src:
        np.testing.assert_array_equal(src.prefill_async(p).result(
            timeout=300), p)
        payload = src.export_prefix(p)
    assert len(payload) == 4
    with GenerationServer(tnet, n_slots=2, max_len=32, block_size=4,
                          tick_batch=1, **CPU) as dst:
        assert dst.import_blocks(payload) == 4
        out = dst.submit(p, n_new=6, timeout=300)
        st = dst.stats()
        assert st["tier_fetches"] == 4 and st["tier_hits"] == 1
        # the restored K/V are the JAX server's bytes, in the port's pool
        with dst._lock:
            blk = dst._prefix_map[payload[0][0]][0]
            np.testing.assert_array_equal(dst._kc[:, blk].numpy(),
                                          np.asarray(payload[0][2]))
    assert_stream(offline, out, offline_ref(offline, p, 6))


def restore_model_jax(path):
    from deeplearning4j_tpu.utils.model_serializer import restore_model
    return restore_model(path)
