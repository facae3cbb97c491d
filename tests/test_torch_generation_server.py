"""The PyTorch port's GenerationServer (CPU, plain attention path).

Inside the port: greedy outputs through slot scheduling, paged KV, the
prefix cache and fused multi-tick scans equal the port's offline
``generate()`` token for token — staggered admission, EOS, cancel,
prefix hit and miss, block-exhaustion queueing.  Torch's CPU matmuls do
not give a row the same bits at every batch size, so a divergence is
accepted only as a near tie: the teacher-forced logits of the two tokens
at the first divergence within ``NEAR_TIE`` (1e-4) of each other.

Across frameworks: one JAX ``GenerationServer`` and the port's server on
the pangrams checkpoint, and on a tiny Gpt with 2 heads of 256, give
equal greedy tokens."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch import telemetry  # noqa: E402
from deeplearning4j_torch.models.generation import (  # noqa: E402
    TransformerGenerator)
from deeplearning4j_torch.parallel import GenerationServer  # noqa: E402
from deeplearning4j_torch.resilience import (  # noqa: E402
    CancelledError, DeadlineExceededError, RetryableServerError)
from deeplearning4j_torch.utils import load_numpy_params  # noqa: E402
from deeplearning4j_torch.zoo import Gpt  # noqa: E402

TINY = dict(vocab_size=50, max_len=32, d_model=32, n_layers=2, n_heads=4,
            d_ff=64, seq_len=8, compute_dtype=None, seed=3)
NEAR_TIE = 1e-4
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def net():
    return Gpt(**TINY).init_graph(device="cpu")


@pytest.fixture(scope="module")
def offline(net):
    return TransformerGenerator(net, device="cpu")


def _assert_stream(gen, out, ref):
    """``out`` equals ``ref``, or first diverges at a near tie."""
    if out.shape == ref.shape and np.array_equal(out, ref):
        return
    n = min(len(out), len(ref))
    diff = [j for j in range(n) if out[j] != ref[j]]
    assert diff, f"equal for {n} tokens, lengths {len(out)} != {len(ref)}"
    i = diff[0]
    emb, blks, head = gen._serving_params()
    lg = gen._prefill_rows(emb, blks, head,
                           torch.as_tensor(out[None, :i].astype(np.int64)))[0]
    margin = float((lg[0, int(out[i])] - lg[0, int(ref[i])]).abs())
    assert margin <= NEAR_TIE, (i, margin, out, ref)


def _ref(offline, prompt, n_new):
    return offline.generate(prompt[None], n_new=n_new)[0]


def _throttle(srv, seconds):
    """Slow every decode scan down (the tiny model drains its budget in
    milliseconds otherwise) so waiting / cancel states are observable."""
    orig = srv._decode_scan

    def slow(*args, **kwargs):
        time.sleep(seconds)
        return orig(*args, **kwargs)

    srv._decode_scan = slow


def _wait(cond, timeout=60):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.002)


def test_greedy_parity_staggered_mixed_n_new(net, offline):
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 50, t0).astype(np.int32), n_new)
            for t0, n_new in [(3, 6), (4, 4), (5, 9), (7, 3), (6, 12)]]
    with GenerationServer(net, n_slots=2, max_len=32, **CPU) as srv:
        handles = []
        for prompt, n_new in reqs:
            handles.append(srv.submit_async(prompt, n_new))
            time.sleep(0.01)
        outs = [h.result(timeout=120) for h in handles]
    for (prompt, n_new), out in zip(reqs, outs):
        assert out.shape == (len(prompt) + n_new,)
        _assert_stream(offline, out, _ref(offline, prompt, n_new))


@pytest.mark.parametrize("bs,tb", [(8, 1), (8, 8), (16, 1), (16, 8)])
def test_parity_matrix(net, offline, bs, tb):
    """block_size x tick_batch: staggered mixed budgets, an EOS retire
    (mid-scan for tb > 1), a cancel, and a shared-prefix pair whose
    second request rides the prefix-cache HIT path."""
    rng = np.random.default_rng(31 * tb + bs)
    reqs = [(rng.integers(0, 50, t0).astype(np.int32), n_new)
            for t0, n_new in [(3, 12), (5, 7), (4, 10)]]
    shared = rng.integers(0, 50, 17).astype(np.int32)
    ref_shared = _ref(offline, shared, 6)
    eos_prompt = np.asarray([5, 9, 2, 7], np.int32)
    ref_eos = _ref(offline, eos_prompt, 10)
    eos = int(ref_eos[4 + 3])
    first = 4 + int(np.argmax(ref_eos[4:] == eos))
    hits = telemetry.get_registry().counter("prefix_cache_hits_total")
    with GenerationServer(net, n_slots=2, max_len=32, tick_batch=tb,
                          block_size=bs, **CPU) as srv:
        h_seed = srv.submit_async(shared, n_new=6)
        handles = []
        for prompt, n_new in reqs:
            handles.append(srv.submit_async(prompt, n_new))
            time.sleep(0.01)
        h_eos = srv.submit_async(eos_prompt, n_new=10, eos_id=eos)
        h_cancel = srv.submit_async(np.asarray([1, 2, 3], np.int32),
                                    n_new=20)
        assert h_cancel.cancel() is True
        out_seed = h_seed.result(timeout=120)
        h0 = hits.value
        h_hit = srv.submit_async(shared, n_new=6)
        outs = [h.result(timeout=120) for h in handles]
        out_eos = h_eos.result(timeout=120)
        out_hit = h_hit.result(timeout=120)
        with pytest.raises(CancelledError):
            h_cancel.result(timeout=120)
        assert hits.value - h0 == 1
    _assert_stream(offline, out_seed, ref_shared)
    _assert_stream(offline, out_hit, ref_shared)
    for (prompt, n_new), out in zip(reqs, outs):
        _assert_stream(offline, out, _ref(offline, prompt, n_new))
    _assert_stream(offline, out_eos, ref_eos[:first + 1])


def test_max_length_request_does_not_poison_slot(net, offline):
    """A request ending exactly at max_len parks pos == max_len; the idle
    slot must not index the positional table out of range while the other
    slot decodes, and follow-ups reusing it still decode exactly."""
    rng = np.random.default_rng(7)
    p_full = rng.integers(0, 50, 4).astype(np.int32)     # 4 + 28 = 32
    p_long = rng.integers(0, 50, 8).astype(np.int32)     # 8 + 24 = 32
    with GenerationServer(net, n_slots=2, max_len=32, **CPU) as srv:
        h1 = srv.submit_async(p_full, n_new=28)
        h2 = srv.submit_async(p_long, n_new=24)
        _assert_stream(offline, h1.result(timeout=120),
                       _ref(offline, p_full, 28))
        _assert_stream(offline, h2.result(timeout=120),
                       _ref(offline, p_long, 24))
        follow = [rng.integers(0, 50, 5).astype(np.int32)
                  for _ in range(2)]
        hs = [srv.submit_async(p, n_new=8) for p in follow]
        for p, h in zip(follow, hs):
            _assert_stream(offline, h.result(timeout=120),
                           _ref(offline, p, 8))


def test_prefix_reuse_refcounts_and_release(net, offline):
    """The second same-prompt admission maps the cached blocks copy-free;
    retire drains refcounts and parks cached blocks EVICTABLE; a
    cancelled request's blocks drain too."""
    reg = telemetry.get_registry()
    hits = reg.counter("prefix_cache_hits_total")
    misses = reg.counter("prefix_cache_misses_total")
    p = np.arange(1, 14, dtype=np.int32)     # 13 tokens: 3 full blocks
    ref = _ref(offline, p, 6)
    with GenerationServer(net, n_slots=2, max_len=32, block_size=4,
                          **CPU) as srv:
        h0, m0 = hits.value, misses.value
        _assert_stream(offline, srv.submit(p, n_new=6, timeout=120), ref)
        with srv._lock:
            cached = dict(srv._block_hash)
            assert len(cached) == 3              # (13 - 1) // 4
            assert all(srv._block_ref[b] == 0 for b in cached)
            assert set(cached) <= set(srv._evictable)
        _assert_stream(offline, srv.submit(p, n_new=6, timeout=120), ref)
        assert (hits.value - h0, misses.value - m0) == (1, 1)
        st = srv.stats()
        assert (st["prefix_hits"], st["prefix_misses"]) == (1, 1)
        assert st["cached_blocks"] == 3
        _throttle(srv, 0.15)         # 3 scans of 8: a ~0.3 s cancel window
        h = srv.submit_async(np.asarray([7, 8, 9], np.int32), n_new=24)
        _wait(lambda: h.emitted > 0)
        assert h.cancel() is True
        with pytest.raises(CancelledError):
            h.result(timeout=120)
        with srv._lock:
            assert int(srv._block_ref[1:].max(initial=0)) == 0
            assert (len(srv._blocks_free) + len(srv._evictable)
                    == srv.kv_blocks)


def test_lru_eviction_under_a_tight_pool(net, offline):
    """Alternating prefixes through a 6-block pool: admissions evict LRU
    cache entries and every output still matches offline decode."""
    rng = np.random.default_rng(11)
    prefixes = [rng.integers(0, 50, 9).astype(np.int32) for _ in range(2)]
    with GenerationServer(net, n_slots=2, max_len=24, block_size=4,
                          kv_blocks=6, tick_batch=8, **CPU) as srv:
        reqs, handles = [], []
        for i in range(6):
            tail = rng.integers(0, 50, int(rng.integers(1, 4))) \
                .astype(np.int32)
            p = np.concatenate([prefixes[i % 2], tail])
            n_new = int(rng.integers(3, 9))
            reqs.append((p, n_new))
            handles.append(srv.submit_async(p, n_new=n_new))
        for (p, n_new), h in zip(reqs, handles):
            _assert_stream(offline, h.result(timeout=120),
                           _ref(offline, p, n_new))
        with srv._lock:
            assert int(srv._block_ref[1:].max(initial=0)) == 0
            assert (len(srv._blocks_free) + len(srv._evictable)
                    == srv.kv_blocks)


def test_pool_exhaustion_queues_on_blocks(net, offline):
    """BLOCKS, not slots, are the scarce resource: a 4-block pool cannot
    co-run two 3-block requests even with a free slot — the second waits
    unadmitted, then gets the retired blocks and decodes exactly."""
    rng = np.random.default_rng(9)
    reqs = [rng.integers(0, 50, 5).astype(np.int32) for _ in range(2)]
    with GenerationServer(net, n_slots=2, max_len=32, block_size=8,
                          kv_blocks=4, prefix_cache=False, **CPU) as srv:
        _throttle(srv, 0.05)
        hs = [srv.submit_async(p, n_new=12) for p in reqs]

        def waiting():
            with srv._lock:
                return (len(srv._active), len(srv._pending)) == (1, 1) \
                    and hs[0].emitted > 0
        _wait(waiting)
        outs = [h.result(timeout=120) for h in hs]
        with srv._lock:
            assert int(srv._block_ref[1:].max(initial=0)) == 0
            assert sorted(srv._blocks_free) == [1, 2, 3, 4]
    for p, out in zip(reqs, outs):
        _assert_stream(offline, out, _ref(offline, p, 12))


def test_cancel_mid_decode_kills_device_slot(net, offline):
    p_long = np.asarray([1, 2, 3], np.int32)
    p_other = np.asarray([7, 8, 9, 4], np.int32)
    with GenerationServer(net, n_slots=2, max_len=32, tick_batch=4,
                          **CPU) as srv:
        _throttle(srv, 0.05)
        h_long = srv.submit_async(p_long, n_new=28)
        h_other = srv.submit_async(p_other, n_new=12)
        _wait(lambda: h_long.emitted > 0)
        assert h_long.cancel() is True
        with pytest.raises(CancelledError):
            h_long.result(timeout=120)
        _assert_stream(offline, h_other.result(timeout=120),
                       _ref(offline, p_other, 12))

        def killed():
            with srv._lock:
                return int(srv._state["remaining"].max()) == 0
        _wait(killed)


def test_deadlines(net):
    with GenerationServer(net, n_slots=1, max_len=32, **CPU) as srv:
        _throttle(srv, 0.1)          # >= 4 scans of 0.1 s for 29 tokens
        h_busy = srv.submit_async(np.asarray([1, 2], np.int32), n_new=29,
                                  deadline_s=0.25)
        h_queued = srv.submit_async(np.asarray([3, 4], np.int32), n_new=4,
                                    deadline_s=0.05)
        with pytest.raises(DeadlineExceededError):
            h_busy.result(timeout=120)           # expired mid-decode
        with pytest.raises(DeadlineExceededError):
            h_queued.result(timeout=120)         # expired in the queue


def test_sampling_reproducible_batch_invariant_and_in_top_k(net, offline):
    """Per-request sampling rides beside greedy slots; the sampled stream
    is a pure function of the seed (identical at tick_batch 1 and 8, and
    on a fresh server) and every token lies in the row's top-k set."""
    pg = np.asarray([4, 5, 6], np.int32)
    ps = np.asarray([1, 2, 3], np.int32)
    samp = {"temperature": 1.0, "top_k": 5, "seed": 11}
    outs = {}
    for tb in (1, 8):
        with GenerationServer(net, n_slots=2, max_len=32, tick_batch=tb,
                              **CPU) as srv:
            hg = srv.submit_async(pg, n_new=8)
            hs = srv.submit_async(ps, n_new=8, sampling=samp)
            _assert_stream(offline, hg.result(timeout=120),
                           _ref(offline, pg, 8))
            outs[tb] = hs.result(timeout=120)
    np.testing.assert_array_equal(outs[1], outs[8])
    out = outs[1]
    np.testing.assert_array_equal(out[:3], ps)
    emb, blks, head = offline._serving_params()
    for i in range(3, len(out)):
        lg = offline._prefill_rows(emb, blks, head,
                                   torch.as_tensor(out[None, :i]))[0]
        assert int(out[i]) in set(torch.topk(lg[0], 5).indices.tolist())
    with GenerationServer(net, n_slots=2, max_len=32, **CPU) as srv:
        other = srv.submit(ps, n_new=8, sampling=dict(samp, seed=12))
        same = srv.submit(ps, n_new=8, sampling=samp)
    np.testing.assert_array_equal(same, out)
    assert other.shape == out.shape


def test_host_syncs_amortized_by_scan(net):
    """A solo K=8 request polls the host once per scan: 16 new tokens
    cost exactly 2 device->host syncs."""
    reg = telemetry.get_registry()
    syncs = reg.counter("generation_server_host_syncs_total")
    ticks = reg.counter("generation_server_ticks_total")
    with GenerationServer(net, n_slots=1, max_len=32, tick_batch=8,
                          **CPU) as srv:
        s0, t0 = syncs.value, ticks.value
        out = srv.submit(np.asarray([1, 2, 3], np.int32), n_new=16,
                         timeout=120)
    assert out.shape == (19,)
    assert syncs.value - s0 == 2
    assert ticks.value - t0 == 16


def test_validation(net):
    with pytest.raises(ValueError, match="top_k"):
        GenerationServer(net, n_slots=1, temperature=1.0, top_k=0, **CPU)
    with pytest.raises(ValueError, match="temperature"):
        GenerationServer(net, n_slots=1, top_k=5, **CPU)
    with pytest.raises(ValueError, match="positional"):
        GenerationServer(net, n_slots=1, max_len=64, **CPU)
    with pytest.raises(ValueError, match="kv_blocks"):
        GenerationServer(net, n_slots=1, max_len=32, block_size=8,
                         kv_blocks=2, **CPU)
    with pytest.raises(ValueError, match="tick_batch"):
        GenerationServer(net, n_slots=1, tick_batch=0, **CPU)
    with GenerationServer(net, n_slots=1, max_len=32, **CPU) as srv:
        p = np.asarray([1, 2, 3], np.int32)
        with pytest.raises(ValueError, match="slot cache length"):
            srv.submit(np.zeros(30, np.int32), n_new=10)
        with pytest.raises(ValueError, match="n_new"):
            srv.submit(p, n_new=0)
        with pytest.raises(ValueError, match="1-D"):
            srv.submit(np.zeros((2, 4), np.int32), n_new=2)
        with pytest.raises(ValueError, match="unknown sampling"):
            srv.submit(p, n_new=2, sampling={"nope": 1})
        with pytest.raises(ValueError, match="top_k"):
            srv.submit(p, n_new=2, sampling={"temperature": 1.0,
                                             "top_k": 99})


@pytest.mark.parametrize("kwargs", [
    {"devices": ["cpu"]}, {"tp": 2},
    {"host_tier_blocks": 4}, {"tick_timeout_s": 30.0}])
def test_left_out_features_raise(net, kwargs):
    """Every one of these features is ported now and constructs a working
    server: a one-device slice (``devices=``) pins the replica at tp 1,
    ``tp=`` without a slice is ignored as in the reference (the sharded
    tick is held in ``test_torch_serving_mesh.py``), and the host KV tier
    and the watchdog are held in ``test_torch_kv_tiering.py`` and
    ``test_torch_resilience.py``."""
    if "devices" in kwargs or "tp" in kwargs:
        with GenerationServer(net, n_slots=1, max_len=32, **CPU,
                              **kwargs) as srv:
            st = srv.stats()
            assert st["healthy"] and st["tp"] == 1
            assert st["devices"] == ["cpu:0"]
            assert srv.submit(np.asarray([1, 2, 3], np.int32),
                              n_new=2).shape == (5,)
        return
    with GenerationServer(net, n_slots=1, max_len=32, **CPU,
                          **kwargs) as srv:
        st = srv.stats()
        assert st["healthy"] and st["host_tier_blocks"] == 0
        assert srv.tick_timeout_s == 30.0
        assert srv.submit(np.asarray([1, 2, 3], np.int32), n_new=2).shape \
            == (5,)


def test_left_out_handoff_methods_raise(net):
    """The handoff methods are ported: on a cold server an export finds
    no cached block and an empty import lands nothing."""
    with GenerationServer(net, n_slots=1, max_len=32, **CPU) as srv:
        assert srv.export_prefix(np.asarray([1, 2, 3], np.int32)) == []
        assert srv.import_blocks([]) == 0


def test_stats_drain_and_shutdown_drain(net, offline):
    p = np.arange(1, 14, dtype=np.int32)
    srv = GenerationServer(net, n_slots=2, max_len=32, block_size=4,
                           tick_batch=1, **CPU)
    st = srv.stats()
    assert st["healthy"] and not st["draining"]
    assert (st["live_slots"], st["free_slots"], st["queue_depth"]) == \
        (0, 2, 0)
    assert st["free_blocks"] == srv.kv_blocks
    h = srv.submit_async(p, n_new=6)
    srv.drain()
    with pytest.raises(RuntimeError, match="draining"):
        srv.submit(p, n_new=2)
    _assert_stream(offline, h.result(timeout=120), _ref(offline, p, 6))
    assert srv.stats()["draining"] and srv.healthy()
    srv2 = GenerationServer(net, n_slots=1, max_len=32, **CPU)
    _throttle(srv2, 0.02)
    hs = [srv2.submit_async(p, n_new=4) for _ in range(2)]
    srv2.shutdown(drain=True)
    for h in hs:
        _assert_stream(offline, h.result(timeout=1), _ref(offline, p, 4))
    with pytest.raises(RuntimeError, match="shut down"):
        srv2.submit(p, n_new=2)
    srv.shutdown()
    assert not srv.healthy()


def test_failed_dispatch_fails_in_flight_then_serves(net, offline):
    """Block-granular recovery: a decode dispatch that raises implicates
    no slot, so the in-flight request is salvaged and completes equal to
    offline; an ADMISSION that raises fails its own request with a typed
    RetryableServerError, and the server keeps serving —
    ``submit(retries=1)`` rides through one such failure."""
    p = np.asarray([3, 1, 4, 1, 5], np.int32)
    with GenerationServer(net, n_slots=2, max_len=32, **CPU) as srv:
        for name in ("_decode_scan", "_admit_fn"):
            orig = getattr(srv, name)
            fails = [2]

            def flaky(*args, _orig=orig, _fails=fails, **kwargs):
                if _fails[0]:
                    _fails[0] -= 1
                    raise RuntimeError("injected dispatch failure")
                return _orig(*args, **kwargs)

            setattr(srv, name, flaky)
            if name == "_decode_scan":
                out = srv.submit(p, n_new=5, timeout=120)
            else:
                with pytest.raises(RetryableServerError):
                    srv.submit(p, n_new=5, timeout=120)
                out = srv.submit(p, n_new=5, timeout=120, retries=1)
            assert fails == [0]
            setattr(srv, name, orig)
            _assert_stream(offline, out, _ref(offline, p, 5))
            assert srv.stats()["free_blocks"] == srv.kv_blocks


def test_slice_matches_jax_server():
    """The slice as a whole: the JAX package's GenerationServer and the
    port's, both on the pangrams checkpoint, give equal greedy tokens."""
    jax = pytest.importorskip("jax")  # noqa: F841
    from deeplearning4j_tpu.parallel import (
        GenerationServer as JaxGenerationServer)
    from deeplearning4j_tpu.utils.model_serializer import (
        restore_model as jax_restore)

    from deeplearning4j_torch.utils import restore_model
    path = "deeplearning4j_tpu/zoo/weights/Gpt_pangrams-char.zip"
    rng = np.random.default_rng(13)
    shared = rng.integers(0, 28, 9).astype(np.int32)
    prompts = [np.concatenate([shared, [1, 2]]).astype(np.int32),
               np.concatenate([shared, [4]]).astype(np.int32)] + [
        rng.integers(0, 28, int(t)).astype(np.int32) for t in (3, 7)]
    outs = {}
    for name, srv in (
            ("jax", JaxGenerationServer(jax_restore(path), n_slots=2,
                                        block_size=8, tick_batch=1,
                                        tick_timeout_s=None)),
            ("torch", GenerationServer(restore_model(path, device="cpu"),
                                       n_slots=2, block_size=8,
                                       tick_batch=1, device="cpu"))):
        with srv:
            first = srv.submit(prompts[0], n_new=12, timeout=300)
            hs = [srv.submit_async(p, n_new=12) for p in prompts[1:]]
            outs[name] = [first] + [h.result(timeout=300) for h in hs]
    for a, b in zip(outs["jax"], outs["torch"]):
        np.testing.assert_array_equal(b, a)


# tiny Gpts at the head widths of zoo.Gpt(n_heads=3) and Gpt(n_heads=2):
# 2 heads of 256 (d 512) and 2 of 384 (d 768)
WIDE_HEADS = dict(vocab_size=50, max_len=64, d_model=512, n_layers=2,
                  n_heads=2, d_ff=256, seq_len=16, compute_dtype=None,
                  seed=5)


@pytest.mark.parametrize("d_model", [512, 768])
def test_wide_heads_server_matches_jax_server(d_model):
    """Greedy streams of the JAX package's GenerationServer and the
    port's on one tiny Gpt with 2 heads of 256 or 384 (vocab 50, d 512 or
    768, 2 layers, ff 256; the widths whose bf16 paged reads run the wide
    builds of K1 and K2 on the card), the JAX parameters carried into the
    port with ``load_numpy_params``, are equal (a shared prefix, so the
    second request takes the prefix-cache path)."""
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.parallel import (
        GenerationServer as JaxGenerationServer)
    from deeplearning4j_tpu.zoo.gpt import Gpt as JaxGpt

    cfg = {**WIDE_HEADS, "d_model": d_model}
    jnet = JaxGpt(**cfg).init_graph()
    params = jax.tree_util.tree_map(np.asarray, jnet.params_tree)
    pnet = load_numpy_params(Gpt(**cfg).init_graph(device="cpu"),
                             params, device="cpu")
    rng = np.random.default_rng(17)
    shared = rng.integers(0, 50, 9).astype(np.int32)
    prompts = [np.concatenate([shared, [1, 2]]).astype(np.int32),
               np.concatenate([shared, [4]]).astype(np.int32)]
    outs = {}
    for name, srv in (
            ("jax", JaxGenerationServer(jnet, n_slots=2, block_size=8,
                                        tick_batch=1, tick_timeout_s=None)),
            ("torch", GenerationServer(pnet, n_slots=2, block_size=8,
                                       tick_batch=1, device="cpu"))):
        with srv:
            outs[name] = [srv.submit(p, n_new=8, timeout=300)
                          for p in prompts]
    for a, b in zip(outs["jax"], outs["torch"]):
        np.testing.assert_array_equal(b, a)
