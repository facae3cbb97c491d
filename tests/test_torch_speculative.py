"""Speculative decode in the PyTorch port: the verify pass, the greedy
acceptance rule, and the server's speculative path.

Against the JAX package, on the same numpy-seeded inputs: the port's
``_verify_rows_paged`` (logits and pool writes, 1e-5 — the same f32 ops
on two backends), ``accept_greedy`` (exactly), and one cross-framework
serve — the JAX and the port's speculative servers give equal greedy
tokens on the tiny Gpt.

Inside the port: the verify pass against W sequential ``_step_paged``
ticks (allclose 1e-5, not bytes — torch's CPU matmul rows are not
batch-invariant, ROADMAP Queue 3), and speculative greedy serving against
offline ``generate()`` under the near-tie rule of
``test_torch_generation_server._assert_stream`` at every acceptance
pattern: a full-depth self-draft (acceptance >= 0.9 — an ulp may flip a
near tie, so not exactly 1.0), an external seeded draft, EOS inside an
accepted run, prefix hits (the draft-domain hit skips the draft's full
prefill), a mixed greedy + sampled pool, and draft-block exhaustion."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models.generation import (  # noqa: E402
    TransformerGenerator as JaxGenerator)
from deeplearning4j_tpu.parallel import (  # noqa: E402
    GenerationServer as JaxGenerationServer)
from deeplearning4j_tpu.parallel.speculative import (  # noqa: E402
    accept_greedy as jax_accept_greedy)
from deeplearning4j_tpu.zoo.gpt import Gpt as JaxGpt  # noqa: E402

from deeplearning4j_torch import telemetry  # noqa: E402
from deeplearning4j_torch.models.generation import (  # noqa: E402
    TransformerGenerator)
from deeplearning4j_torch.models.multi_layer_network import (  # noqa: E402
    MultiLayerNetwork)
from deeplearning4j_torch.nn.conf.builder import (  # noqa: E402
    MultiLayerConfiguration)
from deeplearning4j_torch.parallel import GenerationServer  # noqa: E402
from deeplearning4j_torch.parallel.speculative import (  # noqa: E402
    accept_greedy)
from deeplearning4j_torch.utils import load_numpy_params  # noqa: E402
from deeplearning4j_torch.zoo import Gpt  # noqa: E402

TINY = dict(vocab_size=50, max_len=32, d_model=32, n_layers=2, n_heads=4,
            d_ff=64, seq_len=8, compute_dtype=None, seed=3)
NEAR_TIE = 1e-4
CPU = dict(device="cpu")


def _carry(jnet):
    """The port's copy of a JAX net (params carried over as numpy)."""
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()))
    return load_numpy_params(
        pnet, jax.tree_util.tree_map(np.asarray, jnet.params_tree),
        device="cpu")


@pytest.fixture(scope="module")
def nets():
    """(JAX tiny Gpt, the port's copy of it)."""
    jnet = JaxGpt(**TINY).init_graph()
    return jnet, _carry(jnet)


@pytest.fixture(scope="module")
def net(nets):
    return nets[1]


@pytest.fixture(scope="module")
def offline(net):
    return TransformerGenerator(net, **CPU)


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
    """Slow every speculative dispatch down so waiting states are
    observable (the tiny model drains its budget in milliseconds)."""
    orig = srv._spec_rounds

    def slow(*args, **kwargs):
        time.sleep(seconds)
        return orig(*args, **kwargs)

    srv._spec_rounds = slow


def _wait(cond, timeout=60):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.002)


def _drained(srv):
    """Every block back: refcounts 0, free + evictable == the pool."""
    with srv._lock:
        assert int(srv._block_ref[1:].max(initial=0)) == 0
        assert len(srv._blocks_free) + len(srv._evictable) == srv.kv_blocks


# -- the verify pass ----------------------------------------------------
def _verify_inputs(seed=0, W=3):
    """Random pools, shuffled tables and a chunk per slot; slot 2's budget
    (2) is below W, so its last row is masked to the scratch block 0."""
    rng = np.random.default_rng(seed)
    B, h, dh, bs, mb, nl = 3, 4, 8, 4, 4, 2
    nb = 1 + B * mb
    kc = rng.normal(size=(nl, nb, h, bs, dh)).astype(np.float32)
    vc = rng.normal(size=(nl, nb, h, bs, dh)).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, nb))[:mb]
                      for _ in range(B)]).astype(np.int32)
    pos0 = np.asarray([0, 6, 12], np.int32)
    budget = np.asarray([W, W, 2])
    toks = rng.integers(0, 50, (B, W)).astype(np.int32)
    ok = np.arange(W)[None, :] < budget[:, None]
    p = pos0[:, None] + np.arange(W)[None, :]
    epos = np.where(ok, p, 0).astype(np.int32)
    wblk = np.where(ok, np.take_along_axis(table, np.where(ok, p // bs, 0),
                                           axis=1), 0).astype(np.int32)
    woff = np.where(ok, p % bs, 0).astype(np.int32)
    return kc, vc, np.where(ok, toks, 0).astype(np.int32), pos0, epos, \
        table, wblk, woff


def test_verify_rows_matches_jax(nets):
    """One W-token verify pass on the same pool, tables and chunk: logits
    at every chunk row and the written pool rows agree (1e-5; block 0, the
    scratch sink that masked rows write in no set order, excluded)."""
    jnet, pnet = nets
    kc, vc, toks, pos0, epos, table, wblk, woff = _verify_inputs()
    jg = JaxGenerator(jnet)
    emb, blks, head = jg._params()
    jl, jkc, jvc = jg._verify_rows_paged(
        emb, jg._stack_blocks(blks), head, jnp.asarray(kc), jnp.asarray(vc),
        *[jnp.asarray(a) for a in (toks, pos0, epos, table, wblk, woff)])
    pg = TransformerGenerator(pnet, **CPU)
    t = torch.from_numpy
    pl, pkc, pvc = pg._verify_rows_paged(
        *pg._serving_params(), t(kc.copy()), t(vc.copy()),
        *[t(a) for a in (toks, pos0, epos, table, wblk, woff)])
    assert tuple(pl.shape) == (3, 3, 50)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pkc.numpy()[:, 1:], np.asarray(jkc)[:, 1:],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(pvc.numpy()[:, 1:], np.asarray(jvc)[:, 1:],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("W", [1, 4])
def test_verify_rows_match_sequential_steps(offline, W):
    """The W-token verify pass against W sequential decode ticks over the
    same greedy tokens: logits and pools allclose 1e-5."""
    gen = offline
    rng = np.random.default_rng(W)
    B, h, dh, bs, mb, nl = 2, 4, 8, 4, 8, 2
    nb = 1 + B * mb
    kc = torch.from_numpy(
        rng.normal(size=(nl, nb, h, bs, dh)).astype(np.float32))
    vc = kc.flip(0).clone()
    table = torch.arange(1, nb, dtype=torch.int32).reshape(B, mb)
    params = gen._serving_params()
    lg = torch.from_numpy(rng.normal(size=(B, 50)).astype(np.float32))
    pos0 = torch.tensor([5, 3], dtype=torch.int32)
    kcA, vcA, posA = kc.clone(), vc.clone(), pos0.clone()
    toks, logitsA = [], []
    for _ in range(W):
        tok = torch.argmax(lg, -1)
        toks.append(tok)
        wblk = table.gather(1, (posA // bs).long()[:, None])[:, 0]
        lg, _, _ = gen._step_paged(*params, kcA, vcA, tok, posA, table,
                                   wblk, posA % bs)
        logitsA.append(lg)
        posA = posA + 1
    p = pos0[:, None] + torch.arange(W, dtype=torch.int32)[None, :]
    wblk = table.gather(1, (p // bs).long())
    logitsB, kcB, vcB = gen._verify_rows_paged(
        *params, kc.clone(), vc.clone(), torch.stack(toks, 1), pos0, p,
        table, wblk, p % bs)
    torch.testing.assert_close(logitsB, torch.stack(logitsA, 1),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(kcB, kcA, atol=1e-5, rtol=0)
    torch.testing.assert_close(vcB, vcA, atol=1e-5, rtol=0)


# -- the greedy acceptance rule -----------------------------------------
def _accept_both(v, g, rem, eos=None, active=None, kcap=None):
    """(port, JAX) results of accept_greedy on the same numpy inputs."""
    B = len(v)
    eos = np.full((B,), -1, np.int32) if eos is None else np.asarray(eos)
    active = np.ones((B,), bool) if active is None else np.asarray(active)
    args = [np.asarray(v, np.int32), np.asarray(g, np.int32),
            active, np.asarray(rem, np.int32), eos.astype(np.int32)]
    kc = None if kcap is None else np.asarray(kcap, np.int32)
    port = accept_greedy(*[torch.from_numpy(a) for a in args],
                         kcap=None if kc is None else torch.from_numpy(kc))
    jx = jax_accept_greedy(*[jnp.asarray(a) for a in args],
                           kcap=None if kc is None else jnp.asarray(kc))
    return [t.numpy() for t in port], [np.asarray(t) for t in jx]


def test_accept_greedy_hand_cases_match_jax():
    """The hand cases of the JAX suite's greedy-rule test, through both
    packages."""
    cases = [
        (([[7, 1, 2, 3]], [[1, 2, 3, 9]], [10]), {}, (4, 6)),
        (([[7, 5, 2, 3]], [[1, 2, 3, 9]], [10]), {}, (1, 9)),
        (([[7, 1, 2, 8]], [[1, 2, 3, 9]], [10]), {}, (3, 7)),
        (([[7, 5, 3, 9]], [[1, 2, 3, 9]], [10]), {}, (1, 9)),
        (([[7, 1, 2, 3]], [[1, 2, 3, 9]], [2]), {}, (2, 0)),
        (([[7, 1, 2, 3]], [[1, 2, 3, 9]], [10]), {"eos": [2]}, (3, 0)),
        (([[7, 1, 2, 3]], [[1, 2, 3, 9]], [10]), {"eos": [7]}, (1, 0)),
        (([[7, 1, 8, 3]], [[1, 2, 3, 9]], [10]), {"eos": [3]}, (2, 8)),
        (([[7, 1, 2, 3]], [[1, 2, 3, 9]], [0]), {"active": [False]},
         (0, 0)),
        (([[7, 1, 2, 3]], [[1, 2, 3, 9]], [10]), {"kcap": [2]}, (3, 7)),
    ]
    for args, kw, (c, r) in cases:
        port, jx = _accept_both(*args, **kw)
        assert (int(port[0][0]), int(port[1][0])) == (c, r), (args, kw)
        for a, b in zip(port, jx):
            np.testing.assert_array_equal(a, b)


def test_accept_greedy_random_sweep_matches_jax():
    """A seeded sweep of 256 rows per width (one shape per call keeps the
    JAX side to one compile each)."""
    rng = np.random.default_rng(0)
    B = 256
    for W in (2, 5):
        g = rng.integers(0, 4, (B, W))
        v = np.where(rng.random((B, W)) < 0.7, np.roll(g, 1, axis=1),
                     rng.integers(0, 4, (B, W)))
        port, jx = _accept_both(
            v, g, rng.integers(0, 8, B),
            eos=np.where(rng.random(B) < 0.5, rng.integers(0, 4, B), -1),
            active=rng.random(B) < 0.8, kcap=rng.integers(0, W, B))
        for a, b in zip(port, jx):
            np.testing.assert_array_equal(a, b)


# -- the server ---------------------------------------------------------
def test_spec_full_depth_self_draft(net, offline):
    """A full-depth self-draft proposes what the target decides; every
    stream matches offline decode, and acceptance stays >= 0.9 (the draft
    steps and the flat verify rows sum in other orders, so an ulp may
    flip a near tie)."""
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, 50, t0).astype(np.int32), n_new)
            for t0, n_new in [(3, 12), (5, 7), (4, 10)]]
    reg = telemetry.get_registry()
    syncs = reg.counter("generation_server_host_syncs_total")
    with GenerationServer(net, n_slots=2, max_len=32,
                          speculative={"k": 3, "rounds": 2,
                                       "draft_layers": 2}, **CPU) as srv:
        hs = [srv.submit_async(p, n) for p, n in reqs]
        outs = [h.result(timeout=120) for h in hs]
        st = srv.stats()
        s0 = syncs.value
        solo = srv.submit(reqs[0][0], 12, timeout=120)
        n_syncs = syncs.value - s0
    for (p, n), out in zip(reqs, outs):
        assert out.shape == (len(p) + n,)
        _assert_stream(offline, out, _ref(offline, p, n))
    _assert_stream(offline, solo, _ref(offline, reqs[0][0], 12))
    assert st["spec_k"] == 3 and st["spec_proposed"] > 0
    assert st["spec_acceptance_rate"] >= 0.9
    # 12 tokens at up to 4 per round and 2 rounds per dispatch: a solo
    # request needs at least 2 dispatches, one host sync each
    assert 2 <= n_syncs <= 6
    _drained(srv)


def test_spec_external_seeded_draft(nets, offline):
    """An independently seeded draft disagrees with the target almost
    everywhere; rounds commit ~the anchor, streams still match."""
    draft = _carry(JaxGpt(**dict(TINY, seed=17)).init_graph())
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, 50, t0).astype(np.int32), n_new)
            for t0, n_new in [(4, 9), (6, 6)]]
    with GenerationServer(nets[1], n_slots=2, max_len=32,
                          speculative={"k": 3, "draft_net": draft},
                          **CPU) as srv:
        outs = [srv.submit(p, n, timeout=120) for p, n in reqs]
        st = srv.stats()
    for (p, n), out in zip(reqs, outs):
        _assert_stream(offline, out, _ref(offline, p, n))
    assert st["spec_proposed"] > 0
    assert st["spec_acceptance_rate"] < 0.9


def test_spec_eos_inside_accepted_run(net, offline):
    """EOS committed inside an accepted draft run cuts it there, EOS
    included, as the plain tick does."""
    p = np.asarray([5, 9, 2, 7], np.int32)
    ref = _ref(offline, p, 12)
    eos = int(ref[4 + 5])
    first = 4 + int(np.argmax(ref[4:] == eos))
    with GenerationServer(net, n_slots=2, max_len=32,
                          speculative={"k": 4, "rounds": 1,
                                       "draft_layers": 2}, **CPU) as srv:
        out = srv.submit(p, 12, eos_id=eos, timeout=120)
    _assert_stream(offline, out, ref[:first + 1])


def test_spec_prefix_hits_skip_the_draft_prefill(net, offline):
    """The second same-prompt admission maps the cached target AND draft
    blocks: only suffix prefills run (target and draft), no full-prompt
    prefill.  After retire both domains' blocks sit evictable."""
    p = np.arange(1, 14, dtype=np.int32)       # 13 tokens: 3 full blocks
    ref = _ref(offline, p, 6)
    calls = []
    with GenerationServer(net, n_slots=2, max_len=32, block_size=4,
                          speculative={"k": 2, "draft_layers": 1},
                          **CPU) as srv:
        for name in ("_prefill_full", "_prefill_suffix"):
            orig = getattr(srv, name)

            def spy(*args, _orig=orig, _name=name, **kw):
                calls.append((_name, args[1] is srv._params))
                return _orig(*args, **kw)
            setattr(srv, name, spy)
        _assert_stream(offline, srv.submit(p, 6, timeout=120), ref)
        assert calls == [("_prefill_full", True), ("_prefill_full", False)]
        with srv._lock:
            assert len(srv._prefix_map) == len(srv._dprefix_map) == 3
            assert len(srv._draft_cached) == 3
        del calls[:]
        _assert_stream(offline, srv.submit(p, 6, timeout=120), ref)
        assert calls == [("_prefill_suffix", True),
                         ("_prefill_suffix", False)]
        st = srv.stats()
        assert (st["prefix_hits"], st["prefix_misses"]) == (1, 1)
        assert st["cached_blocks"] == 6
    _drained(srv)


def test_spec_mixed_pool_keeps_greedy_rows(net, offline):
    """Greedy and sampled requests in one speculative pool: the greedy
    rows match offline decode, the sampled ones finish their budgets."""
    rng = np.random.default_rng(5)
    greedy = [rng.integers(0, 50, t).astype(np.int32) for t in (4, 7)]
    sampled = [rng.integers(0, 50, t).astype(np.int32) for t in (3, 6)]
    with GenerationServer(net, n_slots=4, max_len=32,
                          speculative={"k": 3, "draft_layers": 1},
                          **CPU) as srv:
        hg = [srv.submit_async(p, 10) for p in greedy]
        hs = [srv.submit_async(p, 9, sampling={"temperature": 0.9,
                                               "top_k": 8, "seed": i})
              for i, p in enumerate(sampled)]
        outs_g = [h.result(timeout=120) for h in hg]
        outs_s = [h.result(timeout=120) for h in hs]
    for p, out in zip(greedy, outs_g):
        _assert_stream(offline, out, _ref(offline, p, 10))
    for p, out in zip(sampled, outs_s):
        assert out.shape == (len(p) + 9,)
        np.testing.assert_array_equal(out[:len(p)], p)
    _drained(srv)


def test_spec_draft_block_exhaustion_queues(net, offline):
    """A speculative admission claims target AND draft blocks: an 8-block
    pool holds one 3+3-block request, so the second waits with a slot
    free, then decodes exactly on the released blocks."""
    rng = np.random.default_rng(9)
    reqs = [rng.integers(0, 50, 5).astype(np.int32) for _ in range(2)]
    with GenerationServer(net, n_slots=2, max_len=32, block_size=8,
                          kv_blocks=8, prefix_cache=False,
                          speculative={"k": 2, "rounds": 1,
                                       "draft_layers": 1}, **CPU) as srv:
        _throttle(srv, 0.05)
        hs = [srv.submit_async(p, n_new=12) for p in reqs]

        def waiting():
            with srv._lock:
                return (len(srv._active), len(srv._pending)) == (1, 1) \
                    and hs[0].emitted > 0
        _wait(waiting)
        outs = [h.result(timeout=120) for h in hs]
        with srv._lock:
            assert sorted(srv._blocks_free) == list(range(1, 9))
    for p, out in zip(reqs, outs):
        _assert_stream(offline, out, _ref(offline, p, 12))
    _drained(srv)


def test_spec_switches_and_cap(net, offline):
    """``set_spec_enabled(False)`` serves plain ticks (no proposals),
    ``set_draft_k_cap`` clamps the dispatch depth, and both streams still
    match offline decode."""
    p = np.asarray([3, 1, 4, 1, 5], np.int32)
    ref = _ref(offline, p, 9)
    depth = telemetry.get_registry().gauge(
        "generation_server_spec_adaptive_k")
    with GenerationServer(net, n_slots=1, max_len=32,
                          speculative={"k": 3, "draft_layers": 1},
                          **CPU) as srv:
        srv.set_spec_enabled(False)
        _assert_stream(offline, srv.submit(p, 9, timeout=120), ref)
        assert srv.stats()["spec_proposed"] == 0
        srv.set_spec_enabled(True)
        srv.set_draft_k_cap(1)
        _assert_stream(offline, srv.submit(p, 9, timeout=120), ref)
        st = srv.stats()
        assert st["spec_k_cap"] == 1 and depth.value == 1
        assert 0 < st["spec_proposed"] <= 8
        srv.set_draft_k_cap(None)
        assert srv.stats()["spec_k_cap"] is None


def test_spec_validation(net):
    def make(spec, **kw):
        GenerationServer(net, n_slots=1, max_len=32, speculative=spec,
                         **CPU, **kw).shutdown()

    with pytest.raises(ValueError, match="unknown speculative"):
        make({"k": 2, "depth": 3})
    with pytest.raises(ValueError, match="k must be"):
        make({"k": 0})
    with pytest.raises(ValueError, match="rounds must be"):
        make({"k": 2, "rounds": 0})
    with pytest.raises(ValueError, match="k_max"):
        make({"k": 3, "k_max": 2})
    with pytest.raises(ValueError, match="draft_layers"):
        make({"draft_layers": 3})
    with pytest.raises(ValueError, match="draft table"):
        make({"k": 2}, block_size=8, kv_blocks=4)
    big = Gpt(**dict(TINY, n_layers=3)).init_graph(**CPU)
    with pytest.raises(ValueError, match="draft_layers applies"):
        make({"draft_net": big, "draft_layers": 1})
    for kw, msg in ((dict(n_layers=3), "depth"),
                    (dict(n_heads=2), "n_heads"),
                    (dict(d_model=16, n_heads=4), "d_model"),
                    (dict(vocab_size=40), "vocab")):
        draft = Gpt(**dict(TINY, **kw)).init_graph(**CPU)
        with pytest.raises(ValueError, match=msg):
            make({"draft_net": draft})


def test_spec_matches_jax_server(nets):
    """The slice as a whole: the JAX package's speculative server and the
    port's, both ``speculative={"k": 2, "draft_layers": 1}`` on the tiny
    Gpt, give equal greedy tokens."""
    jnet, pnet = nets
    rng = np.random.default_rng(13)
    shared = rng.integers(0, 50, 9).astype(np.int32)
    prompts = [np.concatenate([shared, [1, 2]]).astype(np.int32),
               np.concatenate([shared, [4]]).astype(np.int32)] + [
        rng.integers(0, 50, int(t)).astype(np.int32) for t in (3, 7)]
    spec = {"k": 2, "draft_layers": 1}
    outs = {}
    for name, srv in (
            ("jax", JaxGenerationServer(jnet, n_slots=2, block_size=8,
                                        speculative=spec,
                                        tick_timeout_s=None)),
            ("torch", GenerationServer(pnet, n_slots=2, block_size=8,
                                       speculative=spec, **CPU))):
        with srv:
            first = srv.submit(prompts[0], n_new=12, timeout=300)
            hs = [srv.submit_async(p, n_new=12) for p in prompts[1:]]
            outs[name] = [first] + [h.result(timeout=300) for h in hs]
            assert srv.stats()["prefix_hits"] >= 1
    for a, b in zip(outs["jax"], outs["torch"]):
        np.testing.assert_array_equal(b, a)
