"""Sampled speculative decode in the PyTorch port: rejection-sampling
acceptance, the residual, the acceptance controller, and the sampled
stream's law.

Against the JAX package on the same numpy inputs (the uniforms
included): ``accept_sampled`` / ``accept_mixed`` exactly, over the hand
cases of ``tests/test_spec_sampling.py`` and a seeded sweep;
``residual_logits`` and ``_filtered_logprobs_rows`` allclose 1e-6; the
``AcceptanceController`` makes the same decisions on the same
observations (a stub history store).

The port draws with counter hashes, not threefry, so the served stream is
held to its LAW: on a tiny-vocab Gpt with an external draft far from the
target, the second token's marginal over many seeds lies within TV 0.05
of the exact marginal of direct sampling (computed from the target's own
prefill logits), while the draft's proposals alone sit > 0.15 away.
Sampled speculative output is reproducible per seed and the same for any
``rounds``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models.generation import (  # noqa: E402
    _filtered_logprobs_rows as jax_filtered_logprobs)
from deeplearning4j_tpu.parallel import speculative as jspec  # noqa: E402

from deeplearning4j_torch import telemetry  # noqa: E402
from deeplearning4j_torch.models.generation import (  # noqa: E402
    TransformerGenerator, _filtered_logprobs_rows, _gumbel_rows,
    _uniform_rows)
from deeplearning4j_torch.parallel import GenerationServer  # noqa: E402
from deeplearning4j_torch.parallel import speculative as tspec  # noqa: E402
from deeplearning4j_torch.parallel.generation_server import (  # noqa: E402
    STREAM_ACCEPT, STREAM_DRAFT, STREAM_SAMPLE)
from deeplearning4j_torch.zoo import Gpt  # noqa: E402

TINY = dict(vocab_size=50, max_len=32, d_model=32, n_layers=2, n_heads=4,
            d_ff=64, seq_len=8, compute_dtype=None, seed=3)
CPU = dict(device="cpu")


def _tv(a, b):
    return 0.5 * float(np.abs(np.asarray(a) - np.asarray(b)).sum())


def _both(fn_name, *arrays, **kw):
    """Run ``fn_name`` of both packages on the same numpy arrays; returns
    (port outputs, JAX outputs) as numpy."""
    kw_t = {k: (None if v is None else torch.from_numpy(np.asarray(v)))
            for k, v in kw.items()}
    kw_j = {k: (None if v is None else jnp.asarray(v))
            for k, v in kw.items()}
    port = getattr(tspec, fn_name)(
        *[torch.from_numpy(np.asarray(a)) for a in arrays], **kw_t)
    jx = getattr(jspec, fn_name)(*[jnp.asarray(a) for a in arrays], **kw_j)
    return [np.asarray(t) for t in port], [np.asarray(t) for t in jx]


def _assert_same(port, jx):
    for a, b in zip(port, jx):
        np.testing.assert_array_equal(a, b)


# -- the acceptance rules against JAX -----------------------------------
def test_accept_sampled_hand_cases_match_jax():
    """Row 0 accepts everything, row 1 rejects its first proposal, row 2's
    budget of 2 evaluates one proposal, row 3 is inactive; then a
    committed EOS clears the rejected flag, and kcap=2 makes a full
    accept of two proposals."""
    v = np.tile(np.asarray([[5, 6, 7, 8]], np.int32), (4, 1))
    logp = np.zeros((4, 3), np.float32)
    logp[1, 0] = -4.0
    logq = np.zeros((4, 3), np.float32)
    u = np.full((4, 3), 0.5, np.float32)
    u[1, 0] = 0.9
    active = np.asarray([True, True, True, False])
    rem = np.asarray([10, 10, 2, 10], np.int32)
    eos = np.full((4,), -1, np.int32)
    port, jx = _both("accept_sampled", v, logp, logq, u, active, rem, eos)
    _assert_same(port, jx)
    c, r, n_eval, rej = port
    np.testing.assert_array_equal(c, [4, 1, 2, 0])
    np.testing.assert_array_equal(r, [6, 9, 0, 10])
    np.testing.assert_array_equal(n_eval, [3, 3, 1, 0])
    np.testing.assert_array_equal(rej, [False, True, False, False])

    v1 = np.asarray([[5, 9, 7, 8]], np.int32)
    z = np.zeros((1, 3), np.float32)
    lp = z.copy()
    lp[0, 1] = -4.0
    u1 = np.full((1, 3), 0.5, np.float32)
    u2 = u1.copy()
    u2[0, 1] = 0.9
    act, rem1 = np.asarray([True]), np.asarray([10], np.int32)
    port, jx = _both("accept_sampled", v1, lp, z, u2, act, rem1,
                     np.asarray([9], np.int32))
    _assert_same(port, jx)
    assert (int(port[0][0]), int(port[1][0]), bool(port[3][0])) == \
        (2, 0, False)
    port, jx = _both("accept_sampled", v1, z, z, u1, act, rem1,
                     np.asarray([-1], np.int32),
                     kcap=np.asarray([2], np.int32))
    _assert_same(port, jx)
    assert (int(port[0][0]), int(port[2][0]), bool(port[3][0])) == \
        (3, 2, False)


def test_accept_mixed_hand_case_matches_jax():
    """The greedy row commits by the greedy rule and is never flagged for
    a residual; the sampled row rejects by the ratio rule."""
    v = np.asarray([[5, 6, 7], [5, 6, 7]], np.int32)
    g = np.asarray([[8, 7, 0], [6, 7, 0]], np.int32)
    logp = np.full((2, 2), -4.0, np.float32)
    logq = np.zeros((2, 2), np.float32)
    u = np.full((2, 2), 0.9, np.float32)
    port, jx = _both("accept_mixed", np.asarray([True, False]), v, g, logp,
                     logq, u, np.asarray([True, True]),
                     np.asarray([10, 10], np.int32),
                     np.full((2,), -1, np.int32))
    _assert_same(port, jx)
    np.testing.assert_array_equal(port[0], [1, 1])
    np.testing.assert_array_equal(port[1], [9, 9])
    np.testing.assert_array_equal(port[3], [False, True])


def test_accept_rules_random_sweep_match_jax():
    """256 seeded rows per width, random log-densities and uniforms,
    mixed greedy/sampled rows, budgets, EOS, kcap and inactive rows."""
    rng = np.random.default_rng(0)
    B = 256
    for W in (2, 5):
        K = W - 1
        v = rng.integers(0, 4, (B, W)).astype(np.int32)
        g = np.where(rng.random((B, W)) < 0.6, np.roll(v, -1, axis=1),
                     rng.integers(0, 4, (B, W))).astype(np.int32)
        logp = rng.normal(-1.5, 1.0, (B, K)).astype(np.float32)
        logq = rng.normal(-1.5, 1.0, (B, K)).astype(np.float32)
        u = rng.random((B, K)).astype(np.float32)
        active = rng.random(B) < 0.85
        rem = rng.integers(0, 9, B).astype(np.int32)
        eos = np.where(rng.random(B) < 0.4, rng.integers(0, 4, B),
                       -1).astype(np.int32)
        kcap = rng.integers(0, W, B).astype(np.int32)
        greedy = rng.random(B) < 0.5
        _assert_same(*_both("accept_sampled", v, logp, logq, u, active,
                            rem, eos, kcap=kcap))
        _assert_same(*_both("accept_mixed", greedy, v, g, logp, logq, u,
                            active, rem, eos, kcap=kcap))


def test_residual_logits_matches_jax():
    p = np.log(np.asarray([0.5, 0.3, 0.2], np.float32))
    q = np.log(np.asarray([0.2, 0.3, 0.5], np.float32))
    q2 = np.log(np.asarray([0.4, 0.1, 0.5], np.float32))
    for a, b in ((p, q), (p, q2), (p, p)):
        port, jx = _both("residual_logits", a, b)
        np.testing.assert_allclose(port[0], jx[0], atol=1e-6, rtol=0)
    res = torch.softmax(tspec.residual_logits(torch.from_numpy(p),
                                              torch.from_numpy(q2)), -1)
    np.testing.assert_allclose(res.numpy(), [1 / 3, 2 / 3, 0.0], atol=1e-5)
    rng = np.random.default_rng(1)
    lp = np.log(rng.dirichlet(np.ones(12), 6)).astype(np.float32)
    lq = np.log(rng.dirichlet(np.ones(12), 6)).astype(np.float32)
    port, jx = _both("residual_logits", lp, lq)
    np.testing.assert_allclose(port[0], jx[0], atol=1e-6, rtol=0)


def test_filtered_logprobs_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(5, 30)).astype(np.float32) * 3
    temp = np.asarray([0.0, 0.7, 1.0, 1.3, 0.5], np.float32)
    tk = np.asarray([30, 5, 30, 12, 1], np.int32)
    tp = np.asarray([1.0, 1.0, 0.8, 0.9, 1.0], np.float32)
    out = _filtered_logprobs_rows(*[torch.from_numpy(a)
                                    for a in (logits, temp, tk, tp)])
    ref = jax_filtered_logprobs(*[jnp.asarray(a)
                                  for a in (logits, temp, tk, tp)])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


# -- the controller against JAX -----------------------------------------
class _Store:
    """A history-store stub: fixed counter rates."""

    def __init__(self, proposed, accepted):
        self.rates = {tspec.AcceptanceController.SERIES_PROPOSED: proposed,
                      tspec.AcceptanceController.SERIES_ACCEPTED: accepted}

    def rate(self, name, t0, t1):
        return self.rates[name]


def test_controller_decisions_match_jax():
    """The same observation sequence through both controllers: every
    rate and every depth pick (capped and not) agrees, from a cold start
    seeded by a stub store through warm per-key EWMAs."""
    rng = np.random.default_rng(3)
    store = _Store(10.0, 3.0)
    ctls = [mod.AcceptanceController(4, 0.25, ewma=0.3, min_obs=8,
                                     store=store) for mod in (tspec, jspec)]
    keys = [("a", 1), ("a", 2), ("b", None)]
    for _ in range(60):
        key = keys[int(rng.integers(0, 3))]
        acc = int(rng.integers(0, 5))
        p = int(rng.integers(acc, 6))
        for c in ctls:
            c.observe(key, p, acc)
        for k in keys + [("cold", 0)]:
            rates = [c.rate(k) for c in ctls]
            assert rates[0] == pytest.approx(rates[1], abs=1e-12)
            for cap in (None, 2):
                assert ctls[0].k_for(k, cap=cap) == ctls[1].k_for(k,
                                                                  cap=cap)
    assert ctls[0].snapshot() == ctls[1].snapshot()
    cold = [mod.AcceptanceController(4, 0.5, store=store)
            for mod in (tspec, jspec)]
    assert cold[0].k_for("x") == cold[1].k_for("x") == \
        cold[0]._best_k(0.3, 4)
    for c in cold:
        c.reset()
        c.attach_store(None)
    assert cold[0].k_for("x") == cold[1].k_for("x") == 4


# -- the draws -----------------------------------------------------------
def test_streams_are_distinct_and_uniforms_in_range():
    seed = torch.tensor([7, 7, 8], dtype=torch.int64)
    pos = torch.tensor([3, 4, 3], dtype=torch.int64)
    noise = {s: _gumbel_rows(seed, torch.full_like(seed, s), pos, 16)
             for s in (STREAM_SAMPLE, STREAM_DRAFT)}
    assert not torch.equal(noise[STREAM_SAMPLE], noise[STREAM_DRAFT])
    u = _uniform_rows(seed, torch.full_like(seed, STREAM_ACCEPT), pos)
    assert torch.equal(u, _uniform_rows(
        seed, torch.full_like(seed, STREAM_ACCEPT), pos))
    assert len(set(u.tolist())) == 3
    many = _uniform_rows(torch.zeros(4096, dtype=torch.int64),
                         torch.full((4096,), STREAM_ACCEPT,
                                    dtype=torch.int64),
                         torch.arange(4096))
    assert 0.0 < float(many.min()) and float(many.max()) < 1.0
    assert abs(float(many.mean()) - 0.5) < 0.02


def test_held_residual_is_drawn_as_it_is(nets_tiny):
    """A row with ``rawlg`` set samples its held log-weights directly,
    whatever its own sampling settings: a greedy row holding a residual
    with two equal tokens draws both across seeds, where its argmax
    would always give the first."""
    with GenerationServer(nets_tiny, n_slots=1, max_len=32, **CPU) as srv:
        V, B = srv._vocab, 64
        logits = torch.full((B, V), -1e30)
        logits[:, 3] = logits[:, 7] = 0.0
        state = {"logits": logits, "temp": torch.zeros(B),
                 "tk": torch.full((B,), V, dtype=torch.int32),
                 "tp": torch.ones(B), "seed": torch.arange(B),
                 "pos": torch.zeros(B, dtype=torch.int32),
                 "rawlg": torch.ones(B, dtype=torch.bool)}
        drawn = srv._sampler(True)(state)
        plain = srv._sampler(True)(dict(state, rawlg=~state["rawlg"]))
    assert set(drawn.tolist()) == {3, 7}
    assert set(plain.tolist()) == {3}


@pytest.fixture(scope="module")
def nets_tiny():
    return Gpt(**TINY).init_graph(**CPU)


# -- the served law ------------------------------------------------------
_SMALL = dict(vocab_size=8, max_len=8, d_model=16, n_heads=2, d_ff=32,
              seq_len=4, compute_dtype=None)


def _sharpened(net, factor):
    """Scale the output head so the tiny model's distributions are far
    from uniform (and the test has power)."""
    net.params_tree[f"layer_{len(net.layers) - 1}"]["W"] *= factor
    return net


def test_sampled_second_token_marginal_matches_direct_sampling():
    target = _sharpened(Gpt(**_SMALL, n_layers=2, seed=1)
                        .init_graph(**CPU), 2.5)
    draft = _sharpened(Gpt(**_SMALL, n_layers=1, seed=2)
                       .init_graph(**CPU), 2.5)
    prompt = np.asarray([1, 2, 3], np.int32)
    V = 8
    ctx = np.concatenate([np.repeat(prompt[None], V, 0),
                          np.arange(V)[:, None]], 1).astype(np.int64)

    def probs(net, ids):
        gen = TransformerGenerator(net, **CPU)
        return torch.softmax(gen._prefill_rows(
            *gen._serving_params(), torch.as_tensor(ids))[0], -1).numpy()

    p1 = probs(target, prompt[None].astype(np.int64))[0]
    exact = (p1[:, None] * probs(target, ctx)).sum(0)
    proposals = (p1[:, None] * probs(draft, ctx)).sum(0)
    assert _tv(exact, proposals) > 0.15        # the test has power
    N = 1500
    with GenerationServer(target, n_slots=32, max_len=8, block_size=4,
                          speculative={"k": 1, "draft_net": draft},
                          **CPU) as srv:
        hs = [srv.submit_async(prompt, 2,
                               sampling={"temperature": 1.0, "seed": i})
              for i in range(N)]
        outs = np.stack([h.result(timeout=300) for h in hs])
        st = srv.stats()
    assert 0.0 < st["spec_acceptance_rate"] < 1.0   # both branches ran
    hist = np.bincount(outs[:, 4], minlength=V) / N
    assert _tv(hist, exact) < 0.05
    assert _tv(hist, proposals) > 0.1
    first = np.bincount(outs[:, 3], minlength=V) / N
    assert _tv(first, p1) < 0.05


def test_sampled_spec_reproducible_and_rounds_invariant(nets_tiny):
    """A sampled request's stream is a pure function of its seed: the same
    at rounds 1, 2 and 4 and on a fresh server; another seed differs.
    Per-tenant acceptance reaches the labeled gauge."""
    p = np.asarray([4, 8, 15, 16], np.int32)
    samp = {"temperature": 1.0, "top_k": 10, "seed": 21}
    gauge = telemetry.get_registry().gauge(
        "generation_server_tenant_spec_acceptance_rate",
        labelnames=("tenant",))
    outs = {}
    for rounds in (1, 2, 4):
        with GenerationServer(nets_tiny, n_slots=2, max_len=32,
                              speculative={"k": 3, "rounds": rounds,
                                           "draft_layers": 1},
                              **CPU) as srv:
            outs[rounds] = srv.submit(p, 16, sampling=samp, timeout=120,
                                      tenant="acme")
            other = srv.submit(p, 16, sampling=dict(samp, seed=22),
                               timeout=120)
            st = srv.stats()
        assert st["spec_proposed"] > 0
    np.testing.assert_array_equal(outs[1], outs[2])
    np.testing.assert_array_equal(outs[1], outs[4])
    assert not np.array_equal(other, outs[1])
    assert 0.0 <= gauge.labels(tenant="acme").value <= 1.0


def test_adaptive_depth_follows_the_controller(nets_tiny):
    """``adaptive=True``: a cold controller seeded from a history store
    with zero acceptance picks depth 1 for every slot; without the store
    it starts at k_max."""
    p = np.asarray([2, 7, 1, 8, 2, 8], np.int32)
    depth = telemetry.get_registry().gauge(
        "generation_server_spec_adaptive_k")
    with GenerationServer(nets_tiny, n_slots=2, max_len=32,
                          speculative={"k": 2, "k_max": 4,
                                       "adaptive": True,
                                       "draft_layers": 1}, **CPU) as srv:
        srv.submit(p, 2, timeout=120)
        assert depth.value == 4
        srv.attach_history(_Store(100.0, 0.0))
        srv._spec_ctl.reset()
        out = srv.submit(p, 8, timeout=120)
        assert depth.value == 1
        st = srv.stats()
    assert st["spec_adaptive"] and st["spec_k_max"] == 4
    assert out.shape == (len(p) + 8,)
