"""The port's degradation ladder, admission projection and front door,
held to the JAX package's ``tests/test_degrade.py`` case by case (same
names, same injected clocks and burns, the same assertions).  The
pure-host cases run in BOTH packages with the results compared
(``torch_plane_util.both``: equal, floats within 1e-12 relative); a
seeded random burn sequence drives both ladders rung for rung.

The fleet cases run the port's ``ServingFleet`` on the tiny Gpt with the
JAX package's parameters carried over: the ladder's reversibility is held
to the JAX package's OWN offline greedy streams (cross-framework greedy
streams are equal on the tiny Gpt), and to the port's offline streams by
the near-tie rule.  The reference marks its two fleet cases slow (JAX
compiles); the eager port runs them in the tier-1 suite."""
import importlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_plane_util import both, plane  # noqa: E402
from torch_serving_util import (TINY, assert_stream,  # noqa: E402
                                offline_ref)

PORT = "deeplearning4j_torch"


def _tenant_total(P, name):
    fam = P.telemetry.get_registry().counter(name, labelnames=("tenant",))
    return sum(c.value for _vals, c in fam._items())


def _counter(P, name):
    return P.telemetry.get_registry().counter(name).value


@pytest.fixture(scope="module")
def nets():
    """(JAX tiny Gpt, the port's tiny Gpt with the JAX parameters)."""
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.zoo.gpt import Gpt as JaxGpt
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf.builder import (
        MultiLayerConfiguration)
    from deeplearning4j_torch.utils import load_numpy_params
    jnet = JaxGpt(**TINY).init_graph()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()))
    load_numpy_params(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree),
                      device="cpu")
    return jnet, pnet


@pytest.fixture(scope="module")
def net(nets):
    return nets[1]


@pytest.fixture(scope="module")
def offline(net):
    from deeplearning4j_torch.models.generation import TransformerGenerator
    return TransformerGenerator(net, device="cpu")


def _fleet(P, net, **kw):
    cfg = dict(n_replicas=1, n_slots=2, max_len=32, block_size=4,
               tick_batch=1, tick_timeout_s=None, device="cpu")
    cfg.update(kw)
    return P.serving.ServingFleet(net, **cfg)


# ---------------------------------------------------------------------------
# the ladder state machine, pure host
# ---------------------------------------------------------------------------
def test_ladder_validation():
    def run(P):
        L = P.degrade.DegradeLadder
        msgs = []
        for kw, match in (({"thresholds": (1.0, 2.0, 3.0, 4.0)},
                           "thresholds"),
                          ({"thresholds": (1.0, 3.0, 2.0, 4.0, 5.0)},
                           "strictly increase"),
                          ({"hysteresis": 1.5}, "hysteresis"),
                          ({"n_new_factor": 0.0}, "n_new_factor")):
            with pytest.raises(ValueError, match=match) as ei:
                L(**kw)
            msgs.append(str(ei.value))
        return msgs

    assert len(both(run)) == 4


def test_rung_transition_matrix_injected_clock():
    def run(P):
        lad = P.degrade.DegradeLadder(
            thresholds=(1.0, 2.0, 3.0, 4.0, 5.0), hysteresis=0.5,
            hold_down_s=10.0)
        rungs = [lad.evaluate(now=t, burn=b) for t, b in (
            (0.0, 0.5), (1.0, 2.5), (2.0, 6.0), (3.0, 3.0), (4.0, 1.0),
            (13.0, 1.0), (14.0, 1.0), (23.0, 1.0), (24.5, 1.0))]
        return rungs, lad.state(), P.degrade.RUNGS

    rungs, st, names = both(run)
    assert rungs == [0, 2, 5, 5, 5, 5, 4, 4, 3]
    assert st["rung"] == 3 and st["name"] == names[3]
    assert st["transitions"] == {
        "enter:shrink_budget": 1, "enter:force_greedy": 1,
        "enter:shrink_draft_k": 1, "enter:spec_off": 1,
        "enter:shed_batch": 1,
        "exit:shed_batch": 1, "exit:spec_off": 1}


def test_hysteresis_never_flaps():
    def run(P):
        lad = P.degrade.DegradeLadder(thresholds=(4.0, 6.0, 8.0, 10.0,
                                                  12.0),
                                      hysteresis=0.7, hold_down_s=1.0)
        for i in range(50):
            lad.evaluate(now=float(i), burn=4.1 if i % 2 == 0 else 3.9)
        return lad.state()

    st = both(run)
    assert st["rung"] == 1
    assert st["transitions"] == {"enter:shrink_budget": 1}


def test_seeded_burn_walk_equal_in_both_packages():
    """A numpy-seeded burn trace (quiet stretches, spikes, slow decays)
    at seeded instants through both packages' ladders: the same rung
    after every pass, the same transitions, policies and admission
    shaping at every rung."""
    rng = np.random.default_rng(18)
    n = 400
    times = np.cumsum(rng.uniform(0.05, 1.5, n))
    level = np.abs(np.cumsum(rng.normal(0.0, 1.5, n))) \
        * (rng.random(n) < 0.8)
    burns = level + (rng.random(n) < 0.05) * rng.uniform(10.0, 30.0, n)

    def run(P):
        lad = P.degrade.DegradeLadder(
            thresholds=(2.0, 6.0, 8.0, 10.0, 14.4), hysteresis=0.7,
            hold_down_s=2.0, n_new_factor=0.25, batch_tenants=("bulk",))
        rungs, shapes = [], []
        for t, b in zip(times, burns):
            rungs.append(lad.evaluate(now=float(t), burn=float(b)))
            shapes.append([lad.shape_admission(x, 37, s) for x, s in (
                ("chat", None), ("chat", {"temperature": 0.8,
                                          "top_k": 5}),
                ("bulk", {"temperature": 0.0}))])
        return {"rungs": rungs, "shapes": shapes, "state": lad.state(),
                "policies": [lad.policy(r) for r in range(6)]}

    r = both(run)
    assert set(r["rungs"]) == set(range(6))
    ups = [b - a for a, b in zip(r["rungs"], r["rungs"][1:]) if b < a]
    assert ups and all(d == -1 for d in ups)     # descent one rung a pass


def test_policy_nests_and_shapes_admission():
    def run(P):
        lad = P.degrade.DegradeLadder(thresholds=(1.0, 2.0, 3.0, 4.0, 5.0),
                                      n_new_factor=0.25,
                                      batch_tenants=("bulk",))
        out = {"p0": lad.policy(0), "p3": lad.policy(3),
               "p4": lad.policy(4), "shed5": lad.policy(5)["shed_tenants"],
               "r0": lad.shape_admission("t", 8, {"temperature": 0.9})}
        lad.evaluate(now=0.0, burn=2.5)
        out["r2"] = lad.shape_admission("t", 8, {"temperature": 0.9})
        out["r2_greedy"] = lad.shape_admission("t", 1,
                                               {"temperature": 0.0})
        lad.evaluate(now=1.0, burn=9.0)
        out["r5_bulk"] = lad.shape_admission("bulk", 8, None)[2]
        out["r5_t"] = lad.shape_admission("t", 8, None)[2]
        return out

    r = both(run)
    assert r["p0"] == {"max_n_new_factor": None, "min_n_new": 1,
                       "force_greedy": False, "draft_k_cap": None,
                       "spec": True, "shed_tenants": ()}
    assert r["p3"] == {"max_n_new_factor": 0.25, "min_n_new": 1,
                       "force_greedy": True, "draft_k_cap": 1,
                       "spec": True, "shed_tenants": ()}
    assert r["p4"] == {"max_n_new_factor": 0.25, "min_n_new": 1,
                       "force_greedy": True, "draft_k_cap": 1,
                       "spec": False, "shed_tenants": ()}
    assert r["shed5"] == ("bulk",)
    assert r["r0"] == (8, {"temperature": 0.9}, "admit")
    assert r["r2"] == (2, {"temperature": 0.0}, "degraded")
    assert r["r2_greedy"] == (1, {"temperature": 0.0}, "admit")
    assert r["r5_bulk"] == "reject" and r["r5_t"] == "degraded"


def test_shed_set_reads_accountant_batch_class():
    def run(P):
        class _F:
            pass
        f = _F()
        TQ = P.serving.TenantQuota
        f._acct = P.serving.TenantAccountant(
            default_quota=TQ(klass="batch"),
            quotas={"bulk": TQ(klass="batch"),
                    "chat": TQ(klass="interactive")})
        L = P.degrade.DegradeLadder
        return (L(fleet=f).shed_tenants(),
                L(fleet=f, batch_tenants=("x",)).shed_tenants(),
                L().shed_tenants())

    assert both(run) == (("bulk",), ("x",), ())


def test_ladder_reads_the_engine_projection():
    """``burn=None``: the ladder drives on the worst covered projection
    of the engine's specs — 0 while the history is young, the covered
    overdraft's projection after."""
    def run(P):
        eng, src = _admission_engine(P)
        lad = P.degrade.DegradeLadder(engine=eng, hold_down_s=5.0)
        rungs = [lad.evaluate(now=0.0)]
        eng.evaluate(now=0.0)
        for t in (10.0, 20.0, 30.0, 40.0):
            _feed(src, bad=10)
            eng.evaluate(now=t)
            rungs.append(lad.evaluate(now=t))
        for t in (50.0, 60.0, 70.0, 80.0, 90.0, 100.0, 110.0):
            _feed(src, good=200)
            eng.evaluate(now=t)
            rungs.append(lad.evaluate(now=t))
        return rungs, lad.state()

    rungs, st = both(run)
    assert rungs[:2] == [0, 0]          # young history: no burn
    assert max(rungs) >= 3 and rungs[-1] < max(rungs)


# ---------------------------------------------------------------------------
# admission projection on the real engine: the coverage gate
# ---------------------------------------------------------------------------
def _admission_engine(P, tenant="b", windows=((10.0, 30.0, 2.0, "page"),)):
    src = P.registry.MetricsRegistry()
    src.counter("fleet_requests_total", labelnames=("tenant", "outcome"))
    spec = P.slo.SLOSpec("adm-avail", objective="availability",
                         target=0.9, tenant=tenant, window_s=100.0,
                         windows=[tuple(w) for w in windows])
    return P.slo.AlertEngine([spec], source=src,
                             registry=P.registry.MetricsRegistry()), src


def _feed(src, good=0.0, bad=0.0, tenant="b"):
    fam = src.counter("fleet_requests_total",
                      labelnames=("tenant", "outcome"))
    if good:
        fam.labels(tenant=tenant, outcome="admitted").inc(good)
    if bad:
        fam.labels(tenant=tenant, outcome="failed").inc(bad)


def test_admission_young_history_admits_everything():
    def run(P):
        eng, src = _admission_engine(P)
        eng.evaluate(now=0.0)
        _feed(src, bad=10)
        eng.evaluate(now=10.0)
        return (eng.projection(now=10.0)[0]["covered"],
                eng.admission_decision("b", now=10.0)["decision"])

    assert both(run) == (False, "admit")


def test_admission_rejects_on_covered_overdraft_with_retry_slope():
    def run(P):
        eng, src = _admission_engine(P)
        eng.evaluate(now=0.0)
        for t in (10.0, 20.0, 30.0):
            _feed(src, bad=10)
            eng.evaluate(now=t)
        return (eng.projection(now=30.0)[0],
                eng.admission_decision("b", now=30.0),
                eng.admission_decision("other", now=30.0)["decision"])

    row, v, other = both(run)
    assert row["covered"] is True
    assert row["projected_burn"] == pytest.approx(10.0)
    assert v["decision"] == "reject" and v["slo"] == "adm-avail"
    assert 10.0 <= v["retry_after_s"] <= 100.0
    assert v["projected_burn"] == pytest.approx(10.0)
    assert other == "admit"


def test_tenantless_spec_degrades_but_never_rejects():
    def run(P):
        eng, src = _admission_engine(P, tenant=None)
        eng.evaluate(now=0.0)
        for t in (10.0, 20.0, 30.0):
            _feed(src, bad=10, tenant="whoever")
            eng.evaluate(now=t)
        return eng.admission_decision("whoever", now=30.0)

    v = both(run)
    assert v["decision"] == "degrade"
    assert v["projected_burn"] == pytest.approx(10.0)


# ---------------------------------------------------------------------------
# submit(retries=) honors retry_after_s as the backoff floor
# ---------------------------------------------------------------------------
def test_submit_retry_floors_backoff_at_retry_after():
    P = plane(PORT)

    class _Handle:
        def result(self, timeout=None):
            return np.asarray([1, 2, 3], np.int32)

    class _Stub:
        retry_backoff_s = 0.01

        def __init__(self):
            self.calls = 0

        def submit_async(self, *a, **kw):
            self.calls += 1
            if self.calls == 1:
                raise P.serving.AdmissionRejectedError("b", 0.25, 5.0)
            return _Handle()

    stub = _Stub()
    with pytest.raises(P.serving.AdmissionRejectedError) as ei:
        P.serving.ServingFleet.submit(stub, [1], 4, retries=0)
    assert ei.value.retry_after_s == 0.25
    assert ei.value.projected_burn == 5.0 and ei.value.tenant == "b"
    stub = _Stub()
    t0 = time.monotonic()
    out = P.serving.ServingFleet.submit(stub, [1], 4, retries=2)
    assert time.monotonic() - t0 >= 0.25
    assert stub.calls == 2
    np.testing.assert_array_equal(out, [1, 2, 3])


# ---------------------------------------------------------------------------
# fleet integration: the reject is zero-cost
# ---------------------------------------------------------------------------
class _RejectingEngine:
    def admission_decision(self, tenant, now=None):
        if tenant == "b":
            return {"decision": "reject", "retry_after_s": 0.5,
                    "projected_burn": 14.4, "slo": "stub"}
        return {"decision": "admit", "retry_after_s": 0.0,
                "projected_burn": 0.0, "slo": None}


def test_front_door_reject_is_zero_cost(net):
    P = plane(PORT)
    rej0 = _tenant_total(P, "fleet_admission_rejected_total")
    with _fleet(P, net, slo_engine=_RejectingEngine(),
                admission_control=True) as fleet:
        with pytest.raises(P.serving.AdmissionRejectedError) as ei:
            fleet.submit_async(np.asarray([1, 2, 3], np.int32), 4,
                               tenant="b")
        assert ei.value.retry_after_s == 0.5
        assert ei.value.projected_burn == 14.4
        st = fleet.stats()
        assert st["waiting"] == 0 and st["inflight"] == 0
        assert "b" not in st["tenants"]
    assert _tenant_total(P, "fleet_admission_rejected_total") - rej0 == 1.0
    with _fleet(P, net, slo_engine=_RejectingEngine()) as fleet:
        h = fleet.submit_async(np.asarray([1, 2, 3], np.int32), 4,
                               tenant="b")
        h.cancel()
    assert _tenant_total(P, "fleet_admission_rejected_total") - rej0 == 1.0


# ---------------------------------------------------------------------------
# fleet integrations: reversibility; the hedge race resolves first-wins
# ---------------------------------------------------------------------------
def test_ladder_reversibility_byte_parity(nets, offline):
    """Every rung is REVERSIBLE: at the top rung admissions are shaped
    (budget capped, sampling forced greedy, batch shed with the ladder's
    retry-after) and equal the JAX package's offline greedy stream at
    the SHAPED budget; walked back to 0, a fresh request equals the JAX
    package's never-degraded stream, batch admitted again.  Each port
    output is also held to the port's own offline stream (near-tie
    rule)."""
    from deeplearning4j_tpu.models.generation import (
        TransformerGenerator as JaxGenerator)
    jnet, net = nets
    P = plane(PORT)
    p = np.arange(1, 14, dtype=np.int32)
    jgen = JaxGenerator(jnet)
    ref_full = np.asarray(jgen.generate(p[None], n_new=8))[0]
    ref_capped = np.asarray(jgen.generate(p[None], n_new=2))[0]
    deg0 = _tenant_total(P, "fleet_admission_degraded_total")
    with _fleet(P, net, quotas={"bulk": P.serving.TenantQuota(
            klass="batch")}) as fleet:
        lad = P.degrade.DegradeLadder(fleet,
                                      thresholds=(1.0, 2.0, 3.0, 4.0, 5.0),
                                      hold_down_s=0.0, n_new_factor=0.25)
        fleet.attach_degrade(lad)
        assert lad.evaluate(now=0.0, burn=10.0) == 5
        with pytest.raises(P.serving.AdmissionRejectedError) as ei:
            fleet.submit_async(p, 8, tenant="bulk")
        assert ei.value.retry_after_s == lad.shed_retry_after_s
        shaped = [fleet.submit(p, 8, tenant="chat", timeout=300),
                  fleet.submit(p, 8, tenant="chat", timeout=300,
                               sampling={"temperature": 0.9})]
        for out in shaped:
            np.testing.assert_array_equal(out, ref_capped)
            assert_stream(offline, out, offline_ref(offline, p, 2))
        assert _tenant_total(P, "fleet_admission_degraded_total") \
            - deg0 >= 2
        walked = []
        while True:
            r = lad.evaluate(now=1000.0, burn=0.0)
            walked.append(r)
            if r == 0:
                break
            assert len(walked) < 20
        assert walked == [5, 4, 3, 2, 1, 0]   # the first pass arms the clock
        assert lad.rung() == 0
        assert lad.state()["transitions"]["exit:shed_batch"] == 1
        for tenant in ("chat", "bulk"):
            out = fleet.submit(p, 8, tenant=tenant, timeout=300)
            np.testing.assert_array_equal(out, ref_full)
            assert_stream(offline, out, offline_ref(offline, p, 8))


def test_ladder_rungs_actuate_a_speculative_replica(net, offline):
    """The ladder's replica-side rungs on a speculative fleet: at
    ``shrink_draft_k`` the draft depth caps at 1 (verify W = 2), at
    ``spec_off`` no verify pass runs while decode ticks go on, and back
    at 0 speculation resumes — each request equal to offline (near-tie
    rule)."""
    P = plane(PORT)
    reg = P.telemetry.get_registry()
    scans = reg.counter("generation_server_scan_ticks_total",
                        labelnames=("k",))
    ticks = reg.counter("generation_server_ticks_total")
    spec = {"k": 3, "rounds": 1, "draft_layers": 1}
    p = np.arange(1, 12, dtype=np.int32)
    ref = offline_ref(offline, p, 10)

    def spec_scans():
        return {v[0]: c.value for v, c in scans._items()
                if v[0].startswith("spec")}

    with _fleet(P, net, speculative=spec, kv_blocks=32) as fleet:
        lad = P.degrade.DegradeLadder(fleet, hold_down_s=0.0,
                                      n_new_factor=1.0)
        fleet.attach_degrade(lad)
        seen = {}
        for rung, burn in ((0, 0.0), (3, 8.0), (4, 10.0), (0, 0.0)):
            while lad.rung() > rung:
                lad.evaluate(now=time.monotonic(), burn=burn)
            lad.evaluate(now=time.monotonic(), burn=burn)
            assert lad.rung() == rung
            s0, t0 = spec_scans(), ticks.value
            out = fleet.submit(p, 10, tenant="chat", timeout=300)
            assert_stream(offline, out, ref)
            s1 = spec_scans()
            seen[len(seen)] = ({k: s1[k] - s0.get(k, 0.0) for k in s1
                                if s1[k] - s0.get(k, 0.0)},
                               ticks.value - t0)
    shapes0, _ = seen[0]
    assert any(k.endswith("x4") for k in shapes0)     # W = k + 1 = 4
    shapes3, _ = seen[1]
    assert shapes3 and all(k.endswith("x2") for k in shapes3)   # W = 2
    shapes4, ticks4 = seen[2]
    assert shapes4 == {} and ticks4 > 0               # spec off, K1 only
    shapes_back, _ = seen[3]
    assert any(k.endswith("x4") for k in shapes_back)


def test_hedge_first_wins_and_loser_cancelled(net, offline):
    P = plane(PORT)
    p = np.arange(1, 10, dtype=np.int32)
    ref = offline_ref(offline, p, 10)
    l0 = _counter(P, "fleet_hedges_launched_total")
    w0 = _counter(P, "fleet_hedges_won_total")
    c0 = _counter(P, "fleet_hedges_cancelled_total")
    with _fleet(P, net, n_replicas=2, hedge_slack_s=60.0) as fleet:
        h = fleet.submit_async(p, 10, deadline_s=30.0)
        assert_stream(offline, h.result(timeout=300), ref)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if (_counter(P, "fleet_hedges_cancelled_total") - c0
                    == _counter(P, "fleet_hedges_launched_total") - l0):
                break
            time.sleep(0.01)
        launched = _counter(P, "fleet_hedges_launched_total") - l0
        won = _counter(P, "fleet_hedges_won_total") - w0
        cancelled = _counter(P, "fleet_hedges_cancelled_total") - c0
        assert launched == 1.0
        assert cancelled == launched
        assert won in (0.0, 1.0)
        assert_stream(offline, fleet.submit(p, 10, timeout=300), ref)
        assert _counter(P, "fleet_hedges_launched_total") - l0 == launched


# ---------------------------------------------------------------------------
# chip_smoke.py's slo phase: rehearsed on the CPU, its rung walk on the card
# ---------------------------------------------------------------------------
class _Counted:
    """A counting stand-in for a kernel wrapper: the CPU path launches no
    kernel, so the rehearsal counts the calls the path makes instead."""

    def __init__(self, fn):
        self.fn, self.launches = fn, 0

    def __call__(self, *a, **kw):
        self.launches += 1
        return self.fn(*a, **kw)


def test_slo_phase_rehearsal_on_cpu(monkeypatch, capsys):
    """The whole ``slo`` phase of ``chip_smoke.py`` — plane attached,
    burst, recovery, rung walk, exposition, costs and turns — on a tiny
    speculative Gpt on the CPU, its clocks scaled down, every TTFT over
    the bar (1e-4 s).  The plane runs on an injected timeline
    (``chip_smoke.PlaneClock``, the plane modules' ``time``): each
    dispatch moves it 30 ms, so the burst outlasts the alert's hold
    times by the same number of dispatches however loaded the host is,
    and the recovery's waits move it one loop interval at a time.  Its
    own checks are the assertions: the alert fires and resolves, the
    ladder climbs to 5 and walks back one rung per hold-down, one
    scale-up and one scale-down, K2 frozen at spec_off, streams equal
    offline by the near-tie rule."""
    import json
    import chip_smoke
    from deeplearning4j_torch.models import generation
    from deeplearning4j_torch.parallel import generation_server as gs
    from deeplearning4j_torch.zoo import Gpt

    cfg = {"ttft_s": 1e-4, "windows": ((0.6, 1.5, 14.4, "page"),),
           "for_s": 0.2, "clear_for_s": 0.3, "interval_s": 0.1,
           "hold_down_s": 0.3, "cooldown_s": 1.0,
           "near_tie": chip_smoke.NEAR_TIE_F32, "deadline_s": 120.0}
    clock = cfg["clock"] = chip_smoke.PlaneClock(cfg["interval_s"])
    for mod in ("telemetry.tsdb", "telemetry.slo", "serving.degrade",
                "serving.autoscale"):
        monkeypatch.setattr(importlib.import_module(f"{PORT}.{mod}"),
                            "time", clock)
    k1 = _Counted(generation.paged_decode_attention)
    k2 = _Counted(generation.paged_verify_attention)
    monkeypatch.setattr(generation, "paged_decode_attention", k1)
    monkeypatch.setattr(generation, "paged_verify_attention", k2)
    for name in ("_decode_scan", "_spec_rounds"):
        orig = getattr(gs.GenerationServer, name)

        def slow(self, *a, _orig=orig, **kw):
            clock.advance(0.03)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(gs.GenerationServer, name, slow)
    net = Gpt(**dict(TINY, max_len=128)).init_graph(device="cpu")
    kw = dict(compute_dtype=None, n_slots=2, max_len=128, block_size=8,
              tick_batch=1, device="cpu")
    launches = chip_smoke.slo_parts(torch, np, net, kw, k1, k2, 50, "cpu",
                                    cfg)
    assert launches["k1"] > 0 and launches["k2"] > 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    phases = {ln["phase"]: ln for ln in lines}
    assert set(phases) == {"slo/burst", "slo/recovery", "slo/walk",
                           "slo/exposition", "slo/costs"}
    walk = phases["slo/walk"]["rungs"]
    assert [r["rung"] for r in walk] == [0, 1, 2, 3, 4, 5, 4, 3, 2, 1, 0]
    assert all(r["k2"] == 0 for r in walk if r["rung"] >= 4)
    assert [t["plane"] for t in phases["slo/costs"]["turns"]] == \
        ["off", "on", "on", "off"]


@pytest.mark.gpu
def test_cuda_slo_rung_walk_at_small_width():
    """The smoke's rung walk (part (d)) on the card at a small width: a
    speculative fleet of the tiny Gpt in bf16, the ladder walked 0 -> 5 ->
    0 with injected clocks; K2 counted from a reset is 0 at spec_off and
    shed_batch while K1 runs, W = 2 at shrink_draft_k, and back at 0 K2
    launches again and the stream equals the never-degraded one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import types
    import chip_smoke
    from deeplearning4j_torch.kernels import paged_attention as pa
    from deeplearning4j_torch.models.generation import TransformerGenerator
    from deeplearning4j_torch.serving import (DegradeLadder, ServingFleet,
                                              TenantQuota)
    from deeplearning4j_torch.zoo import Gpt
    net = Gpt(**dict(TINY, max_len=128)).init_graph(device="cuda")
    gen = TransformerGenerator(net, compute_dtype="bfloat16",
                               device="cuda")
    p = np.arange(1, 30, dtype=np.int32) % 50
    with ServingFleet(net, n_replicas=1, n_slots=4, max_len=128,
                      block_size=16, tick_batch=4,
                      compute_dtype="bfloat16",
                      speculative=chip_smoke.SPEC_FULL,
                      quotas={"bulk": TenantQuota(klass="batch")}) as fleet:
        lad = DegradeLadder(fleet, hold_down_s=1.0)
        fleet.attach_degrade(lad)
        rows = chip_smoke.slo_walk(torch, np, fleet,
                                   types.SimpleNamespace(
                                       ladder=lad, now=time.monotonic), gen,
                                   pa.paged_decode_attention,
                                   pa.paged_verify_attention, p, 32,
                                   (p[:8], 4), chip_smoke.NEAR_TIE_BF16)
    assert [r["rung"] for r in rows] == [0, 1, 2, 3, 4, 5, 4, 3, 2, 1, 0]
    assert all(r["k2"] == 0 and r["k1"] > 0 for r in rows
               if r["rung"] >= 4)
    assert rows[-1]["k2"] > 0 and rows[0]["k2"] > 0
