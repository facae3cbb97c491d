"""The port's telemetry: request spans by trace id, flight-recorder
postmortem bundles, the sampling profiler's phases on the CPU, and the
metric series a fleet drive emits — whose names must equal the JAX
package's after the same drive, for the ``fleet_*``,
``generation_server_*`` and ``kv_*`` families (the handoff and tier
series included), so one dashboard reads either package."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_serving_util import CPU, TINY, tiny_net  # noqa: E402

from deeplearning4j_torch import telemetry  # noqa: E402
from deeplearning4j_torch.parallel import GenerationServer  # noqa: E402
from deeplearning4j_torch.serving import ServingFleet  # noqa: E402
from deeplearning4j_torch.telemetry.flightrec import (  # noqa: E402
    FlightRecorder, list_bundles, load_bundle)
from deeplearning4j_torch.telemetry.profiling import (  # noqa: E402
    DeviceProfiler)
from deeplearning4j_torch.telemetry.registry import (  # noqa: E402
    MetricsRegistry)
from deeplearning4j_torch.telemetry.tracing import SpanTracer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def net():
    return tiny_net()


def test_fleet_request_spans_by_trace_id(net):
    """A fleet request mints a trace id; its spans — the router's
    admission and placement, the replica's queue, prefill and decode —
    all carry it, so one request's tree comes back from
    ``events_for_trace``."""
    tracer = telemetry.get_tracer()
    p = np.arange(1, 14, dtype=np.int32)
    with ServingFleet(net, n_replicas=2, n_slots=2, max_len=32,
                      block_size=4, tick_batch=1, tick_timeout_s=None,
                      **CPU) as fleet:
        h = fleet.submit_async(p, n_new=4, tenant="t")
        h.result(timeout=300)
        tid = h.trace_id
    assert tid
    names = {e["name"] for e in tracer.events_for_trace(tid)}
    assert {"request/replica_queue", "request/prefill",
            "request/decode"} <= names
    assert any(n.startswith("request/") and n not in (
        "request/replica_queue", "request/prefill", "request/decode")
        for n in names)                       # the router's own spans
    for e in tracer.events_for_trace(tid):
        assert e["args"]["trace"] == tid


def test_tracked_span_closes_on_owner_death():
    """A bound span opened by a scheduler incarnation is flushed by
    ``end_owned_by`` with the recovery's error arg (how a hung
    dispatch's tick span still reaches the trace)."""
    tracer = SpanTracer()
    sp = tracer.begin("serve/tick", bound=True, owner=("srv", 0))
    assert tracer.open_spans() == [sp]
    assert tracer.end_owned_by(("srv", 0), error="watchdog_recovery") == 1
    (ev,) = tracer.events()
    assert ev["name"] == "serve/tick"
    assert ev["args"]["error"] == "watchdog_recovery"
    assert tracer.open_spans() == []


def test_flight_recorder_dump_and_watchdog_bundle(net, tmp_path):
    """The recorder's ring freezes into an atomic postmortem bundle with
    the open spans and a metric snapshot; a watchdog recovery in a
    server writes one through the process recorder."""
    rec = FlightRecorder(capacity=8)
    for i in range(12):
        rec.record("admit", slot=i)
    assert [e["slot"] for e in rec.events()] == list(range(4, 12))
    rec.install_dump(str(tmp_path / "own"), host="h0")
    path = rec.request_dump("manual", error="boom")
    doc = load_bundle(path)
    assert doc["reason"] == "manual" and doc["error"] == "boom"
    assert len(doc["events"]) == 8 and "metrics" in doc
    rec.uninstall_dump()

    from deeplearning4j_torch.resilience import FaultInjector
    flight = telemetry.get_flight_recorder()
    flight.install_dump(str(tmp_path / "proc"), host="h1")
    try:
        p = np.asarray([5, 6, 7], np.int32)
        with GenerationServer(net, n_slots=2, max_len=32,
                              tick_timeout_s=0.5, tick_batch=1,
                              submit_retries=4, retry_backoff_s=0.02,
                              **CPU) as srv:
            srv.submit(p, n_new=2, timeout=300)
            with FaultInjector(["serve_tick_stall@0:2.0"]):
                srv.submit(p, n_new=6, timeout=300)
    finally:
        flight.uninstall_dump()
    bundles = list_bundles(str(tmp_path / "proc"))
    assert bundles
    doc = load_bundle(bundles[0])
    assert doc["reason"].startswith("watchdog:")
    kinds = {e["kind"] for e in doc["events"]}
    assert {"admit", "watchdog"} <= kinds


def test_profiler_phases_on_cpu(net):
    """On the CPU the profiler times with ``time.perf_counter`` under the
    ``cpu:0`` label; sampling is 1-in-N per phase, and the server's
    dispatches land as decode_tick and prefill samples."""
    reg = MetricsRegistry()
    prof = DeviceProfiler(reg, sample_every=2)
    assert prof.device() == ("cuda:0" if torch.cuda.is_available()
                             else "cpu:0")
    for _ in range(4):
        with prof.measure("decode_tick", devices=["cpu:0"]) as m:
            m.ready(None)
    top = prof.top_ops()
    assert len(top) == 1 and top[0]["samples"] == 2
    assert top[0]["device"] == "cpu:0" and top[0]["phase"] == "decode_tick"
    skipped = reg.counter("fleet_device_phase_skipped_total",
                          labelnames=("phase",))
    assert skipped.labels(phase="decode_tick").value == 2

    hist = telemetry.get_registry().histogram(
        "fleet_device_phase_seconds", labelnames=("device", "phase"))
    before = {ph: hist.labels(device="cpu:0", phase=ph).state()[3]
              for ph in ("decode_tick", "prefill")}
    with GenerationServer(net, n_slots=2, max_len=32, tick_batch=1,
                          **CPU) as srv:
        for _ in range(4):
            srv.submit(np.asarray([1, 2, 3], np.int32), n_new=3,
                       timeout=300)
    after = {ph: hist.labels(device="cpu:0", phase=ph).state()[3]
             for ph in ("decode_tick", "prefill")}
    assert after["decode_tick"] - before["decode_tick"] >= 12
    assert after["prefill"] - before["prefill"] >= 1   # 1-in-4 sampled


# The same drive in either package, in a fresh interpreter (a clean
# process registry): a unified fleet (affinity hit, a host tier that
# spills and fetches) and a disaggregated one (a
# handoff).  Prints the names of the families the drive touched.
DRIVE = r'''
import json, sys
import numpy as np
pkg = sys.argv[1]
if pkg == "deeplearning4j_tpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
    from deeplearning4j_tpu.zoo.gpt import Gpt
    net = Gpt(**TINY).init_graph()
    extra = {}
else:
    from deeplearning4j_torch.zoo import Gpt
    net = Gpt(**TINY).init_graph(device="cpu")
    extra = {"device": "cpu"}
import importlib
telemetry = importlib.import_module(pkg + ".telemetry")
serving = importlib.import_module(pkg + ".serving")
p = np.arange(1, 14, dtype=np.int32)
q = np.asarray([2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5, 9], np.int32)
kw = dict(n_slots=2, max_len=32, block_size=4, tick_batch=1,
          tick_timeout_s=None, **extra)
with serving.ServingFleet(net, n_replicas=2, kv_blocks=8,
                          host_tier_blocks=8, **kw) as fleet:
    fleet.submit(p, n_new=12, tenant="a", timeout=300)
    fleet.submit(p, n_new=12, tenant="a", timeout=300)
    fleet.submit(q, n_new=12, tenant="b", timeout=300)
    fleet.submit(q, n_new=12, tenant="b", timeout=300)
    fleet.submit(p, n_new=12, tenant="a", timeout=300)
with serving.ServingFleet(net, n_replicas=2, roles=("prefill", "decode"),
                          **kw) as fleet:
    fleet.submit(p, n_new=6, tenant="a", timeout=300)
    fleet.submit(np.asarray([3, 4], np.int32), n_new=3, tenant="b",
                 timeout=300)
reg = telemetry.get_registry()
touched = set()
for fam in reg._families.values():
    for labels, child in fam._items():
        if labels:
            touched.add(fam.name)
        elif fam.kind == "histogram":
            if child.state()[3]:
                touched.add(fam.name)
        elif child.value:
            touched.add(fam.name)
print(json.dumps(sorted(touched)))
'''


def _drive(pkg: str):
    code = f"TINY = {TINY!r}\n" + DRIVE
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, pkg], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_series_names_match_reference_after_fleet_drive():
    pytest.importorskip("jax")
    prefixes = ("fleet_", "generation_server_", "kv_")
    want = {n for n in _drive("deeplearning4j_tpu")
            if n.startswith(prefixes)}
    got = {n for n in _drive("deeplearning4j_torch")
           if n.startswith(prefixes)}
    assert {"kv_handoff_blocks_total", "kv_handoff_bytes_total",
            "kv_tier_spills_total", "kv_tier_fetches_total",
            "fleet_requests_total", "fleet_replica_dispatch_total",
            "generation_server_ttft_seconds"} <= got
    assert got == want, (sorted(got - want), sorted(want - got))
