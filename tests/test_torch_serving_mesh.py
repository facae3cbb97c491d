"""The port's mesh-sharded decode tick, held to
``tests/test_serving_mesh.py``: a tp = 2 replica over ``[cpu] * 2``
serves cold admissions, prefix hits and speculative rounds with streams
equal to offline ``generate()``, to a tp = 1 server and to the JAX
package's tp = 2 server — up to near ties (``torch_serving_util``): a
column slice of a CPU matmul need not carry the full product's bits.
Every tp shard runs the paged attention on ITS heads (the kernels on the
card), with the split-K chunk of the replica's unsharded shape."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_serving_util import (TINY, assert_stream,  # noqa: E402
                                offline_ref, tiny_net)

from deeplearning4j_torch.kernels import paged_attention as pa  # noqa
from deeplearning4j_torch.models import generation as G  # noqa: E402
from deeplearning4j_torch.models.generation import (  # noqa: E402
    TransformerGenerator)
from deeplearning4j_torch.parallel import GenerationServer  # noqa: E402
from deeplearning4j_torch.parallel.mesh import (TpShardCtx,  # noqa: E402
                                                serving_mesh)
from deeplearning4j_torch.parallel.speculative import (  # noqa: E402
    make_self_draft)
from deeplearning4j_torch.serving import ServingFleet  # noqa: E402

CPU = torch.device("cpu")
CPU2 = [CPU, CPU]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu "
                    "tests/test_torch_*.py on the card)")


@pytest.fixture(scope="module")
def net():
    return tiny_net()


@pytest.fixture(scope="module")
def offline(net):
    return TransformerGenerator(net, device="cpu")


@pytest.fixture
def head_counts(monkeypatch):
    """Records the head count of every paged attention call the tick
    makes, and whether it came as one shard of a tp = 2 replica: its
    split-K chunk chosen for the replica's slots and ALL its heads
    (``data`` rows of this call's slots)."""
    seen = []
    for name in ("paged_decode_attention", "paged_verify_attention"):
        real = getattr(G, name)

        def spy(q, *a, _real=real, _name=name, **kw):
            rows = kw.get("split_rows")
            seen.append((_name, q.shape[-2], rows is not None and
                         rows[1] == 2 * q.shape[-2] and
                         rows[0] % q.shape[0] == 0, rows and
                         rows[0] // q.shape[0]))
            return _real(q, *a, **kw)
        monkeypatch.setattr(G, name, spy)
    return seen


def _run_server(net, reqs, **kw):
    with GenerationServer(net, n_slots=2, max_len=32, device="cpu",
                          **kw) as srv:
        handles = [srv.submit_async(p, n) for p, n in reqs]
        outs = [h.result(timeout=300) for h in handles]
        st = srv.stats()
    return outs, st


def test_tp2_parity_miss_hit_and_heads(net, offline, head_counts):
    """A tp = 2 replica serves cold admissions AND a repeated-prompt
    prefix hit, every stream equal to offline decode; every attention
    call of the tick runs on 2 of the 4 heads with the shard ctx; the
    stats report the slice."""
    from deeplearning4j_torch import telemetry
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 50, t0).astype(np.int32), n)
            for t0, n in [(3, 6), (5, 9), (7, 3)]]
    hits = telemetry.get_registry().counter("prefix_cache_hits_total")
    h0 = hits.value
    with GenerationServer(net, n_slots=2, max_len=32, block_size=4,
                          devices=CPU2) as srv:
        outs = [h.result(timeout=300) for h in
                [srv.submit_async(p, n) for p, n in reqs]]
        rep = srv.submit(reqs[1][0], 4, timeout=300)
        st = srv.stats()
    gen = TransformerGenerator(net, device="cpu")
    for out, (p, n) in zip(outs, reqs):
        assert_stream(gen, out, offline_ref(offline, p, n))
    assert_stream(gen, rep, offline_ref(offline, reqs[1][0], 4))
    assert hits.value - h0 >= 1
    assert st["tp"] == 2 and st["devices"] == ["cpu:0", "cpu:0"]
    decode = [c for c in head_counts if c[0] == "paged_decode_attention"]
    assert decode and all(h == 2 and sharded and data == 1
                          for _, h, sharded, data in decode)


def test_tp2_speculative_parity(net, offline, head_counts):
    """Speculative decode under tp = 2: draft, verify and acceptance run
    through the sharded bodies; a full-depth self-draft accepts (>= 0.9,
    the port's near-tie rule) and the stream equals offline decode."""
    from deeplearning4j_torch import telemetry
    prompt = np.asarray([2, 7, 1, 8, 2, 8], np.int32)
    prop = telemetry.get_registry().counter(
        "generation_server_spec_proposed_total")
    p0 = prop.value
    outs, st = _run_server(net, [(prompt, 8)], devices=CPU2,
                           speculative={"k": 2, "rounds": 2,
                                        "draft_layers": 2})
    assert_stream(TransformerGenerator(net, device="cpu"), outs[0],
                  offline_ref(offline, prompt, 8))
    assert prop.value - p0 >= 1
    assert st["spec_acceptance_rate"] >= 0.9
    assert st["tp"] == 2
    verify = [c for c in head_counts if c[0] == "paged_verify_attention"]
    assert verify and all(h == 2 and sharded and data == 1
                          for _, h, sharded, data in verify)


def test_tp2_streams_equal_tp1_and_jax_tp2(net):
    """The same trace through a tp = 1 and a tp = 2 port server and the
    JAX package's tp = 2 server (on 2 of its 8 virtual devices, the
    port's weights carried over): the streams agree up to near ties."""
    import jax
    from deeplearning4j_tpu.models.multi_layer_network import (
        MultiLayerNetwork as JMLN)
    from deeplearning4j_tpu.parallel import (GenerationServer as
                                             JServer)
    from deeplearning4j_tpu.zoo.gpt import Gpt as JGpt
    from torch_model_util import jax_from_port
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, 50, t0).astype(np.int32), n)
            for t0, n in [(4, 7), (9, 5)]]
    one, _ = _run_server(net, reqs, block_size=4)
    two, _ = _run_server(net, reqs, block_size=4, devices=CPU2)
    jnet = jax_from_port(JMLN(JGpt(**TINY).conf()), net)
    jnet.params_tree = jax.tree_util.tree_map(np.array, jnet.params_tree)
    with JServer(jnet, n_slots=2, max_len=32, block_size=4,
                 devices=jax.devices()[:2]) as srv:
        jx = [h.result(timeout=300) for h in
              [srv.submit_async(p, n) for p, n in reqs]]
    gen = TransformerGenerator(net, device="cpu")
    for a, b, c in zip(one, two, jx):
        assert_stream(gen, b, a)
        assert_stream(gen, b, np.asarray(c))


def test_data2_tp2_streams_equal_tp1_and_jax(net, head_counts):
    """A data = 2 x tp = 2 replica over ``[cpu] * 4``: each data row
    decodes its half of the slots on its own tp pair (K1 on 2 of the 4
    heads, the chunk of the replica's 4 slots and 4 heads) with its own
    pool replica, and every pool write reaches both replicas; each row's
    per-slot state lives on the row's device and its tick reads it in
    place; cold admissions and a prefix hit stream as a tp = 1 server's
    and as the JAX package's server on 4 of its virtual devices at tp =
    2, up to near ties."""
    import jax
    from deeplearning4j_tpu.models.multi_layer_network import (
        MultiLayerNetwork as JMLN)
    from deeplearning4j_tpu.parallel import (GenerationServer as
                                             JServer)
    from deeplearning4j_tpu.zoo.gpt import Gpt as JGpt
    from torch_model_util import jax_from_port
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, 50, t0).astype(np.int32), n)
            for t0, n in [(4, 7), (9, 5), (3, 9), (6, 4), (9, 6)]]
    reqs[4] = (reqs[1][0], 6)                   # a prefix hit

    def serve(srv):
        outs = [h.result(timeout=300) for h in
                [srv.submit_async(p, n) for p, n in reqs[:4]]]
        return outs + [srv.submit(*reqs[4], timeout=300)]

    kw = dict(n_slots=4, max_len=32, block_size=4)
    with GenerationServer(net, device="cpu", **kw) as srv:
        one = serve(srv)
    del head_counts[:]
    with GenerationServer(net, devices=[CPU] * 4, tp=2, **kw) as srv:
        seen = []
        inner = srv._row_step

        def row_step(step, params_rows, kc, vc, r=0):
            fn = inner(step, params_rows, kc, vc, r)

            def spy(*rows):
                # the block table a row's step reads: its own [2, mb]
                # tensor, not a view into a [4, mb] one
                tbl = rows[2]
                seen.append((r, tbl.shape[0], tbl.untyped_storage()
                             .nbytes() // tbl.element_size()
                             // tbl.shape[1]))
                return fn(*rows)
            return spy
        srv._row_step = row_step
        four = serve(srv)
        st = srv.stats()
        kc = srv._kc
        state = srv._state
        row_devs = [ctx.devices[0] for ctx in srv._rows]
    # the per-slot state lives per data row on that row's device, and
    # each row's tick reads it in place (no per-tick row copy)
    assert len(state.rows) == 2
    for r, row in enumerate(state.rows):
        for key, t in row.items():
            assert t.shape[0] == 2 and t.device == row_devs[r], key
    assert {r for r, _, _ in seen} == {0, 1}
    assert all(n == 2 and rows == 2 for _, n, rows in seen)
    assert st["tp"] == 2 and st["devices"] == ["cpu:0"] * 4
    assert st["prefix_hits"] >= 1
    assert len(kc.replicas) == 2 and all(len(r) == 2 for r in kc.replicas)
    assert len({t.data_ptr() for r in kc.replicas for t in r}) == 4
    for a, b in zip(*kc.replicas):
        assert torch.equal(a, b)
    decode = [c for c in head_counts if c[0] == "paged_decode_attention"]
    assert decode and all(h == 2 and sharded and data == 2
                          for _, h, sharded, data in decode)
    jnet = jax_from_port(JMLN(JGpt(**TINY).conf()), net)
    jnet.params_tree = jax.tree_util.tree_map(np.array, jnet.params_tree)
    with JServer(jnet, devices=jax.devices()[:4], tp=2, **kw) as srv:
        jx = serve(srv)
    gen = TransformerGenerator(net, device="cpu")
    for a, b, c in zip(one, four, jx):
        assert_stream(gen, b, a)
        assert_stream(gen, b, np.asarray(c))


def test_sharded_pool_reports_global_blocks(net):
    """The pool splits its HEAD axis only — the block axis and the host
    allocator stay global, so the free-KV view is the whole replica's;
    each shard holds its half of the heads in storage of its own."""
    with GenerationServer(net, n_slots=2, max_len=32, block_size=4,
                          device="cpu") as plain:
        with GenerationServer(net, n_slots=2, max_len=32, block_size=4,
                              devices=CPU2) as sharded:
            assert sharded.stats()["free_blocks"] \
                == plain.stats()["free_blocks"] > 0
            kc = sharded._kc
            assert tuple(kc.shape) == tuple(plain._kc.shape)
            assert [t.shape[2] for t in kc.shards] == [2, 2]
            assert kc.shards[0].data_ptr() != kc.shards[1].data_ptr()


def test_sharded_params_split_output_columns(net):
    """The placed snapshot: shard c's q|k|v columns are its heads' columns
    of each third; Wo/W1/W2 and the head split by output columns, the
    embedding by vocab rows; the gathered weights equal the originals."""
    with GenerationServer(net, n_slots=2, max_len=32,
                          devices=CPU2) as srv:
        emb_p, blk_ps, head_p = srv._params
        full = srv._gen._serving_params()[1][0]
    p = blk_ps[0]
    d = full["Wqkv"].shape[0]
    q, k, v = torch.chunk(full["Wqkv"], 3, dim=-1)
    for c in range(2):
        want = torch.cat([z[:, c * d // 2:(c + 1) * d // 2]
                          for z in (q, k, v)], dim=-1)
        assert torch.equal(p["Wqkv"][c], want)
    for key in ("Wo", "W1", "W2"):
        assert p[key].kind == "col"
        assert torch.equal(p[key].full(), full[key])
    assert emb_p["W"].kind == "row" and head_p["W"].kind == "col"


def test_geometry_validation_is_pinned(net):
    """Bad mesh geometry fails at CONSTRUCTION with a named reason."""
    with pytest.raises(ValueError, match="n_heads=4 must divide"):
        GenerationServer(net, n_slots=2, max_len=32, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="n_slots=3 must divide"):
        GenerationServer(net, n_slots=3, max_len=32, devices=[CPU] * 4,
                         tp=2)
    with pytest.raises(ValueError, match="tp=2 must divide"):
        serving_mesh([CPU] * 3, tp=2)
    with pytest.raises(ValueError, match="at least one device"):
        serving_mesh([])
    draft = make_self_draft(TransformerGenerator(net, device="cpu"))
    draft.check_tp(2)
    with pytest.raises(ValueError, match="draft n_heads=4"):
        draft.check_tp(3)


def test_fleet_device_slice_validation(net):
    """Per-replica slices must be disjoint (one device in two replicas
    double-books its memory) and one per replica; one slice may list a
    device twice (one card driven as two tp shards)."""
    d = [torch.device("cuda", i) for i in range(3)]
    with pytest.raises(ValueError, match="slices must be disjoint"):
        ServingFleet(net, n_replicas=2, n_slots=2, max_len=32,
                     devices=[[d[0]], d[:2]])
    with pytest.raises(ValueError, match="devices has 1 slices"):
        ServingFleet(net, n_replicas=2, n_slots=2, max_len=32,
                     devices=[d[:2]])
    with ServingFleet(net, n_replicas=1, n_slots=2, max_len=32,
                      devices=[CPU2]) as fleet:
        assert fleet.stats()["replicas"][0]["tp"] == 2


@pytest.mark.parametrize("B,h,tp,cap", [(8, 6, 2, 1024), (8, 12, 3, 512),
                                        (2, 4, 2, 32), (16, 8, 4, 4096)])
def test_shard_split_chunk_equals_unsharded(B, h, tp, cap):
    """A shard's K1/K2 split-K chunk is the replica's unsharded one, so
    each (slot, head) sums its splits in tp = 1's order; with no shard the
    choice is the one it always was."""
    bs = 16
    ctx = TpShardCtx(serving_mesh([CPU] * tp))
    pool = torch.zeros((4, h // tp, bs, 8))
    table = torch.zeros((B, cap // bs), dtype=torch.int32)
    q = torch.zeros((B, h // tp, 8))
    # what a shard of the tick passes: the replica's slots and heads
    rows = (B * ctx.data, q.shape[-2] * ctx.tp)
    assert pa.decode_chunk(q, pool, table, rows) == \
        pa.decode_split_rows(B, h, cap)
    assert pa.decode_chunk(torch.zeros((B, h, 8)), pool, table) == \
        pa.decode_split_rows(B, h, cap)
    for W in (2, 5, 17):
        qv = torch.zeros((B, W, h // tp, 8))
        assert pa.verify_chunk(qv, pool, table, rows) == \
            pa.verify_split_rows(B, W, h, cap)
        assert pa.verify_chunk(torch.zeros((B, W, h, 8)), pool, table) == \
            pa.verify_split_rows(B, W, h, cap)


@pytest.mark.slow
def test_single_device_slice_pins_without_tp(net, offline):
    """A one-device slice pins the replica to that device and keeps the
    unsharded tick."""
    prompt = np.asarray([5, 9, 2, 7], np.int32)
    outs, st = _run_server(net, [(prompt, 6)], devices=[CPU])
    assert_stream(TransformerGenerator(net, device="cpu"), outs[0],
                  offline_ref(offline, prompt, 6))
    assert st["tp"] == 1 and st["devices"] == ["cpu:0"]


@pytest.mark.slow
@pytest.mark.parametrize("tick_batch", [1, 8])
@pytest.mark.parametrize("spec", [None, {"k": 2, "rounds": 2,
                                         "draft_layers": 2}])
def test_tp2_matrix(net, offline, tick_batch, spec):
    """tp = 2 x tick_batch in {1, 8} x prefix hit+miss x speculative
    on/off, each stream equal to offline decode and to the tp = 1
    server's, up to near ties."""
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, 50, t0).astype(np.int32), n)
            for t0, n in [(3, 6), (6, 8)]]
    kw = dict(tick_batch=tick_batch, block_size=4)
    if spec is not None:
        kw["speculative"] = spec

    def run(**extra):
        with GenerationServer(net, n_slots=2, max_len=32, device="cpu",
                              **kw, **extra) as srv:
            outs = [h.result(timeout=300) for h in
                    [srv.submit_async(p, n) for p, n in reqs]]
            outs.append(srv.submit(reqs[1][0], 5, timeout=300))
            st = srv.stats()
        return outs, st

    base, _ = run()
    sharded, st = run(devices=CPU2)
    assert st["tp"] == 2
    gen = TransformerGenerator(net, device="cpu")
    for (p, n), one, two in zip(list(reqs) + [(reqs[1][0], 5)], base,
                                sharded):
        assert_stream(gen, one, offline_ref(offline, p, n))
        assert_stream(gen, two, offline_ref(offline, p, n))


@pytest.mark.slow
def test_mixed_fleet_parity_and_gauge(net, offline):
    """ONE fleet mixes a single-device replica and a tp = 2 replica:
    every request decodes equal to offline, per-replica stats carry the
    slice, the scrape exposes ``fleet_replica_devices{replica=}``."""
    from deeplearning4j_torch import telemetry
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, 50, t0).astype(np.int32), n)
            for t0, n in [(3, 6), (5, 9), (7, 3)]]
    gen = TransformerGenerator(net, device="cpu")
    with ServingFleet(net, n_replicas=2, n_slots=2, max_len=32,
                      device="cpu", devices=[None, CPU2]) as fleet:
        hs = [fleet.submit_async(p, n) for p, n in reqs]
        for (p, n), h in zip(reqs, hs):
            assert_stream(gen, h.result(timeout=300),
                          offline_ref(offline, p, n))
        st = fleet.stats()
        assert [r["tp"] for r in st["replicas"]] == [1, 2]
        body = telemetry.get_registry().render_prometheus()
    assert 'fleet_replica_devices{replica="1"} 2.0' in body


@pytest.mark.gpu
def test_cuda_tp2_tick_launches_k1_k2_per_shard():
    """On the card a tp = 2 replica launches the decode kernel (and the
    verify kernel when speculative) once per layer, shard and tick/round,
    each on h/tp heads — never the plain version."""
    _cuda_or_skip()
    from deeplearning4j_torch.zoo import Gpt
    gpu_net = Gpt(**TINY).init_graph(device="cuda")
    dev = torch.device("cuda")
    seen = []
    real = G.paged_decode_attention

    def spy(q, *a, **kw):
        seen.append(q.shape[-2])
        return real(q, *a, **kw)
    G.paged_decode_attention = spy
    try:
        pa.paged_decode_attention.launches = 0
        pa.paged_verify_attention.launches = 0
        with GenerationServer(gpu_net, n_slots=2, max_len=32,
                              devices=[dev, dev], tick_batch=1,
                              speculative={"k": 2, "rounds": 1,
                                           "draft_layers": 1}) as srv:
            srv.submit(np.asarray([3, 1, 4], np.int32), 6, timeout=300)
        torch.cuda.synchronize()
    finally:
        G.paged_decode_attention = real
    assert seen and set(seen) == {2}
    assert pa.paged_decode_attention.launches == len(seen)
    assert pa.paged_verify_attention.launches > 0
    assert pa.paged_verify_attention.launches % (2 * 2) == 0


def test_shard_ctx_places_without_aliasing():
    """``TpShardCtx.put`` splits the named axes it can divide (and
    replicates the others), ``put_batch`` splits slots over ``data``,
    ``replicate`` copies every leaf; on a repeated device no two blocks
    share storage, and ``rep`` gathers the tp blocks in shard order."""
    ctx = TpShardCtx(serving_mesh([CPU] * 4, tp=2))
    assert (ctx.data, ctx.tp) == (2, 2)
    w = torch.arange(24.0).reshape(4, 6)
    cols = ctx.put(w, None, "tp")
    assert [tuple(b.shape) for b in cols] == [(4, 3)] * 4
    assert torch.equal(cols[1], w[:, 3:]) and torch.equal(cols[2], w[:, :3])
    odd = ctx.put(torch.ones(3, 5), None, "tp")        # 5 % 2: replicate
    assert [tuple(b.shape) for b in odd] == [(3, 5)] * 4
    rows = ctx.put_batch(w)
    assert torch.equal(rows[0], w[:2]) and torch.equal(rows[2], w[2:])
    rep = ctx.replicate({"a": {"b": w}})
    blocks = cols + odd + rows + rep["a"]["b"]
    assert len({b.data_ptr() for b in blocks}) == len(blocks)
    assert torch.equal(ctx.rep(cols[:2]), w)
    assert ctx.spec(None, "tp") == (None, "tp")
    from deeplearning4j_torch.parallel.mesh import MeshConfig
    with pytest.raises(ValueError, match="'data', 'tp'"):
        TpShardCtx(MeshConfig(data=2, model=2).build([CPU] * 4))
