"""The port's elastic checkpoint re-layout, survivor rendezvous and fleet
coordination, held to the passing cases of ``tests/test_elastic.py`` and
to ``tests/test_resilience.py``'s fleet cases.

The core invariant: re-laying a checkpoint from a pipeline trainer onto
a plain one (or onto another stage count) is a PURE restack — per-layer
leaves byte-equal — and the world-agnostic counters restore identically.
The port also holds the restore matrix the JAX package's own
``test_pipeline_checkpoint_restores_at_every_world`` pins (that test
fails in the JAX package), and a pipeline run preempted and resumed at
``data=1`` equals the uninterrupted run."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch import resilience  # noqa: E402
from deeplearning4j_torch.data.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.data.iterator import (  # noqa: E402
    ListDataSetIterator)
from deeplearning4j_torch.parallel import elastic  # noqa: E402
from deeplearning4j_torch.parallel.checkpoint import (  # noqa: E402
    CheckpointListener)
from deeplearning4j_torch.parallel.mesh import MeshConfig  # noqa: E402
from deeplearning4j_torch.parallel.trainer import ShardedTrainer  # noqa
from deeplearning4j_torch.resilience import (  # noqa: E402
    ElasticWorldError, FaultInjector, FleetResumeExhausted,
    TrainingPreempted, fleet_resume_fit, survivor_rendezvous)
from deeplearning4j_torch.utils.trees import iter_leaves  # noqa: E402

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    resilience.clear_preemption()
    yield
    resilience.clear_preemption()
    torch.set_num_threads(n)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).tobytes()


def _assert_bytes_equal(a_tree, b_tree):
    la, lb = list(iter_leaves(a_tree)), list(iter_leaves(b_tree))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (pa, a), (_, b) in zip(la, lb):
        assert _bytes(a) == _bytes(b), pa


# -- layout transforms: pure host-side restack math -------------------------
def _layer_tree(n_layers, rng, extra=()):
    t = {f"layer_{i}": {"W": rng.normal(size=(3, 4)).astype(np.float32),
                        "b": rng.normal(size=(4,)).astype(np.float32)}
         for i in range(n_layers)}
    for k, v in extra:
        t[k] = v
    return t


@pytest.mark.parametrize("as_tensor", [False, True])
def test_stack_unstack_roundtrip_byte_equal(as_tensor):
    """stack_layers/unstack_pipe are inverse bijections for every (lo, hi)
    run, over numpy leaves and over tensors."""
    rng = np.random.default_rng(0)
    tree = _layer_tree(6, rng)
    if as_tensor:
        tree = {k: {n: torch.as_tensor(a) for n, a in v.items()}
                for k, v in tree.items()}
    for lo, hi in ((1, 5), (0, 6), (2, 4)):
        pipe = elastic.stack_layers(tree, lo, hi)
        assert elastic.is_pipe_layout(pipe)
        assert elastic.pipe_run(pipe) == (lo, hi)
        _assert_bytes_equal(tree, elastic.unstack_pipe(pipe))
    with pytest.raises(ValueError, match="does not cover"):
        elastic.stack_layers(_layer_tree(3, rng), 1, 5)
    bad = elastic.stack_layers(tree, 1, 5)
    bad["pre"] = {"embedding": bad["pre"]["layer_0"]}
    with pytest.raises(ValueError, match="non-layer keys"):
        elastic.pipe_run(bad)


def test_opt_layout_conversion_roundtrip():
    rng = np.random.default_rng(1)
    plain = {"m": _layer_tree(4, rng), "v": _layer_tree(4, rng)}
    pipe_like = {"m": elastic.stack_layers(plain["m"], 1, 3),
                 "v": elastic.stack_layers(plain["v"], 1, 3)}
    assert elastic.opt_layout(plain) == "layers"
    assert elastic.opt_layout(pipe_like) == "pipe"
    assert elastic.find_pipe_run(pipe_like) == (1, 3)
    stacked = elastic.convert_opt_layout(plain, pipe_like)
    assert elastic.opt_layout(stacked) == "pipe"
    _assert_bytes_equal(plain, elastic.convert_opt_layout(stacked, plain))
    assert elastic.convert_opt_layout(plain, plain) is None
    assert elastic.convert_opt_layout({}, plain) is None
    graphish = {"m": {"vertex_a": np.zeros(2)}}
    assert elastic.opt_layout(graphish) is None
    assert elastic.convert_opt_layout(graphish, pipe_like) is None


def test_elastic_helpers_match_jax():
    """The same trees through both packages' transforms."""
    from deeplearning4j_tpu.parallel import elastic as jel
    rng = np.random.default_rng(2)
    plain = {"m": _layer_tree(5, rng), "v": _layer_tree(5, rng)}
    for mod in (elastic, jel):
        assert mod.opt_layout(plain) == "layers"
    mine = elastic.layers_to_pipe(plain, 1, 4)
    theirs = jel.layers_to_pipe(plain, 1, 4)
    _assert_bytes_equal(mine, {k: {p: {n: np.asarray(a) for n, a in
                                        q.items()} if p == "blocks" else q
                                   for p, q in v.items()}
                               for k, v in theirs.items()})
    assert elastic.find_pipe_run(mine) == jel.find_pipe_run(theirs)


# -- restore matrix: one pipeline checkpoint restored at M in {1, 2, 4} ----
def _gpt():
    from deeplearning4j_torch.zoo import Gpt
    return Gpt(vocab_size=24, max_len=8, d_model=8, n_layers=4, n_heads=2,
               d_ff=16, seq_len=8, compute_dtype=None, use_flash=False,
               seed=9).init_graph(device="cpu")


def _data():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 24, (32, 8)).astype(np.int32)
    return ListDataSetIterator(DataSet(x, np.roll(x, -1, axis=1))
                               .batch_by(8))


def test_pipeline_checkpoint_restores_at_every_world(tmp_path):
    """ONE pipeline=2 run's checkpoint (pipe-layout optimizer state,
    recorded world 2) restores onto data=1, pipeline=2 and pipeline=4
    trainers: per-layer params byte-equal across every world, the
    counters and the RNG position identical, the plain restore's
    optimizer state the byte-exact unstack of the pipe one; a lost
    sidecar still restores (the layout is read off the array paths)."""
    m = _gpt()
    ck = CheckpointListener(tmp_path / "ck", save_every_n_iterations=2,
                            async_save=False, world=2)
    m.set_listeners(ck)
    tr = ShardedTrainer(m, MeshConfig(pipeline=2), devices=CPU8, n_micro=2)
    tr.fit(_data(), n_epochs=1)
    meta = ck.ckpt.world_at(ck.ckpt.all_steps()[-1])
    assert meta["world"] == 2 and meta["opt_layout"] == "pipe"
    assert meta["pipe_run"] == [1, 5]

    restored = {}
    for world, mesh_conf in ((1, MeshConfig(data=1)),
                             (2, MeshConfig(pipeline=2)),
                             (4, MeshConfig(pipeline=4))):
        mm = _gpt()
        # the model's sync hook holds its trainer weakly: keep it alive
        trr = ShardedTrainer(mm, mesh_conf, devices=CPU8, n_micro=2)
        cc = CheckpointListener(tmp_path / "ck", world=world)
        mm.set_listeners(cc)
        assert cc.restore_into(mm) == 2
        restored[world] = mm, trr
    restored = {w: mm for w, (mm, _) in restored.items()}
    ref = restored[2]
    for world in (1, 4):
        mm = restored[world]
        _assert_bytes_equal(ref.params_tree, mm.params_tree)
        assert (mm.iteration_count, mm.epoch_count, mm.batch_in_epoch) \
            == (ref.iteration_count, ref.epoch_count, ref.batch_in_epoch)
        assert mm._rng.state() == ref._rng.state()
    _assert_bytes_equal(elastic.pipe_to_layers(ref.opt_state),
                        restored[1].opt_state)

    for side in (tmp_path / "ck").glob("world_*.json"):
        side.unlink()
    mm = _gpt()
    trr = ShardedTrainer(mm, MeshConfig(data=1), devices=CPU8)
    cc = CheckpointListener(tmp_path / "ck", world=1)
    mm.set_listeners(cc)
    assert cc.ckpt.world_at(2) is None
    assert cc.restore_into(mm) == 2
    _assert_bytes_equal(ref.params_tree, mm.params_tree)
    del trr


def test_pipeline_preempted_resumes_at_data1_equal_to_uninterrupted(
        tmp_path):
    """A pipeline=2 run preempted mid-fit resumes on a PLAIN trainer
    (the elastic restore re-lays the pipe optimizer state per layer) and
    ends where the uninterrupted pipeline run ends: losses rtol 1e-5,
    params atol 1e-4 (the microbatched pipeline and the whole batch sum
    in other orders) — the key-bias third of ``bqkv``, whose gradient is
    analytically zero, at 2e-3: Adam turns its rounding noise into steps
    of ~lr either way (the repo's parity-test rule)."""
    ref = _gpt()
    ref_loss = ShardedTrainer(ref, MeshConfig(pipeline=2), devices=CPU8,
                              n_micro=2).fit(_data(), n_epochs=2)

    m = _gpt()
    tr = ShardedTrainer(m, MeshConfig(pipeline=2), devices=CPU8, n_micro=2)
    ck = CheckpointListener(tmp_path / "ck", save_every_n_iterations=2)
    m.set_listeners(ck)
    with pytest.raises(TrainingPreempted):
        with FaultInjector(["preempt@3"]):
            tr.fit(_data(), n_epochs=2)
    resilience.clear_preemption()
    ck.ckpt.close()

    m2 = _gpt()
    tr2 = ShardedTrainer(m2, MeshConfig(data=1), devices=CPU8)
    m2.set_listeners(CheckpointListener(tmp_path / "ck"))
    loss2 = tr2.fit(_data(), n_epochs=2, resume=True)
    assert m2.iteration_count == ref.iteration_count == 8
    np.testing.assert_allclose(loss2, ref_loss, rtol=1e-5)
    for (p, a), (_, b) in zip(iter_leaves(ref.params_tree),
                              iter_leaves(m2.params_tree)):
        a, b = a.numpy(), b.numpy()
        if p[-1] == "bqkv":
            d = a.shape[-1] // 3
            np.testing.assert_allclose(a[d:2 * d], b[d:2 * d], atol=2e-3)
            a, b = np.delete(a, np.s_[d:2 * d]), np.delete(b, np.s_[d:2 * d])
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=str(p))


@pytest.mark.slow  # the reference's own mark (3 pipeline compiles there)
def test_pipeline_trainer_kill_and_resume_bit_identical(tmp_path):
    """Preempt a pipeline=2 fit, restore into a FRESH pipeline trainer
    (fit(resume=True) restacks params + pipe optimizer state + counters):
    final loss and params bit-identical to the uninterrupted run."""
    from deeplearning4j_torch.zoo import Gpt

    def mk():
        return Gpt(vocab_size=48, max_len=12, d_model=16, n_layers=2,
                   n_heads=2, d_ff=32, seq_len=12, compute_dtype=None,
                   use_flash=False, seed=5).init_graph(device="cpu")

    rng = np.random.default_rng(1)
    x = rng.integers(0, 48, (24, 12)).astype(np.int32)
    y = np.roll(x, -1, axis=1)

    def it():
        return ListDataSetIterator(DataSet(x, y).batch_by(8))

    ref = mk()
    tr_ref = ShardedTrainer(ref, MeshConfig(pipeline=2), devices=CPU8,
                            n_micro=2)
    ref_loss = tr_ref.fit(it(), n_epochs=2)
    m = mk()
    tr = ShardedTrainer(m, MeshConfig(pipeline=2), devices=CPU8, n_micro=2)
    ck = CheckpointListener(tmp_path / "ck", save_every_n_iterations=2)
    m.set_listeners(ck)
    with pytest.raises(TrainingPreempted):
        with FaultInjector(["preempt@3"]):
            tr.fit(it(), n_epochs=2)
    resilience.clear_preemption()
    m2 = mk()
    tr2 = ShardedTrainer(m2, MeshConfig(pipeline=2), devices=CPU8,
                         n_micro=2)
    ck2 = CheckpointListener(tmp_path / "ck")
    m2.set_listeners(ck2)
    loss2 = tr2.fit(it(), n_epochs=2, resume=True)
    assert m2.iteration_count == ref.iteration_count == 6
    assert float(loss2) == float(ref_loss)
    _assert_bytes_equal(ref.params_tree, m2.params_tree)
    ck.ckpt.close()
    ck2.ckpt.close()


def test_global_batch_indivisible_raises_typed():
    """A world whose data axis cannot divide the GLOBAL batch fails with
    ElasticWorldError at sharding time."""
    from torch_model_util import conf_ns
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    P_ = conf_ns("deeplearning4j_torch")
    conf = (P_.NeuralNetConfiguration.builder().seed(3).list()
            .layer(P_.DenseLayer(n_in=4, n_out=4, activation="tanh"))
            .layer(P_.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .build())
    tr = ShardedTrainer(MultiLayerNetwork(conf).init(device="cpu"),
                        MeshConfig(data=2), devices=CPU8)
    with pytest.raises(ElasticWorldError, match="does not divide"):
        tr._shard_batch({"features": np.zeros((3, 4), np.float32)})
    out = tr._shard_batch({"features": np.zeros((4, 4), np.float32)})
    assert [tuple(b["features"].shape) for b in out] == [(2, 4), (2, 4)]


# -- survivor-quorum rendezvous + typed exhaustion (pure host) --------------
def test_survivor_rendezvous_quorum_and_grace(tmp_path):
    res = {}

    def join(h):
        res[h] = survivor_rendezvous(tmp_path, host_id=h, grace_s=0.5,
                                     expected=2)

    ts = [threading.Thread(target=join, args=(h,))
          for h in ("beta", "alpha")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert res["alpha"].world == res["beta"].world == 2
    assert res["alpha"].hosts == res["beta"].hosts == ("alpha", "beta")
    assert res["alpha"].rank == 0 and res["beta"].rank == 1
    w = survivor_rendezvous(tmp_path, host_id="alpha", grace_s=0.2,
                            expected=2, epoch=1)
    assert w == (1, 0, ("alpha",))
    with pytest.raises(ValueError, match="plain name"):
        survivor_rendezvous(tmp_path, host_id="a/b")


def test_survivor_rendezvous_commit_prevents_split_brain(tmp_path):
    import os
    w = survivor_rendezvous(tmp_path, host_id="early", grace_s=0.1,
                            expected=1)
    assert w == (1, 0, ("early",))
    with pytest.raises(ElasticWorldError, match="froze.*without"):
        survivor_rendezvous(tmp_path, host_id="late", grace_s=5.0,
                            expected=1)
    world_path = tmp_path / "_rendezvous" / "0" / "world.json"
    old = world_path.stat().st_mtime - 3600
    os.utime(world_path, (old, old))
    os.utime(tmp_path / "_rendezvous" / "0" / "early.json", (old, old))
    w2 = survivor_rendezvous(tmp_path, host_id="round2", grace_s=0.2,
                             expected=1)
    assert w2 == (1, 0, ("round2",))
    assert (tmp_path / "_rendezvous" / "1" / "world.json").exists()


def test_fleet_resume_exhausted_typed():
    calls = []

    def fit_fn():
        calls.append(1)
        raise TrainingPreempted(5)

    with pytest.raises(FleetResumeExhausted) as ei:
        fleet_resume_fit(fit_fn, max_restarts=2, world=3)
    assert ei.value.step == 5 and ei.value.world == 3
    assert isinstance(ei.value.__cause__, TrainingPreempted)
    assert len(calls) == 3


# -- fleet coordination, one process (tests/test_resilience.py) -------------
def _mlp(seed=3):
    from torch_model_util import conf_ns
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    P_ = conf_ns("deeplearning4j_torch")
    conf = (P_.NeuralNetConfiguration.builder().seed(seed)
            .updater(P_.Adam(learning_rate=1e-2)).list()
            .layer(P_.DenseLayer(n_in=8, n_out=16, activation="relu"))
            .layer(P_.OutputLayer(n_out=4, activation="softmax",
                                  loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _xy(n=96, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 8)).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)])


def test_fleet_coordinator_propagates_flag_and_counts():
    from deeplearning4j_torch.resilience import preemption
    from deeplearning4j_torch.resilience.coordination import (
        FLEET_BROADCASTS, FleetCoordinator)
    c = FleetCoordinator()
    assert c.rendezvous() == 1
    b0 = FLEET_BROADCASTS.value
    assert c.poll(False) is False
    assert FLEET_BROADCASTS.value == b0
    with c:
        assert preemption.poll_preemption() is False
        resilience.request_preemption()
        assert preemption.poll_preemption() is True
    assert FLEET_BROADCASTS.value - b0 == 1
    assert resilience.preemption_requested()
    mesh = MeshConfig(data=4).build(CPU8)
    assert FleetCoordinator(mesh).rendezvous() == 4


def test_fleet_agreement_discards_uncommon_steps(tmp_path, monkeypatch):
    from deeplearning4j_torch.parallel import distributed
    from deeplearning4j_torch.resilience.coordination import (
        FLEET_RESUMES, FleetCoordinator)
    m = _mlp()
    ck = CheckpointListener(tmp_path / "ck", save_every_n_iterations=1,
                            keep_last=5)
    m.set_listeners(ck)
    x, y = _xy(16)
    for _ in range(5):
        m.fit(DataSet(x, y))
    ck.ckpt.wait()
    steps = ck.ckpt.all_steps()
    assert 2 in steps and max(steps) > 2
    monkeypatch.setattr(distributed, "min_reduce",
                        lambda value, mesh=None: 2)
    resumed = FLEET_RESUMES.labels(outcome="resumed")
    r0 = resumed.value
    assert FleetCoordinator().agree_resume_step(ck) == 2
    assert max(ck.ckpt.all_steps()) == 2
    assert resumed.value - r0 == 1
    step, _ = ck.ckpt.restore_latest(ck._state(m))
    assert step == 2


def test_fleet_resume_fit_preempt_bit_identical(tmp_path):
    """fleet_resume_fit in the one-process degenerate, around a sharded
    (data=2) fit: the rendezvous, agreement and coordinated poll wrap a
    preempted fit, and the completion is bit-identical to the
    uninterrupted sharded run."""
    from deeplearning4j_torch import telemetry
    x, y = _xy()

    def it():
        return ListDataSetIterator(DataSet(x, y).batch_by(16))

    ref = _mlp()
    ref_loss = ShardedTrainer(ref, MeshConfig(data=2),
                              devices=CPU8).fit(it(), n_epochs=3)
    m = _mlp()
    tr = ShardedTrainer(m, MeshConfig(data=2), devices=CPU8)
    ck = CheckpointListener(tmp_path / "ck", save_every_n_iterations=5)
    m.set_listeners(ck)
    resumes = telemetry.get_registry().counter(
        "fleet_resumes_total", labelnames=("outcome",)).labels(
            outcome="resumed")
    r0 = resumes.value
    with FaultInjector(["preempt@8"]):
        loss = fleet_resume_fit(
            lambda: tr.fit(it(), n_epochs=3, resume=True),
            mesh=tr.mesh, checkpoint=ck)
    ck.ckpt.close()
    assert float(loss) == float(ref_loss)
    assert resumes.value - r0 >= 1
    _assert_bytes_equal(ref.params_tree, m.params_tree)
