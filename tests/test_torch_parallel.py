"""The port's mesh trainer, held to ``tests/test_parallel.py`` (the
reference's 8-virtual-device cases), ``tests/test_parallel_aux.py``'s
distributed helpers, ``tests/test_transformer.py``'s BERT tensor-parallel
case and ``tests/test_ema.py``'s sharded EMA.

The port runs on ``[torch.device("cpu")] * n`` — one device listed n
times, each shard with tensors of its own — and the JAX package on the
conftest's 8 virtual CPU devices.  Both start from the same weights (the
port's seeded init carried into the JAX net) and take the same batches:
the port's data-parallel losses equal its single-device losses at rtol
2e-4 (the reference's bound), and equal the JAX ``ShardedTrainer``'s."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_model_util import conf_ns, jax_from_port  # noqa: E402

from deeplearning4j_torch.data.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.data.iterator import (  # noqa: E402
    ListDataSetIterator)
from deeplearning4j_torch.parallel import (MeshConfig,  # noqa: E402
                                           ShardedTrainer)
from deeplearning4j_torch.parallel.mesh import P  # noqa: E402

CPU8 = [torch.device("cpu")] * 8


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu "
                    "tests/test_torch_*.py on the card)")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_data(n=512, din=16, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, din)).astype(np.float32)
    w = rng.normal(size=(din, classes)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[(x @ w).argmax(-1)]
    return x, y


def _layers(P_, din=16, hidden=32, classes=4, dropout=0.0):
    return [P_.DenseLayer(n_in=din, n_out=hidden, activation="relu",
                          dropout=dropout),
            P_.DenseLayer(n_out=hidden, activation="relu"),
            P_.OutputLayer(n_out=classes, activation="softmax",
                           loss="mcxent")]


def _build(package, layers_fn, seed=9, lr=1e-2, updater=None):
    P_ = conf_ns(package)
    b = (P_.NeuralNetConfiguration.builder().seed(seed)
         .updater(updater(P_) if updater else P_.Adam(learning_rate=lr))
         .list())
    for ly in layers_fn(P_):
        b.layer(ly)
    conf = b.build()
    if package == "deeplearning4j_tpu":
        from deeplearning4j_tpu import MultiLayerNetwork
    else:
        from deeplearning4j_torch.models.multi_layer_network import (
            MultiLayerNetwork)
    return MultiLayerNetwork(conf)


def _model(hidden=32, seed=9, lr=1e-2, dropout=0.0):
    return _build("deeplearning4j_torch",
                  lambda P_: _layers(P_, hidden=hidden, dropout=dropout),
                  seed=seed, lr=lr).init(device="cpu")


def _pair(hidden=32, seed=4):
    """(JAX net, port net) with the port's init on both."""
    fn = lambda P_: _layers(P_, hidden=hidden)  # noqa: E731
    import jax
    import jax.numpy as jnp
    pnet = _build("deeplearning4j_torch", fn, seed).init(device="cpu")
    jnet = jax_from_port(_build("deeplearning4j_tpu", fn, seed), pnet)
    # copies: a jax array made from a CPU tensor's numpy view may share
    # its memory, and the port's step updates its tensors in place
    jnet.params_tree = jax.tree_util.tree_map(
        lambda a: jnp.array(np.array(a)), jnet.params_tree)
    return jnet, pnet


def _host(t):
    return t.detach().float().cpu().numpy()


def test_mesh_config_builds_and_validates():
    mesh = MeshConfig(data=2, model=4).build(CPU8)
    assert mesh.shape == {"data": 2, "model": 4}
    assert mesh.size == 8
    assert MeshConfig().build(CPU8[:1]).shape == {"data": 1}
    with pytest.raises(ValueError, match="Mesh needs 16 devices"):
        MeshConfig(data=16).build(CPU8)
    assert MeshConfig(data=2, pipeline=3).total() == 6


def test_data_parallel_training_converges():
    x, y = _toy_data()
    model = _model()
    trainer = ShardedTrainer(model, MeshConfig(data=8), devices=CPU8)
    it = ListDataSetIterator(DataSet(x, y).batch_by(64))
    trainer.fit(it, n_epochs=30)
    ev = model.evaluate(it)
    assert ev.accuracy() > 0.9, ev.stats()


def test_dp_matches_single_device_and_jax():
    """5 DP steps over 8 shards == 5 single-device steps (rtol 2e-4, the
    reference's bound) == the JAX ShardedTrainer's 5 steps on the same
    weights and batch; final params within 1e-4."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel import (MeshConfig as JMesh,
                                             ShardedTrainer as JTrainer)
    x, y = _toy_data(n=256)
    single = _model(seed=4)
    single._build_solver()
    batch = single._batch_dict(DataSet(x, y))
    losses_single = []
    for i in range(5):
        (single.params_tree, single.opt_state, single.state_tree,
         loss) = single._solver.step(single.params_tree, single.opt_state,
                                     single.state_tree, i, dict(batch),
                                     single._rng.next_key())
        losses_single.append(float(loss))
    jnet, pnet = _pair(seed=4)
    trainer = ShardedTrainer(pnet, MeshConfig(data=8), devices=CPU8)
    losses_dp = [float(trainer.fit_batch(x, y)) for _ in range(5)]
    np.testing.assert_allclose(losses_dp, losses_single, rtol=2e-4)
    jtr = JTrainer(jnet, JMesh(data=8))
    losses_jax = [float(jtr.fit_batch(jnp.asarray(x), jnp.asarray(y)))
                  for _ in range(5)]
    np.testing.assert_allclose(losses_dp, losses_jax, rtol=2e-4)
    for name in ("layer_0", "layer_1", "layer_2"):
        for k in ("W", "b"):
            got = _host(pnet.params_tree[name][k])
            want = np.asarray(jnet.params_tree[name][k])
            np.testing.assert_allclose(got, want, atol=1e-4)


def test_tensor_parallel_2way_runs_and_converges():
    x, y = _toy_data()
    model = _model(hidden=64)
    trainer = ShardedTrainer(model, MeshConfig(data=4, model=2),
                             devices=CPU8)
    # hidden kernels split over the model axis
    assert trainer._param_shardings["layer_0"]["W"] == P(None, "model")
    assert trainer._param_shardings["layer_0"]["b"] == P()
    it = ListDataSetIterator(DataSet(x, y).batch_by(64))
    trainer.fit(it, n_epochs=30)
    assert model.evaluate(it).accuracy() > 0.9


def test_tp_matches_single_device_and_keeps_shards_apart():
    """DP x TP (data=2, model=4) equals one device and the JAX
    ShardedTrainer at the same mesh on the same weights and batches
    (losses at rtol 2e-4, final params within 1e-4); every shard's
    weights and optimizer state live in storage of their own, and the
    model's own tree syncs lazily (on read) to the gathered values."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel import (MeshConfig as JMesh,
                                             ShardedTrainer as JTrainer)
    x, y = _toy_data(n=64)
    ref = _model(hidden=32, seed=3)
    ref_losses = [float(ref.fit(DataSet(x, y))) for _ in range(4)]
    jnet, m = _pair(hidden=32, seed=3)
    tr = ShardedTrainer(m, MeshConfig(data=2, model=4), devices=CPU8)
    losses = [float(tr.fit_batch(x, y)) for _ in range(4)]
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4)
    jtr = JTrainer(jnet, JMesh(data=2, model=4))
    losses_jax = [float(jtr.fit_batch(jnp.asarray(x), jnp.asarray(y)))
                  for _ in range(4)]
    np.testing.assert_allclose(losses, losses_jax, rtol=2e-4)
    node = tr._store[0]["layer_0"]["W"]
    shards = [node[f"__tp{c}"] for c in range(4)]
    assert [tuple(s.shape) for s in shards] == [(16, 8)] * 4
    ptrs = {s.data_ptr() for r in range(2)
            for s in tr._store[r]["layer_0"]["W"].values()}
    assert len(ptrs) == 8                    # 2 replicas x 4 shards
    assert tr._model_stale
    np.testing.assert_allclose(_host(m.output(x[:8])),
                               _host(ref.output(x[:8])), atol=1e-5)
    assert not tr._model_stale
    np.testing.assert_allclose(_host(m.params_tree["layer_0"]["W"]),
                               _host(ref.params_tree["layer_0"]["W"]),
                               atol=1e-5)
    for name in ("layer_0", "layer_1", "layer_2"):
        for k in ("W", "b"):
            np.testing.assert_allclose(
                _host(m.params_tree[name][k]),
                np.asarray(jnet.params_tree[name][k]), atol=1e-4)


def test_replicas_do_not_alias_on_a_repeated_device():
    """``[cpu] * 4``: each data replica owns its parameter storage (an
    in-place update of one must not move another), and after a step every
    replica holds the master's values."""
    x, y = _toy_data(n=32)
    m = _model()
    tr = ShardedTrainer(m, MeshConfig(data=4), devices=CPU8)
    tr.fit_batch(x, y)
    leaves = [tr._flat(tr._store[r]) for r in range(4)]
    for i in range(len(leaves[0])):
        assert len({leaves[r][i].data_ptr() for r in range(4)}) == 4
        for r in range(1, 4):
            assert torch.equal(leaves[r][i], leaves[0][i])
    assert m.params_tree is tr._store[0]       # shard 0 is the master


def test_dp_dropout_draws_the_global_rows():
    """With dropout, each shard draws the GLOBAL batch's mask and keeps
    its rows, so DP still equals one device."""
    x, y = _toy_data(n=64)
    ref = _model(seed=5, dropout=0.3)
    ref_losses = [float(ref.fit(DataSet(x, y))) for _ in range(3)]
    m = _model(seed=5, dropout=0.3)
    tr = ShardedTrainer(m, MeshConfig(data=4), devices=CPU8)
    losses = [float(tr.fit_batch(x, y)) for _ in range(3)]
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4)


def test_sharded_tbptt_multidataset_graph():
    """ShardedTrainer.fit over a truncated-BPTT graph fed MultiDataSet
    batches segments time and steps; the carry is split by batch rows."""
    from deeplearning4j_torch.data.dataset import MultiDataSet
    from deeplearning4j_torch.models.computation_graph import (
        ComputationGraph)
    P_ = conf_ns("deeplearning4j_torch")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 12, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (8, 12))]

    def graph():
        g = (P_.NeuralNetConfiguration.builder().seed(1)
             .updater(P_.Adam(learning_rate=1e-2)).graph()
             .add_inputs("in").set_input_types(P_.InputType.recurrent(6))
             .add_layer("lstm", P_.LSTM(n_out=8), "in")
             .add_layer("out", P_.RnnOutputLayer(
                 n_out=3, activation="softmax", loss="mcxent"), "lstm")
             .set_outputs("out")
             .backprop_type("truncated_bptt", 4))
        return ComputationGraph(g.build()).init(device="cpu")

    model = graph()
    trainer = ShardedTrainer(model, MeshConfig(data=4), devices=CPU8)
    loss = trainer.fit(ListDataSetIterator([MultiDataSet([x], [y])]),
                       n_epochs=2)
    assert np.isfinite(loss)
    # 12 timesteps / tbptt 4 = 3 chunks per batch, 2 epochs
    assert model.iteration_count == 6
    ref = graph()
    ref_loss = ref.fit(ListDataSetIterator([MultiDataSet([x], [y])]),
                       n_epochs=2, async_prefetch=False)
    np.testing.assert_allclose(loss, ref_loss, rtol=2e-4)


def _tiny_resnet_graph(package, seed=2):
    """Conv DAG with a residual add + BN — BASELINE config 5's shape at
    toy scale."""
    P_ = conf_ns(package)
    if package == "deeplearning4j_tpu":
        from deeplearning4j_tpu.models.computation_graph import (
            ComputationGraph)
    else:
        from deeplearning4j_torch.models.computation_graph import (
            ComputationGraph)
    g = (P_.NeuralNetConfiguration.builder().seed(seed)
         .updater(P_.Adam(learning_rate=1e-2)).graph()
         .add_inputs("in").set_input_types(
             P_.InputType.convolutional(8, 8, 3)))
    g.add_layer("c1", P_.ConvolutionLayer(kernel_size=(3, 3), n_out=8,
                                          convolution_mode="same",
                                          activation="relu"), "in")
    g.add_layer("c2", P_.ConvolutionLayer(kernel_size=(3, 3), n_out=8,
                                          convolution_mode="same"), "c1")
    g.add_layer("bn", P_.BatchNormalization(), "c2")
    g.add_vertex("res", P_.ElementWiseVertex("add"), "bn", "c1")
    g.add_layer("act", P_.ActivationLayer(activation="relu"), "res")
    g.add_layer("gap", P_.GlobalPoolingLayer(pooling_type="avg"), "act")
    g.add_layer("out", P_.OutputLayer(n_out=4, activation="softmax",
                                      loss="mcxent"), "gap")
    return ComputationGraph(g.set_outputs("out").build())


def test_dp_conv_dag_matches_single_device_and_jax():
    """Data-parallel conv + BN + residual graph over 8 shards: the SAME
    loss sequence as one device (rtol 2e-4) — the batch statistics are
    the global batch's (sync-BN) — and as the JAX ShardedTrainer on the
    same weights; the BN running statistics agree too."""
    from deeplearning4j_tpu.parallel import (MeshConfig as JMesh,
                                             ShardedTrainer as JTrainer)
    from torch_model_util import carry
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8, 8, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)]
    jnet = _tiny_resnet_graph("deeplearning4j_tpu").init()
    jnet0 = _tiny_resnet_graph("deeplearning4j_tpu")
    import jax
    jnet0.params_tree, jnet0.state_tree = (
        jax.tree_util.tree_map(np.array, t)      # the JAX step donates
        for t in (jnet.params_tree, jnet.state_tree))
    single = carry(jnet, _tiny_resnet_graph("deeplearning4j_torch"))
    losses_single = [float(single.fit(DataSet(x[i:i + 16], y[i:i + 16])))
                     for i in range(0, 64, 16)]
    dp = carry(jnet, _tiny_resnet_graph("deeplearning4j_torch"))
    trainer = ShardedTrainer(dp, MeshConfig(data=8), devices=CPU8)
    losses_dp = [float(trainer.fit_batch(x[i:i + 16], y[i:i + 16]))
                 for i in range(0, 64, 16)]
    np.testing.assert_allclose(losses_dp, losses_single, rtol=2e-4)
    jtr = JTrainer(jnet, JMesh(data=8))
    losses_jax = [float(jtr.fit_batch(x[i:i + 16], y[i:i + 16]))
                  for i in range(0, 64, 16)]
    np.testing.assert_allclose(losses_dp, losses_jax, rtol=2e-4)
    # the running statistics after ONE step (later steps carry Adam's
    # amplified rounding noise in the weights): the global batch's
    one = carry(jnet0, _tiny_resnet_graph("deeplearning4j_torch"))
    one.fit(DataSet(x[:16], y[:16]))
    dp1 = carry(jnet0, _tiny_resnet_graph("deeplearning4j_torch"))
    ShardedTrainer(dp1, MeshConfig(data=8), devices=CPU8).fit_batch(
        x[:16], y[:16])
    for k in ("mean", "var"):
        np.testing.assert_allclose(_host(dp1.state_tree["bn"][k]),
                                   _host(one.state_tree["bn"][k]),
                                   rtol=1e-5, atol=1e-7)


def test_per_shard_bn_statistics_would_differ():
    """The sync-BN check bites: the same batch split into 8 shards whose
    statistics are each shard's own gives a different loss."""
    from deeplearning4j_torch.runtime import spmd
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 8, 8, 3)).astype(np.float32)
    x[:8] += 3.0                          # shards see different batches
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    net = _tiny_resnet_graph("deeplearning4j_torch").init(device="cpu")
    whole = float(net._score_batch(net.params_tree, net.state_tree,
                                   net._batch_dict(DataSet(x, y)), None,
                                   True)[0])
    parts = 0.0
    for r in range(8):
        b = net._batch_dict(DataSet(x[2 * r:2 * r + 2], y[2 * r:2 * r + 2]))
        info = spmd.ShardRows(rank=r, offset=2 * r, rows=2,
                              total=16, lead=r == 0)
        with spmd.shard_scope(info):      # no group: local statistics
            parts += float(net._score_batch(net.params_tree,
                                            net.state_tree, b, None,
                                            True)[0])
    assert abs(parts - whole) > 1e-3 * abs(whole)


def test_tp_excludes_conv_and_recurrent_kernels():
    """Tensor parallel splits plain Dense kernels only: LSTM fused-gate
    and conv HWIO kernels replicate."""
    from deeplearning4j_torch.models.computation_graph import (
        ComputationGraph)
    P_ = conf_ns("deeplearning4j_torch")
    g = (P_.NeuralNetConfiguration.builder().seed(1)
         .updater(P_.Adam(learning_rate=1e-2)).graph()
         .add_inputs("in").set_input_types(P_.InputType.recurrent(6)))
    g.add_layer("lstm", P_.LSTM(n_out=8), "in")
    g.add_layer("dense", P_.DenseLayer(n_out=16, activation="relu"),
                "lstm")
    g.add_layer("out", P_.RnnOutputLayer(n_out=4, activation="softmax",
                                         loss="mcxent"), "dense")
    model = ComputationGraph(g.set_outputs("out").build()).init(
        device="cpu")
    trainer = ShardedTrainer(model, MeshConfig(data=2, model=2),
                             devices=CPU8)
    spec = trainer._param_shardings
    assert spec["lstm"]["W"] == P()          # fused [in, 4h]: replicated
    assert spec["lstm"]["R"] == P()
    assert spec["dense"]["W"] == P(None, "model")   # column parallel
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 5, 6)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (8, 5))]
    assert np.isfinite(float(trainer.fit_batch(x, y)))

    conv = _tiny_resnet_graph("deeplearning4j_torch").init(device="cpu")
    tr = ShardedTrainer(conv, MeshConfig(data=2, model=2), devices=CPU8)
    assert tr._param_shardings["c1"]["W"] == P()      # HWIO: replicated
    assert tr._param_shardings["out"]["W"] == P(None, "model")


def test_bert_tensor_parallel_matches_single_device():
    """DP x TP of BERT (Wqkv/W1 by columns, W2/Wo by rows, the embedding
    by vocab rows) keeps the math: data=2 x model=4 == one device at
    rtol 2e-4 (``tests/test_transformer.py``'s bound), and == the JAX
    ShardedTrainer at data=2 x model=4 from the same weights on the same
    batches; the final parameters (the model's tree, synced from the
    shards) agree within 1e-4."""
    from deeplearning4j_tpu.optimize.updaters import Adam as JAdam
    from deeplearning4j_tpu.parallel import (MeshConfig as JMesh,
                                             ShardedTrainer as JTrainer)
    from deeplearning4j_tpu.zoo import Bert as JBert
    from torch_model_util import host, np_tree

    from deeplearning4j_torch.optimize.updaters import Adam
    from deeplearning4j_torch.utils.convert import load_numpy_params
    from deeplearning4j_torch.zoo import Bert
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (8, 8)).astype(np.int32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    kw = dict(n_layers=2, d_model=32, n_heads=4, d_ff=64, vocab_size=64,
              seq_len=8, max_len=16, compute_dtype=None, seed=11)
    jm = JBert(**kw)
    jm.updater = JAdam(learning_rate=1e-3)
    jnet = jm.init_graph()
    init = np_tree(jnet.params_tree)        # before the JAX step donates

    def run(mesh_conf):
        m = Bert(**kw)
        m.updater = Adam(learning_rate=1e-3)
        net = load_numpy_params(m.init_graph(device="cpu"), init,
                                device="cpu")
        tr = ShardedTrainer(net, mesh_conf, devices=CPU8)
        return [float(tr.fit_batch(ids, y)) for _ in range(4)], tr, net

    single, _, _ = run(MeshConfig(data=1, model=1))
    tp, tr, net = run(MeshConfig(data=2, model=4))
    np.testing.assert_allclose(tp, single, rtol=2e-4)
    jtr = JTrainer(jnet, JMesh(data=2, model=4))
    jax_losses = [float(jtr.fit_batch(ids, y)) for _ in range(4)]
    np.testing.assert_allclose(tp, jax_losses, rtol=2e-4)
    tr.sync_model()
    got, want = host(net.params_tree), np_tree(jnet.params_tree)
    assert set(got) == set(want)
    for name in want:
        for k in want[name]:
            np.testing.assert_allclose(got[name][k], want[name][k],
                                       atol=1e-4, err_msg=f"{name}/{k}")
    kinds = {k: v for k, v in tr._shardable.items() if v}
    assert any(v == {"W": "row"} for v in kinds.values())
    assert any(v.get("Wqkv") == "col" and v.get("Wo") == "row"
               for v in kinds.values())


def test_ema_in_sharded_trainer():
    from deeplearning4j_torch.optimize.updaters import Adam, Ema
    rng = np.random.default_rng(1)
    P_ = conf_ns("deeplearning4j_torch")
    net = _build("deeplearning4j_torch", lambda P_: [
        P_.DenseLayer(n_in=8, n_out=16, activation="tanh"),
        P_.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        updater=lambda P_: Ema(base=Adam(learning_rate=1e-2),
                               decay=0.9)).init(device="cpu")
    del P_
    tr = ShardedTrainer(net, MeshConfig(data=4), devices=CPU8)
    for _ in range(3):
        loss = tr.fit_batch(
            rng.normal(size=(16, 8)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)])
        assert np.isfinite(float(loss))
    ema = Ema.params_from_state(net.opt_state)
    from deeplearning4j_torch.utils.trees import iter_leaves
    assert all(torch.isfinite(leaf).all() for _, leaf in iter_leaves(ema))


def test_scaling_harness_emits_artifact(tmp_path):
    from deeplearning4j_torch.parallel.scaling import measure_scaling

    def make_batch(n):
        rng = np.random.default_rng(0)
        xb = rng.normal(size=(n, 16)).astype(np.float32)
        yb = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
        return xb, yb

    out = str(tmp_path / "scaling.json")
    rows = measure_scaling(lambda: _model(), make_batch,
                           per_device_batch=16, device_counts=[1, 2, 4, 8],
                           n_steps=3, warmup=1, out_path=out, devices=CPU8)
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    assert all(r["examples_per_sec"] > 0 for r in rows)
    assert rows[0]["efficiency_vs_linear"] == 1.0
    data = json.load(open(out))
    assert data["metric"] == "dp_weak_scaling" and len(data["rows"]) == 4


def test_global_mesh_and_host_batch(rng):
    from deeplearning4j_torch.parallel import (global_mesh,
                                               host_local_batch_to_global)
    mesh = global_mesh(data=4, model=2, devices=CPU8)
    assert mesh.shape == {"data": 4, "model": 2}
    batch = rng.normal(size=(16, 8)).astype(np.float32)
    parts = host_local_batch_to_global(mesh, batch, P("data"))
    assert [tuple(p.shape) for p in parts] == [(4, 8)] * 4
    np.testing.assert_allclose(torch.cat(parts).numpy(), batch)


def test_global_mesh_validates_size():
    """The reference's size check: a mesh whose product is not the job's
    device count raises ValueError (a model axis wider than a process's
    devices would span processes in a larger job)."""
    from deeplearning4j_torch.parallel import global_mesh
    with pytest.raises(ValueError, match="devices"):
        global_mesh(data=5, model=2, devices=CPU8)
    with pytest.raises(ValueError, match="devices"):
        global_mesh(data=1, model=16, devices=CPU8)


def test_trainer_with_checkpoint_listener_end_to_end(tmp_path, rng):
    """DP training + periodic checkpoints + resume."""
    from deeplearning4j_torch.parallel import CheckpointListener
    model = _model()
    lst = CheckpointListener(tmp_path / "dp", save_every_n_iterations=4)
    model.set_listeners(lst)
    trainer = ShardedTrainer(model, MeshConfig(data=8), devices=CPU8)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)]
    trainer.fit(ListDataSetIterator(DataSet(x, y).batch_by(32)),
                n_epochs=5)
    lst.ckpt.wait()
    assert len(lst.ckpt.all_steps()) >= 1
    restored = _model(seed=1)
    restored._build_solver()
    step = CheckpointListener(tmp_path / "dp").restore_into(restored)
    assert step is not None and restored.iteration_count == step + 1


@pytest.mark.gpu
def test_cuda_dp_step_launches_flash_per_block_shard_and_step():
    """A DP step of a flash-routed Gpt on the card launches K3, K5 and K6
    once per block, data shard and step."""
    _cuda_or_skip()
    import importlib

    from deeplearning4j_torch.zoo import Gpt
    fa = importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")
    net = Gpt(vocab_size=128, max_len=1024, d_model=128, n_layers=2,
              n_heads=2, d_ff=256, seq_len=1024,
              compute_dtype="bfloat16", seed=3).init_graph(device="cuda")
    dev = torch.device("cuda")
    tr = ShardedTrainer(net, MeshConfig(data=2), devices=[dev, dev])
    rng = np.random.default_rng(0)
    x = rng.integers(0, 128, (4, 1024)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    tr.fit_batch(x, y)
    for w in (fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq):
        w.launches = 0
    for _ in range(2):
        assert torch.isfinite(tr.fit_batch(x, y))
    torch.cuda.synchronize()
    for w in (fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq):
        assert w.launches == 2 * 2 * 2, (w.__name__, w.launches)



def test_lockstep_runs_one_shard_at_a_time_under_stress():
    """More shard threads than cores, a shortened switch interval, and a
    read-modify-write on shared state between collectives: the turn
    taking lets ONE thread run at a time, so no update is lost, and every
    shard's all-reduce sees the sum of all operands."""
    import sys

    from deeplearning4j_torch.runtime import spmd
    n, rounds = 16, 20
    group = spmd.Lockstep(n)
    shared = {"count": 0}

    def body(rank):
        def run():
            sums = []
            for r in range(rounds):
                v = shared["count"]          # not atomic without turns
                for _ in range(50):
                    pass
                shared["count"] = v + 1
                sums.append(float(group.all_reduce(
                    rank, [torch.tensor(float(rank + r))])[0]))
            return sums
        return run

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs = group.run([body(r) for r in range(n)])
    finally:
        sys.setswitchinterval(old)
    assert shared["count"] == n * rounds
    want = [float(sum(range(n)) + n * r) for r in range(rounds)]
    assert all(o == want for o in outs)


def test_lockstep_failure_unwinds_every_shard():
    from deeplearning4j_torch.runtime import spmd
    group = spmd.Lockstep(3)

    def body(rank):
        def run():
            group.all_reduce(rank, [torch.ones(())])
            if rank == 1:
                raise KeyError("shard 1")
            group.all_reduce(rank, [torch.ones(())])
        return run

    with pytest.raises(KeyError, match="shard 1"):
        group.run([body(r) for r in range(3)])
