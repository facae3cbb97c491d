"""The port's GPipe schedule and the trainer's pipeline axis, held to
``tests/test_pipeline_parallel.py``: the microbatched schedule matches
sequential block application in forward AND gradient, DP x PP and
DP x TP x PP compose, the model's own tree syncs lazily, and the
validations keep the reference's messages.  Across packages, the port's
``gpipe_apply`` equals the JAX one on the same stacked weights, and a
pipelined ``ShardedTrainer`` step sequence equals the JAX package's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_model_util import jax_from_port  # noqa: E402

from deeplearning4j_torch.data.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.nn.conf.layers_transformer import (  # noqa: E402
    TransformerEncoderBlock)
from deeplearning4j_torch.parallel.mesh import Mesh, MeshConfig  # noqa
from deeplearning4j_torch.parallel.pipeline import (  # noqa: E402
    PipelinedTransformerLM, ShardMapPartialAutoError, gpipe_apply,
    stack_block_params)
from deeplearning4j_torch.parallel.trainer import ShardedTrainer  # noqa
from deeplearning4j_torch.utils.trees import iter_leaves  # noqa: E402

CPU = torch.device("cpu")
CPU8 = [CPU] * 8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return Mesh([CPU] * 4, ("pipe",))


@pytest.fixture(scope="module")
def setup():
    blk = TransformerEncoderBlock(n_heads=2, d_ff=32, use_flash=False)
    blk.infer_shapes((8, 16))
    params = stack_block_params(blk, 8, 0, device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(8, 8, 16)),
                        dtype=torch.float32)
    apply_one = lambda p, a: blk.apply(p, a, training=False)  # noqa
    return blk, params, x, apply_one


def _sequential(params, x, apply_one, n_blocks=8):
    h = x
    for i in range(n_blocks):
        h = apply_one({k: v[i] for k, v in params.items()}, h)
    return h


def test_partial_auto_error_keeps_its_type():
    """The reference's typed refusal for partial-auto shard_map: the port
    has no compiler partitioning (TP inside stages always composes), but
    callers catching the type still can."""
    e = ShardMapPartialAutoError({"model", "sequence"})
    assert e.auto_axes == ("model", "sequence")
    assert isinstance(e, NotImplementedError)


def test_gpipe_forward_matches_sequential(mesh, setup):
    _, params, x, apply_one = setup
    ref = _sequential(params, x, apply_one)
    for n_micro in (2, 4, 8):
        out = gpipe_apply(mesh, params, x, apply_one, n_micro=n_micro)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


def test_gpipe_gradients_match_sequential(mesh, setup):
    """GPipe backward = autograd through the schedule (stage hand-offs
    are differentiable device copies)."""
    _, params, x, apply_one = setup

    def grads(fn):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = torch.sum(torch.square(fn(leaves)))
        g = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, g))

    gp = grads(lambda p: gpipe_apply(mesh, p, x, apply_one, 4))
    gs = grads(lambda p: _sequential(p, x, apply_one))
    for k in gp:
        np.testing.assert_allclose(gp[k].numpy(), gs[k].numpy(), atol=2e-4)


def test_gpipe_validates_divisibility(mesh, setup):
    blk, _, x, apply_one = setup
    bad = stack_block_params(blk, 6, 1, device="cpu")   # 6 % 4 != 0
    with pytest.raises(ValueError, match="pipeline stages"):
        gpipe_apply(mesh, bad, x, apply_one, 4)
    ok = stack_block_params(blk, 4, 1, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        gpipe_apply(mesh, ok, x, apply_one, n_micro=3)   # 8 % 3 != 0


def test_gpipe_matches_jax(setup):
    """The same stacked weights and input through the JAX package's
    ``gpipe_apply`` on 4 virtual devices and the port's on [cpu] * 4."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    from deeplearning4j_tpu.nn.conf.layers_transformer import (
        TransformerEncoderBlock as JBlock)
    from deeplearning4j_tpu.parallel.pipeline import (
        gpipe_apply as jgpipe)
    _, params, x, apply_one = setup
    jblk = JBlock(n_heads=2, d_ff=32, use_flash=False)
    jblk.infer_shapes((8, 16))
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jmesh = JMesh(np.array(jax.devices()[:4]).reshape(4), ("pipe",))
    want = jgpipe(jmesh, jparams, jnp.asarray(x.numpy()),
                  lambda p, a: jblk.apply(p, {}, a, training=False)[0], 4)
    got = gpipe_apply(Mesh([CPU] * 4, ("pipe",)), params, x, apply_one, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _marker_task(rng):
    ids = rng.integers(10, 40, (16, 8))
    labels = rng.integers(0, 2, 16)
    for r in range(16):
        ids[r, rng.choice(8, 2, replace=False)] = (
            rng.integers(0, 5) if labels[r] == 0 else rng.integers(5, 10))
    return ids.astype(np.int32), labels, np.eye(2, dtype=np.float32)[labels]


def test_pipelined_lm_trains(mesh):
    rng = np.random.default_rng(1)
    lm = PipelinedTransformerLM(vocab_size=40, d_model=16, n_blocks=4,
                                n_heads=2, d_ff=32, seq_len=8, n_classes=2,
                                mesh=mesh, n_micro=4, lr=3e-3)
    ids, labels, y = _marker_task(rng)
    losses = [lm.fit_batch(ids, y) for _ in range(40)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    acc = (lm.predict(ids).argmax(-1) == labels).mean()
    assert acc > 0.85, acc


def test_dp_x_pp_composition_trains_and_matches():
    """MeshConfig(data=2, pipeline=4): the batch split over 'data', the
    blocks over 'pipeline' — the SAME losses as the pipe-only model, and
    it still learns."""
    rng = np.random.default_rng(1)
    kw = dict(vocab_size=40, d_model=16, n_blocks=4, n_heads=2, d_ff=32,
              seq_len=8, n_classes=2, n_micro=2, lr=3e-3)
    lm = PipelinedTransformerLM.from_mesh_config(
        MeshConfig(data=2, pipeline=4), devices=CPU8, **kw)
    assert lm._data_axis == "data" and lm._pipe_axis == "pipeline"
    ids, labels, y = _marker_task(rng)
    ref = PipelinedTransformerLM(mesh=Mesh([CPU] * 4, ("pipe",)), **kw)
    losses, ref_losses = [], []
    for _ in range(25):
        losses.append(lm.fit_batch(ids, y))
        ref_losses.append(ref.fit_batch(ids, y))
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-3)
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    acc = (lm.predict(ids).argmax(-1) == labels).mean()
    assert acc > 0.8, acc


def _gpt_kw():
    return dict(vocab_size=64, max_len=16, d_model=32, n_layers=4,
                n_heads=4, d_ff=64, seq_len=16, compute_dtype=None,
                use_flash=False, seed=11)


def _tiny_gpt_model():
    from deeplearning4j_torch.zoo import Gpt
    return Gpt(**_gpt_kw()).init_graph(device="cpu")


def _lm_batch(rng, b=16, t=16, v=64):
    x = rng.integers(0, v, (b, t)).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


@pytest.mark.parametrize("mesh_kw", [
    dict(pipeline=2),                       # pure PP
    dict(data=2, pipeline=2),               # DP x PP
    dict(data=2, model=2, pipeline=2),      # DP x TP x PP — 3 axes
])
def test_sharded_trainer_pipeline_axis_matches_single_device(mesh_kw):
    """A config-built zoo.Gpt trains through ShardedTrainer with a
    pipeline axis; its losses match the same model trained unsharded."""
    rng = np.random.default_rng(3)
    x, y = _lm_batch(rng)
    ref = _tiny_gpt_model()
    ref_losses = [float(ref.fit(DataSet(x, y))) for _ in range(4)]
    model = _tiny_gpt_model()
    st = ShardedTrainer(model, MeshConfig(**mesh_kw), devices=CPU8,
                        n_micro=2)
    losses = [float(st.fit_batch(x, y)) for _ in range(4)]
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-3, atol=2e-3)
    out = model.output(x)
    assert torch.isfinite(out).all()
    w_pipe = model.params_tree["layer_1"]["Wqkv"].numpy()
    w_ref = ref.params_tree["layer_1"]["Wqkv"].numpy()
    np.testing.assert_allclose(w_pipe, w_ref, rtol=5e-3, atol=5e-3)


def test_sharded_trainer_pipeline_matches_jax():
    """Two pipelined steps (pipeline=2, n_micro=2) of the same tiny Gpt
    in both packages, the port's init carried into the JAX net."""
    import jax
    from deeplearning4j_tpu import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.parallel.mesh import MeshConfig as JMesh
    from deeplearning4j_tpu.parallel.trainer import (
        ShardedTrainer as JTrainer)
    from deeplearning4j_tpu.zoo.gpt import Gpt as JGpt
    rng = np.random.default_rng(3)
    x, y = _lm_batch(rng)
    model = _tiny_gpt_model()
    jnet = jax_from_port(JMLN(JGpt(**_gpt_kw()).conf()), model)
    jnet.params_tree = jax.tree_util.tree_map(np.array, jnet.params_tree)
    jtr = JTrainer(jnet, JMesh(pipeline=2), n_micro=2)
    want = [float(jtr.fit_batch(x, y)) for _ in range(2)]
    st = ShardedTrainer(model, MeshConfig(pipeline=2), devices=CPU8,
                        n_micro=2)
    got = [float(st.fit_batch(x, y)) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_sharded_trainer_pipeline_sync_is_lazy():
    """The per-step path does not unstack the pipelined blocks; the
    model's tree refreshes on first read instead."""
    rng = np.random.default_rng(5)
    x, y = _lm_batch(rng)
    model = _tiny_gpt_model()
    before = model.params_tree["layer_1"]["Wqkv"].clone()
    st = ShardedTrainer(model, MeshConfig(pipeline=2), devices=CPU8,
                        n_micro=2)
    st.fit_batch(x, y)
    assert st._model_stale          # the step did not pay the unstack
    assert torch.equal(before, model.params_tree["layer_1"]["Wqkv"])
    out = model.output(x)           # read -> hook -> sync
    assert torch.isfinite(out).all()
    assert not st._model_stale
    assert not torch.equal(before, model.params_tree["layer_1"]["Wqkv"])
    # the stages' blocks live in storage of their own
    ptrs = {leaf.data_ptr() for _, leaf in iter_leaves(st._store[0]["run"])}
    assert len(ptrs) == len(list(iter_leaves(st._store[0]["run"])))


def test_sharded_trainer_pipeline_validations():
    from torch_model_util import conf_ns
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    P_ = conf_ns("deeplearning4j_torch")
    conf = (P_.NeuralNetConfiguration.builder().seed(1).list()
            .layer(P_.DenseLayer(n_in=8, n_out=8, activation="relu"))
            .layer(P_.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .build())
    m = MultiLayerNetwork(conf).init(device="cpu")
    with pytest.raises(ValueError, match="TransformerEncoderBlock"):
        ShardedTrainer(m, MeshConfig(pipeline=2), devices=CPU8)
    gpt = _tiny_gpt_model()                 # 4 blocks
    with pytest.raises(ValueError, match="divide"):
        ShardedTrainer(gpt, MeshConfig(pipeline=3), devices=CPU8)
    st = ShardedTrainer(_tiny_gpt_model(), MeshConfig(pipeline=2),
                        devices=CPU8, n_micro=2)
    x, y = _lm_batch(np.random.default_rng(0))
    with pytest.raises(ValueError, match="masked"):
        st.fit_batch(x, y, labels_mask=np.ones(x.shape, np.float32))
    with pytest.raises(ValueError, match="microbatches"):
        ShardedTrainer(_tiny_gpt_model(), MeshConfig(pipeline=2),
                       devices=CPU8, n_micro=3).fit_batch(x, y)
