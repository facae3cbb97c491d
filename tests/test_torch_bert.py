"""The zoo Bert encoder in the PyTorch port, alone and against the JAX
package.

Alone: the reference's own Bert cases (``tests/test_transformer.py``) on
the port at the reference's tiny size — forward shapes and flash parity,
the masked forward ignoring padding, synthetic convergence, the config
JSON round trip, the causal block and the bthd flash route.

Against the JAX package: a tiny ``Bert`` (2 layers, d 32, 4 heads, ff 64,
t 512, b 2) whose row 1 has 300 valid tokens, the JAX package's
parameters carried into the port (``utils.convert``).  At t 512 both
packages route every block's attention to flash (``flash_route_total``);
the JAX package runs its Pallas kernels in interpret mode, the port the
plain versions of K4, K5 and K6.  In f32 they differ in summation order
only: logits within rtol 1e-5 / atol 1e-6, the loss within 1e-5,
gradients within 1e-4, and after three Adam ``fit`` steps the parameters
within 1e-4 (the key-bias third of ``bqkv`` within 2e-3: its gradient is
zero up to rounding, which Adam turns into steps of ~lr).  Checkpoint
zips carry a Bert both ways.  On a card (``gpu`` marker) the same tiny
Bert runs K4/K5/K6 against use_flash=False."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.data import DataSet  # noqa: E402
from deeplearning4j_torch.models.multi_layer_network import (  # noqa: E402
    MultiLayerNetwork)
from deeplearning4j_torch.nn.conf.builder import (  # noqa: E402
    MultiLayerConfiguration)
from deeplearning4j_torch.nn.conf.layers_transformer import (  # noqa: E402
    TransformerEncoderBlock)
from deeplearning4j_torch.optimize.updaters import Adam  # noqa: E402
from deeplearning4j_torch.utils import (load_numpy_params,  # noqa: E402
                                        restore_model)
from deeplearning4j_torch.utils.trees import iter_leaves  # noqa: E402
from deeplearning4j_torch.zoo import Bert  # noqa: E402

fa = importlib.import_module("deeplearning4j_torch.kernels.flash_attention")

# the cross-package model: t 512 takes the flash route (one key block: K4)
TINY = dict(n_layers=2, d_model=32, n_heads=4, d_ff=64, vocab_size=120,
            seq_len=512, max_len=512, compute_dtype=None, seed=7)
LR = 3e-4


def _tiny_bert(use_flash=True, n_classes=2, seed=7):
    """The reference test's tiny Bert (t 16: the plain attention path)."""
    return Bert(n_layers=2, d_model=32, n_heads=4, d_ff=64,
                vocab_size=120, seq_len=16, max_len=32,
                compute_dtype=None, use_flash=use_flash, seed=seed,
                n_classes=n_classes)


# -- the reference's Bert cases, on the port ----------------------------
def test_bert_forward_shapes_and_flash_parity():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 120, (4, 16)).astype(np.int32)
    net_f = _tiny_bert(True).init_graph(device="cpu")
    net_e = _tiny_bert(False).init_graph(device="cpu")
    out_f = net_f.output(ids).numpy()
    out_e = net_e.output(ids).numpy()
    assert out_f.shape == (4, 2)
    np.testing.assert_allclose(out_f.sum(1), 1.0, atol=1e-5)
    np.testing.assert_allclose(out_f, out_e, atol=3e-5)


@pytest.mark.parametrize("t,valid", [(16, 10), (512, 300)])
def test_bert_masked_forward_ignores_padding(t, valid):
    """The mask makes padded positions irrelevant to the output, on the
    plain path (t 16) and the flash path (t 512)."""
    net = Bert(**dict(TINY, seq_len=t)).init_graph(device="cpu")
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 120, (2, t)).astype(np.int32)
    mask = np.ones((2, t), np.float32)
    mask[:, valid:] = 0
    out1 = net.output(ids, features_mask=mask).numpy()
    ids2 = ids.copy()
    ids2[:, valid:] = rng.integers(0, 120, (2, t - valid))
    out2 = net.output(ids2, features_mask=mask).numpy()
    np.testing.assert_allclose(out1, out2, atol=1e-5)


def test_bert_convergence_synthetic():
    """Separable task: class = which marker token family appears."""
    rng = np.random.default_rng(3)
    n = 64
    ids = rng.integers(20, 120, (n, 16))
    labels = rng.integers(0, 2, n)
    for r in range(n):
        slots = rng.choice(16, 3, replace=False)
        ids[r, slots] = rng.integers(0, 10) if labels[r] == 0 else \
            rng.integers(10, 20)
    y = np.eye(2, dtype=np.float32)[labels]
    m = _tiny_bert()
    m.updater = Adam(learning_rate=3e-3)
    net = m.init_graph(device="cpu")
    ds = DataSet(ids.astype(np.int32), y)
    for _ in range(60):
        net.fit(ds)
    out = net.output(ids.astype(np.int32)).numpy()
    acc = (out.argmax(-1) == labels).mean()
    assert acc > 0.9, acc


def test_bert_config_json_roundtrip():
    conf = _tiny_bert().conf()
    conf2 = MultiLayerConfiguration.from_json(conf.to_json())
    assert conf2.to_dict() == conf.to_dict()
    net = MultiLayerNetwork(conf2).init(device="cpu")
    ids = np.zeros((2, 16), np.int32)
    assert tuple(net.output(ids).shape) == (2, 2)


def test_bert_causal_block():
    """Causal block: future tokens cannot affect earlier positions."""
    blk = TransformerEncoderBlock(n_heads=2, d_ff=16, causal=True,
                                  use_flash=False)
    blk.infer_shapes((8, 8))
    params = blk.init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 8, 8)).astype(np.float32))
    y1 = blk.apply(params, x)
    x2 = x.clone()
    x2[:, 5:] += 1.0                       # perturb the future
    y2 = blk.apply(params, x2)
    torch.testing.assert_close(y1[:, :5], y2[:, :5], rtol=0, atol=1e-5)


def test_encoder_block_takes_bthd_flash_route():
    """At flash-eligible shapes the block reaches the flash path through
    the bthd layout (the route log records the flash pick)."""
    blk = TransformerEncoderBlock(n_heads=2, d_ff=64, causal=True,
                                  use_flash=True)
    blk.infer_shapes((512, 256))          # t=512, d_model=256 -> dh=128
    params = blk.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 512, 256)).astype(np.float32))
    fa.reset_route_log()
    y = blk.apply(params, x)
    assert tuple(y.shape) == (2, 512, 256)
    assert fa.route_log() == (("flash", 512, 128),), fa.route_log()


def test_bert_layers_and_flops():
    """Bert()'s defaults are BERT-base, its stack embedding -> 12 blocks
    -> masked average pooling -> softmax head, and its FLOPs per token
    are the reference's formula."""
    m = Bert()
    conf = m.conf()
    names = [type(ly).__name__ for ly in conf.layers]
    assert names == (["EmbeddingSequenceLayer"]
                     + ["TransformerEncoderBlock"] * 12
                     + ["GlobalPoolingLayer", "OutputLayer"])
    assert conf.layers[0].n_in == 30522 and conf.layers[0].n_out == 768
    assert conf.layers[1].n_heads == 12 and conf.layers[1].d_ff == 3072
    assert conf.layers[-2].pooling_type == "avg"
    assert conf.global_conf.compute_dtype == "bfloat16"
    assert conf.global_conf.updater["learning_rate"] == 2e-5
    d, ff, L, t = 768, 3072, 12, 128
    assert m.flops_per_token_train() == (6.0 * L * (4 * d * d + 2 * d * ff)
                                         + 12.0 * L * t * d)


def test_clone_and_save_load_are_independent_copies(tmp_path):
    """clone() copies the configuration, parameters and counters (fit
    updates tensors in place, so a shared tensor would move both nets);
    save/load round-trips the zip with the updater state."""
    net = Bert(**dict(TINY, seq_len=16)).init_graph(device="cpu")
    x, y, m = _batch(7, t=16)
    net.fit(DataSet(x, y, m))
    twin = net.clone()
    assert twin.conf.to_dict() == net.conf.to_dict()
    assert twin.iteration_count == net.iteration_count == 1
    np.testing.assert_array_equal(twin.params(), net.params())
    before = net.params()
    twin.fit(DataSet(x, y, m))
    np.testing.assert_array_equal(net.params(), before)
    assert not np.array_equal(twin.params(), before)
    net.save(str(tmp_path / "b.zip"))
    back = MultiLayerNetwork.load(str(tmp_path / "b.zip"), device="cpu")
    np.testing.assert_array_equal(back.params(), before)
    assert back.opt_state is not None and back.iteration_count == 1
    assert back.fit(DataSet(x, y, m)) == pytest.approx(
        net.fit(DataSet(x, y, m)), rel=1e-6)


def test_bert_backward_asks_no_key_bias_gradient(monkeypatch):
    """The features mask reaches K4/K5/K6 as a key bias that needs no
    gradient, so every K5 call of a Bert step runs without dBias."""
    seen = []
    real = fa.flash_bwd_dkdv

    def spy(*args, need_dbias=False, **kw):
        seen.append((args[3] is not None, need_dbias))
        return real(*args, need_dbias=need_dbias, **kw)
    monkeypatch.setattr(fa, "flash_bwd_dkdv", spy)
    net = Bert(**TINY).init_graph(device="cpu")
    x, y, m = _batch(6)
    assert np.isfinite(net.fit(DataSet(x, y, m)))
    assert seen == [(True, False)] * 2


def test_bert_init_without_cuda_raises():
    """Entry points default to the card; without one they raise, never
    running on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        _tiny_bert().init_graph()


# -- against the JAX package -------------------------------------------
def _jax():
    jax = pytest.importorskip("jax")
    return jax


def _np_tree(tree):
    return _jax().tree_util.tree_map(np.asarray, tree)


def _batch(seed, b=2, t=512):
    """Seeded ids, one-hot labels over 2 classes and a features mask whose
    row 1 has 300 valid tokens (row 0 all valid)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 120, (b, t)).astype(np.int32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
    m = np.ones((b, t), np.float32)
    m[1, 300:] = 0.0
    return x, y, m


def _jax_bert():
    from deeplearning4j_tpu.optimize.updaters import Adam as JAdam
    from deeplearning4j_tpu.zoo import Bert as JBert
    return JBert(updater=JAdam(learning_rate=LR), **TINY).init_graph()


def _port_copy(jnet):
    pnet = Bert(updater=Adam(learning_rate=LR), **TINY).init_graph(
        device="cpu")
    return load_numpy_params(pnet, _np_tree(jnet.params_tree), device="cpu")


@pytest.fixture(scope="module")
def pair():
    """(JAX net, port net with the JAX net's parameters) — neither is
    trained by the tests that share it."""
    jnet = _jax_bert()
    return jnet, _port_copy(jnet)


def test_bert_config_json_equals_jax():
    from deeplearning4j_tpu.optimize.updaters import Adam as JAdam
    from deeplearning4j_tpu.zoo import Bert as JBert
    for kw in ({}, dict(TINY)):
        assert Bert(**kw).conf().to_dict() == \
            JBert(**kw).conf().to_dict()
    assert (Bert(updater=Adam(learning_rate=LR)).conf().to_dict()
            == JBert(updater=JAdam(learning_rate=LR)).conf().to_dict())
    assert Bert(**TINY).flops_per_token_train() == \
        JBert(**TINY).flops_per_token_train()


def test_bert_logits_match_jax_on_the_flash_route(pair):
    from deeplearning4j_tpu import kernels as jk
    jnet, pnet = pair
    x, _, m = _batch(0)
    jk.reset_route_log()
    fa.reset_route_log()
    want = np.asarray(jnet.output(x, features_mask=m))
    got = pnet.output(x, features_mask=m).numpy()
    assert jk.route_log() == (("flash", 512, 8),) * 2
    assert fa.route_log() == (("flash", 512, 8),) * 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # every per-layer activation too (the pooled features included)
    jacts = jnet.feed_forward(x)
    pacts = pnet.feed_forward(x)
    assert len(jacts) == len(pacts) == len(pnet.layers) + 1
    for i, (a, b) in enumerate(zip(jacts[1:], pacts[1:])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5, err_msg=f"layer {i}")


def test_bert_loss_and_gradients_match_jax(pair):
    jax = _jax()
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.models.multi_layer_network import (
        MultiLayerNetwork as JMLN)
    jnet, pnet = pair
    x, y, m = _batch(1)
    jbatch = JMLN._batch_dict(JDataSet(x, y, m))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnet._score_batch(p, jnet.state_tree, jbatch, None,
                                    False)[0]))(jnet.params_tree)
    pnet._build_solver()
    fa.reset_route_log()
    ploss, _, pgrads = pnet._solver._loss_and_grads(
        pnet.params_tree, pnet.state_tree,
        pnet._batch_dict(DataSet(x, y, m)), None)
    assert fa.route_log() == (("flash", 512, 8),) * 2
    assert float(ploss) == pytest.approx(float(jloss), rel=1e-5)
    jg = dict(iter_leaves(_np_tree(jgrads)))
    pg = dict(iter_leaves(pgrads))
    assert set(jg) == set(pg)
    for path, g in pg.items():
        np.testing.assert_allclose(g.numpy(), jg[path], rtol=0, atol=1e-4,
                                   err_msg="/".join(path))
    # layer 3 (the pooling) has no parameters; the head's gradient
    # is not vacuous
    assert not any(p[0] == "layer_3" for p in pg)
    assert np.abs(jg[("layer_4", "W")]).max() > 1e-3


def _assert_params_close(pnet, jnet, atol):
    """Every parameter within ``atol`` — except the key-bias third of
    ``bqkv``, held to 2e-3 (its gradient is zero up to rounding, which
    Adam's m / sqrt(v) turns into steps of ~lr of either sign)."""
    jp = dict(iter_leaves(_np_tree(jnet.params_tree)))
    for path, leaf in iter_leaves(pnet.params_tree):
        got, want = leaf.numpy(), jp[path]
        if path[-1] == "bqkv":
            d = got.shape[0] // 3
            np.testing.assert_allclose(got[d:2 * d], want[d:2 * d], rtol=0,
                                       atol=max(atol, 2e-3))
            got = np.concatenate([got[:d], got[2 * d:]])
            want = np.concatenate([want[:d], want[2 * d:]])
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg="/".join(path))


def test_bert_three_fit_steps_track_jax():
    from deeplearning4j_tpu import kernels as jk
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    jnet = _jax_bert()
    pnet = _port_copy(jnet)
    jk.reset_route_log()
    fa.reset_route_log()
    jl, pl = [], []
    for step in range(3):
        x, y, m = _batch(10 + step)
        jl.append(jnet.fit(JDataSet(x, y, m)))
        pl.append(pnet.fit(DataSet(x, y, m)))
    assert fa.route_log() == (("flash", 512, 8),) * (2 * 3)
    assert ("flash", 512, 8) in jk.route_log()
    assert "xla" not in {r[0] for r in jk.route_log()}
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert np.isfinite(pl).all()
    _assert_params_close(pnet, jnet, 1e-4)
    assert pnet.iteration_count == jnet.iteration_count == 3


def test_bert_jax_checkpoint_restores_in_the_port(pair, tmp_path):
    from deeplearning4j_tpu.utils.model_serializer import (
        write_model as jax_write)
    jnet, _ = pair
    path = tmp_path / "bert_jax.zip"
    jax_write(jnet, str(path))
    pnet = restore_model(str(path), device="cpu")
    assert [type(ly).__name__ for ly in pnet.layers][-2:] == [
        "GlobalPoolingLayer", "OutputLayer"]
    assert pnet.params_tree["layer_3"] == {}
    x, _, m = _batch(2)
    np.testing.assert_allclose(
        pnet.output(x, features_mask=m).numpy(),
        np.asarray(jnet.output(x, features_mask=m)), rtol=1e-5, atol=1e-6)


def test_bert_port_checkpoint_restores_in_jax(tmp_path):
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.utils.model_serializer import (
        restore_model as jax_restore)
    pnet = Bert(updater=Adam(learning_rate=LR), **TINY).init_graph(
        device="cpu")
    x, y, m = _batch(3)
    pnet.fit(DataSet(x, y, m))              # updater state is written too
    path = tmp_path / "bert_port.zip"
    pnet.save(str(path))
    jnet = jax_restore(str(path))
    np.testing.assert_allclose(
        np.asarray(jnet.output(x, features_mask=m)),
        pnet.output(x, features_mask=m).numpy(), rtol=1e-5, atol=1e-6)
    # the restored JAX net resumes from the port's Adam state: one more
    # step in each package lands on the same loss
    x2, y2, m2 = _batch(4)
    assert jnet.fit(JDataSet(x2, y2, m2)) == pytest.approx(
        pnet.fit(DataSet(x2, y2, m2)), rel=1e-5)
    back = MultiLayerNetwork.load(str(path), device="cpu")
    assert back.iteration_count == 1


# -- on the card -------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_tiny_bert_flash_matches_plain(dtype):
    """The tiny Bert on the card: use_flash=True (K4, K5, K6) against
    use_flash=False on the same parameters and a padded batch — loss
    within 1e-4 (f32) / 2e-2 (bf16 compute) relative, every gradient
    within 1e-3 / 5e-2 of the largest — and K4/K5/K6 launched once per
    layer, K3 never."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu "
                    "tests/test_torch_*.py on the card)")
    kw = dict(TINY, compute_dtype=None if dtype == "float32" else dtype)
    nets = [Bert(use_flash=f, **kw).init_graph(device="cuda")
            for f in (True, False)]
    nets[1].params_tree = nets[0].params_tree
    x, y, m = _batch(5)
    wrappers = ("flash_fwd", "flash_fwd_single", "flash_bwd_dkdv",
                "flash_bwd_dq")
    out = []
    for net in nets:
        for name in wrappers:
            getattr(fa, name).launches = 0
        net._build_solver()
        loss, _, grads = net._solver._loss_and_grads(
            net.params_tree, net.state_tree,
            net._batch_dict(DataSet(x, y, m)), None)
        torch.cuda.synchronize()
        out.append((float(loss), dict(iter_leaves(grads)),
                    {n: getattr(fa, n).launches for n in wrappers}))
    assert out[0][2] == {"flash_fwd": 0, "flash_fwd_single": 2,
                         "flash_bwd_dkdv": 2, "flash_bwd_dq": 2}
    assert not any(out[1][2].values())
    ltol, gtol = (1e-4, 1e-3) if dtype == "float32" else (2e-2, 5e-2)
    assert out[0][0] == pytest.approx(out[1][0], rel=ltol)
    for path, g in out[0][1].items():
        ref = out[1][1][path]
        scale = max(float(ref.abs().max()), 1e-30)
        assert float((g - ref).abs().max()) / scale <= gtol, path
