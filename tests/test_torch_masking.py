"""Label-mask scoring, held across packages: the seven cases of
``tests/test_masking.py`` run through the port and the JAX package on the
same numpy inputs, f32, within atol 1e-6 — example masks [b] and [b, 1]
weight whole examples, [b, t] masks weight timesteps, no mask sums time,
MSE divides by the output count, a dense stack consumes sequences
natively, and ``clip_l2_per_param_type`` clips each parameter type's
group norm."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_model_util import conf_ns, jax_from_port  # noqa: E402

ATOL = 1e-6


def _scores(package, labels, z, mask):
    """``OutputLayer.per_example_score`` of either package as numpy."""
    P = conf_ns(package)
    ly = P.OutputLayer(n_in=4, n_out=labels.shape[-1],
                       activation="softmax", loss="mcxent")
    if package == "deeplearning4j_tpu":
        import jax.numpy as jnp
        return np.asarray(ly.per_example_score(
            jnp.asarray(labels), jnp.asarray(z),
            None if mask is None else jnp.asarray(mask)))
    return ly.per_example_score(
        torch.tensor(labels), torch.tensor(z),
        None if mask is None else torch.tensor(mask)).numpy()


def _both(labels, z, mask):
    got = _scores("deeplearning4j_torch", labels, z, mask)
    want = _scores("deeplearning4j_tpu", labels, z, mask)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    return got


def test_example_mask_b1_zeroes_only_masked_examples():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(3, 5)).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[[0, 1, 2]]
    unmasked = _both(labels, z, None)
    masked = _both(labels, z, np.asarray([[0.0], [1.0], [1.0]],
                                         np.float32))
    assert masked[0] == 0.0
    np.testing.assert_allclose(masked[1:], unmasked[1:], rtol=1e-6)


def test_example_mask_flat_b():
    rng = np.random.default_rng(1)
    z = rng.normal(size=(4, 3)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    masked = _both(labels, z, np.asarray([1.0, 0.0, 1.0, 0.0], np.float32))
    unmasked = _both(labels, z, None)
    np.testing.assert_allclose(masked, unmasked * [1, 0, 1, 0], rtol=1e-6)


def test_sequence_mask_bt_weights_timesteps():
    rng = np.random.default_rng(2)
    b, t, c = 2, 4, 3
    z = rng.normal(size=(b, t, c)).astype(np.float32)
    labels = np.eye(c, dtype=np.float32)[rng.integers(0, c, (b, t))]
    mask = np.asarray([[1, 1, 0, 0], [1, 1, 1, 1]], np.float32)
    got = _both(labels, z, mask)
    zt = z.reshape(b * t, c)
    logp = zt - np.log(np.exp(zt).sum(-1, keepdims=True))
    per_ts = -(labels.reshape(b * t, c) * logp).sum(-1).reshape(b, t)
    np.testing.assert_allclose(got, (per_ts * mask).sum(-1), rtol=1e-5)


def test_sequence_no_mask_sums_time():
    rng = np.random.default_rng(3)
    z = rng.normal(size=(2, 3, 4)).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 3))]
    got = _both(labels, z, None)
    assert got.shape == (2,)
    assert (got > 0).all()


def test_mse_divides_by_output_count():
    import jax.numpy as jnp
    from deeplearning4j_tpu.nn import losses as jl
    from deeplearning4j_torch.nn import losses as pl
    rng = np.random.default_rng(4)
    labels = rng.normal(size=(2, 10)).astype(np.float32)
    preds = rng.normal(size=(2, 10)).astype(np.float32)
    for fn in ("mse", "l2"):
        got = getattr(pl, fn)(torch.tensor(labels),
                              torch.tensor(preds)).numpy()
        want = np.asarray(getattr(jl, fn)(jnp.asarray(labels),
                                          jnp.asarray(preds)))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    ones = pl.mse(torch.zeros((2, 10)), torch.ones((2, 10))).numpy()
    np.testing.assert_allclose(ones, [1.0, 1.0])
    np.testing.assert_allclose(
        pl.l2(torch.zeros((2, 10)), torch.ones((2, 10))).numpy(),
        [10.0, 10.0])


def _dense_seq(package):
    P = conf_ns(package)
    conf = (P.NeuralNetConfiguration.builder().seed(0).list()
            .layer(P.DenseLayer(n_out=8, activation="relu"))
            .layer(P.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
            .set_input_type(P.InputType.recurrent(5))
            .build())
    assert conf.preprocessors == [None, None]
    if package == "deeplearning4j_tpu":
        from deeplearning4j_tpu import MultiLayerNetwork
    else:
        from deeplearning4j_torch.models.multi_layer_network import (
            MultiLayerNetwork)
    return MultiLayerNetwork(conf)


def test_dense_stack_preserves_sequence_shape():
    """A dense stack on [b, t, f] sequences (no folding preprocessor):
    the same outputs and the same masked fit loss in both packages."""
    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    pnet = _dense_seq("deeplearning4j_torch").init(device="cpu")
    jnet = jax_from_port(_dense_seq("deeplearning4j_tpu"), pnet)
    # copies: a JAX array made from a CPU tensor's numpy view may share
    # its memory, and the port's fit updates its tensors in place
    import jax
    jnet.params_tree = jax.tree_util.tree_map(np.array, jnet.params_tree)
    x = np.random.default_rng(0).normal(size=(4, 6, 5)).astype(np.float32)
    out = pnet.output(x).numpy()
    assert out.shape == (4, 6, 3)
    np.testing.assert_allclose(out, np.asarray(jnet.output(x)), rtol=0,
                               atol=ATOL)
    labels = np.eye(3, dtype=np.float32)[
        np.random.default_rng(1).integers(0, 3, (4, 6))]
    mask = np.ones((4, 6), np.float32)
    mask[0, 3:] = 0
    got = float(pnet.fit(DataSet(x, labels, labels_mask=mask)))
    want = float(jnet.fit(JDataSet(x, labels, labels_mask=mask)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_clip_l2_per_param_type():
    import jax.numpy as jnp
    from deeplearning4j_torch.optimize.solver import normalize_gradients
    from deeplearning4j_tpu.optimize.solver import (
        normalize_gradients as jnormalize)
    rng = np.random.default_rng(5)
    arrays = {"layer_0": {"W": np.full((2, 2), 10.0, np.float32),
                          "b": np.asarray([0.1], np.float32)},
              "layer_1": {"W": rng.normal(size=(2, 2)).astype(np.float32)
                          * 10, "b": np.asarray([0.1], np.float32)}}
    out = normalize_gradients(
        {k: {n: torch.tensor(a) for n, a in v.items()}
         for k, v in arrays.items()}, "clip_l2_per_param_type", 1.0)
    want = jnormalize({k: {n: jnp.asarray(a) for n, a in v.items()}
                       for k, v in arrays.items()},
                      "clip_l2_per_param_type", 1.0)
    for k in arrays:
        for n in ("W", "b"):
            np.testing.assert_allclose(out[k][n].numpy(),
                                       np.asarray(want[k][n]), rtol=0,
                                       atol=ATOL, err_msg=f"{k}/{n}")
    w_norm = np.sqrt(sum(np.sum(np.square(out[k]["W"].numpy()))
                         for k in out))
    assert abs(w_norm - 1.0) < 1e-5
    np.testing.assert_allclose(out["layer_0"]["b"].numpy(), [0.1],
                               rtol=1e-6)
