"""The port's remaining DL4J layers (``nn/conf/layers_misc.py``), the
YOLO2 detection head (``nn/conf/layers_objdetect.py``) and the volumetric
input kind (``nn/conf/inputs.py``), held to the JAX package on the
reference tests' own networks and sizes (``tests/test_layers_misc.py``):
the same configuration JSON, the JAX parameters carried across, the same
inference output (f32, rtol 1e-5 / atol 1e-6) and the same training loss
(rtol 1e-5) and gradients (each leaf within 1e-4 of its largest
element; f32, the two sum in different orders).

The score plumbing (the networks pass ``head_input``, ``params`` and the
head key to every output layer): the center loss and the VAE's
deterministic -ELBO equal the JAX package's, losses and gradients, in a
MultiLayerNetwork and in a ComputationGraph — without the plumbing the
port would score plain cross-entropy and raise for the VAE.  The VAE's
sampled loss draws from the port's counter-hash keys, not threefry: it
is held to the JAX package's by distribution (the means of 256 draws a
side within 5 standard errors).  ``Yolo2OutputLayer``'s loss and
gradient equal the JAX package's in f64 (1e-12).  One SelfAttention case
runs the flash route at t 512 in both packages (the JAX Pallas kernels
in interpret mode, the port's plain versions of K4-K6 on the CPU)."""
import json

import numpy as np
import pytest

from torch_model_util import (  # noqa: F401 (a fixture among them)
    assert_trees_close, batches, conf_ns, graph_pair, host, jax_loss_grads,
    mln_pair, one_torch_thread, port_loss_grads)

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = 1e-4


def _cls(rng, shape, n_cls, seq=False):
    x = rng.normal(size=shape).astype(np.float32)
    idx = rng.integers(0, n_cls, shape[:2] if seq else shape[0])
    return x, np.eye(n_cls, dtype=np.float32)[idx]


def _softmax_out(P, n):
    return P.OutputLayer(n_out=n, activation="softmax", loss="mcxent")


def _rnn_out(P, n):
    return P.RnnOutputLayer(n_out=n, activation="softmax", loss="mcxent")


# name: (layers(P), input type(P), data(rng) -> (x, y[, features mask]))
CASES = {
    "prelu": (lambda P: [P.DenseLayer(n_out=6, activation="identity"),
                         P.PReLULayer(), _softmax_out(P, 3)],
              lambda P: P.InputType.feed_forward(4),
              lambda r: _cls(r, (8, 4), 3)),
    "prelu_shared_axes": (
        lambda P: [P.PReLULayer(shared_axes=[1, 2]), _softmax_out(P, 2)],
        lambda P: P.InputType.convolutional(4, 4, 3),
        lambda r: _cls(r, (4, 4, 4, 3), 2)),
    "elementwise_multiplication": (
        lambda P: [P.ElementWiseMultiplicationLayer(activation="tanh"),
                   _softmax_out(P, 3)],
        lambda P: P.InputType.feed_forward(5),
        lambda r: _cls(r, (8, 5), 3)),
    "locally_connected_2d": (
        lambda P: [P.LocallyConnected2D(kernel_size=(2, 2), n_out=4,
                                        activation="tanh"),
                   _softmax_out(P, 3)],
        lambda P: P.InputType.convolutional(5, 5, 2),
        lambda r: _cls(r, (4, 5, 5, 2), 3)),
    "locally_connected_2d_same_strided": (
        lambda P: [P.LocallyConnected2D(kernel_size=(3, 2), stride=(2, 2),
                                        convolution_mode="same", n_out=4,
                                        activation="tanh"),
                   _softmax_out(P, 3)],
        lambda P: P.InputType.convolutional(5, 6, 3),
        lambda r: _cls(r, (4, 5, 6, 3), 3)),
    "locally_connected_1d": (
        lambda P: [P.LocallyConnected1D(kernel_size=2, n_out=4,
                                        activation="tanh"), _rnn_out(P, 3)],
        lambda P: P.InputType.recurrent(3, timesteps=6),
        lambda r: (r.normal(size=(4, 6, 3)).astype(np.float32),
                   np.eye(3, dtype=np.float32)[r.integers(0, 3, (4, 5))])),
    "locally_connected_1d_same_strided": (
        lambda P: [P.LocallyConnected1D(kernel_size=3, stride=2,
                                        convolution_mode="same", n_out=4,
                                        activation="tanh"), _rnn_out(P, 3)],
        lambda P: P.InputType.recurrent(3, timesteps=7),
        lambda r: (r.normal(size=(4, 7, 3)).astype(np.float32),
                   np.eye(3, dtype=np.float32)[r.integers(0, 3, (4, 4))])),
    "self_attention_masked": (
        lambda P: [P.SelfAttentionLayer(n_heads=2, head_size=4,
                                        project_input=True, n_out=6),
                   _rnn_out(P, 3)],
        lambda P: P.InputType.recurrent(5),
        lambda r: _cls(r, (4, 7, 5), 3, seq=True) + (
            (np.arange(7)[None] < np.array([7, 5, 3, 6])[:, None])
            .astype(np.float32),)),
    "self_attention_no_projection": (
        lambda P: [P.SelfAttentionLayer(n_heads=2, head_size=3,
                                        project_input=False),
                   _rnn_out(P, 2)],
        lambda P: P.InputType.recurrent(6),
        lambda r: _cls(r, (3, 5, 6), 2, seq=True)),
    "learned_self_attention": (
        lambda P: [P.LearnedSelfAttentionLayer(n_heads=2, head_size=3,
                                               n_queries=4, n_out=6),
                   _rnn_out(P, 2)],
        lambda P: P.InputType.recurrent(5),
        lambda r: (r.normal(size=(3, 9, 5)).astype(np.float32),
                   np.eye(2, dtype=np.float32)[r.integers(0, 2, (3, 4))])),
    "conv3d_max_pool": (
        lambda P: [P.Convolution3D(kernel_size=(2, 2, 2), n_out=4,
                                   activation="relu"),
                   P.Subsampling3DLayer(kernel_size=(2, 2, 2),
                                        stride=(2, 2, 2), pooling_type="max"),
                   _softmax_out(P, 2)],
        lambda P: P.InputType.convolutional3d(5, 5, 5, 2),
        lambda r: _cls(r, (3, 5, 5, 5, 2), 2)),
    "conv3d_avg_pool": (
        lambda P: [P.Convolution3D(kernel_size=2, n_out=3, activation="tanh"),
                   P.Subsampling3DLayer(kernel_size=2, stride=2,
                                        pooling_type="avg"),
                   _softmax_out(P, 2)],
        lambda P: P.InputType.convolutional3d(4, 4, 4, 1),
        lambda r: _cls(r, (3, 4, 4, 4, 1), 2)),
    "conv3d_same_strided": (
        lambda P: [P.Convolution3D(kernel_size=(3, 2, 3), stride=(2, 1, 2),
                                   convolution_mode="same", n_out=3,
                                   activation="tanh"),
                   _softmax_out(P, 2)],
        lambda P: P.InputType.convolutional3d(5, 4, 5, 2),
        lambda r: _cls(r, (3, 5, 4, 5, 2), 2)),
    "center_loss": (
        lambda P: [P.DenseLayer(n_out=6, activation="relu"),
                   P.CenterLossOutputLayer(n_out=3, activation="softmax",
                                           loss="mcxent", lambda_=0.1)],
        lambda P: P.InputType.feed_forward(4),
        lambda r: _cls(r, (8, 4), 3)),
    "vae_gaussian": (
        lambda P: [P.VariationalAutoencoder(
            n_out=3, encoder_layer_sizes=(12,), decoder_layer_sizes=(12,),
            reconstruction_distribution="gaussian", activation="tanh")],
        lambda P: P.InputType.feed_forward(6),
        lambda r: (lambda x: (x, x))(
            r.normal(size=(16, 6)).astype(np.float32))),
    "vae_bernoulli": (
        lambda P: [P.VariationalAutoencoder(
            n_out=2, encoder_layer_sizes=(8, 6), decoder_layer_sizes=(8,),
            reconstruction_distribution="bernoulli")],
        lambda P: P.InputType.feed_forward(5),
        lambda r: (lambda x: (x, x))(
            (r.random((12, 5)) > 0.5).astype(np.float32))),
}


def _centers(jnet, pnet, key):
    """Non-zero centers in both nets (zeros would hide a center term
    that ignores them)."""
    c = np.random.default_rng(3).normal(
        size=np.asarray(jnet.params_tree[key]["centers"]).shape).astype(
            np.float32)
    jnet.params_tree[key]["centers"] = jnet.params_tree[key]["centers"] \
        * 0 + c
    pnet.params_tree[key]["centers"] = torch.from_numpy(c.copy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(name):
    """Configuration JSON, inference output, training loss and every
    gradient equal the JAX package's on the same network and data."""
    layers, itype, data = CASES[name]
    jnet, pnet = mln_pair(layers, itype)
    arrays = data(np.random.default_rng(7))
    x, y = arrays[0], arrays[1]
    fmask = arrays[2] if len(arrays) > 2 else None
    lmask = fmask if fmask is not None and y.ndim == 3 else None
    if name == "center_loss":
        _centers(jnet, pnet, "layer_1")
    jds, pds = batches(x, y, features_mask=fmask, labels_mask=lmask)
    np.testing.assert_allclose(
        host(pnet.output(x, features_mask=fmask)),
        host(jnet.output(x, features_mask=fmask)), **OUT_TOL)
    jl, jg = jax_loss_grads(jnet, jds)
    pl, pg = port_loss_grads(pnet, pds)
    assert pl == pytest.approx(jl, rel=1e-5)
    assert_trees_close(pg, jg, GRAD_TOL)


def test_center_loss_and_vae_scores_match_jax_in_a_graph():
    """A graph with two heads — a center-loss softmax over a dense
    embedding and a VAE over the same input — scores and differentiates
    as the JAX graph does (each head gets its input, its params and its
    own key)."""
    def build(P, g):
        g.add_inputs("in").set_input_types(P.InputType.feed_forward(6))
        g.add_layer("emb", P.DenseLayer(n_out=5, activation="tanh"), "in")
        g.add_layer("cls", P.CenterLossOutputLayer(
            n_out=3, activation="softmax", loss="mcxent", lambda_=0.5),
            "emb")
        g.add_layer("vae", P.VariationalAutoencoder(
            n_out=2, encoder_layer_sizes=(7,), decoder_layer_sizes=(7,),
            activation="tanh"), "in")
        g.set_outputs("cls", "vae")

    from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS

    from deeplearning4j_torch.data.dataset import MultiDataSet as PMDS
    jnet, pnet = graph_pair(build)
    _centers(jnet, pnet, "cls")
    r = np.random.default_rng(11)
    x = r.normal(size=(8, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 8)]
    jds, pds = JMDS([x], [y, x]), PMDS([x], [y, x])
    jl, jg = jax_loss_grads(jnet, jds)
    pl, pg = port_loss_grads(pnet, pds)
    assert pl == pytest.approx(jl, rel=1e-5)
    assert_trees_close(pg, jg, GRAD_TOL)
    # the center term is in: plain cross-entropy + the VAE would be less
    ce = float(torch.nn.functional.cross_entropy(
        torch.log(pnet.output(x)[0]), torch.from_numpy(y.argmax(1))))
    assert pl > ce
    for got, want in zip(host(pnet.output(x)), host(jnet.output(x))):
        np.testing.assert_allclose(got, want, **OUT_TOL)


def test_vae_sampled_loss_matches_jax_by_distribution():
    """num_samples=1 with a head key: each package draws eps from its own
    generator, so single losses differ; over 256 keys a side the means
    agree within 5 standard errors, and both lie above the mean-field
    loss's neighbourhood as Jensen's gap predicts (the sampled -ELBO is
    noisy around a larger mean)."""
    j = pytest.importorskip("jax")
    layers, itype, data = CASES["vae_gaussian"]
    jnet, pnet = mln_pair(layers, itype)
    x, y = data(np.random.default_rng(2))
    jds, pds = batches(x, y)
    jb = jnet._batch_dict(jds)
    score = j.jit(lambda key: jnet._score_batch(
        jnet.params_tree, jnet.state_tree, jb, key, False)[0])
    jl = np.array([float(score(j.random.PRNGKey(i))) for i in range(256)])
    pb = pnet._batch_dict(pds)
    with torch.no_grad():
        pl = np.array([float(pnet._score_batch(
            pnet.params_tree, pnet.state_tree, pb, 1000 + i, False)[0])
            for i in range(256)])
    se = np.sqrt(jl.var() / jl.size + pl.var() / pl.size)
    assert abs(jl.mean() - pl.mean()) <= 5 * se, (jl.mean(), pl.mean(), se)
    assert 0.5 < pl.std() / jl.std() < 2.0
    mean_field = float(pnet.score(pds))
    assert mean_field == pytest.approx(jnet.score(jds), rel=1e-5)
    assert pl.std() > 0 and len(set(pl.tolist())) == pl.size


def test_yolo2_loss_and_gradient_match_jax_in_f64():
    """Yolo2OutputLayer's per-example loss and its gradient on the same
    f64 feature map and grid labels: equal to 1e-12 (the arithmetic
    runs term for term in the reference's order)."""
    j = pytest.importorskip("jax")
    from deeplearning4j_tpu.nn.conf.layers_objdetect import (
        Yolo2OutputLayer as JYolo)

    from deeplearning4j_torch.nn.conf.layers_objdetect import (
        Yolo2OutputLayer as PYolo)
    r = np.random.default_rng(4)
    z = r.normal(size=(3, 4, 5, 8))
    lab = np.zeros((3, 4, 5, 8))
    for b in range(3):
        for _ in range(2):
            gi, gj = r.integers(0, 4), r.integers(0, 5)
            lab[b, gi, gj, :5] = [1.0, *r.random(2), *(r.random(2) + 0.5)]
            lab[b, gi, gj, 5 + r.integers(0, 3)] = 1.0
    mask = np.array([1.0, 0.0, 1.0])
    with j.enable_x64(True):
        jl = JYolo(n_classes=3)
        jf = lambda zz: j.numpy.sum(jl.per_example_score(
            j.numpy.asarray(lab), zz, j.numpy.asarray(mask)))
        jv, jg = j.value_and_grad(jf)(j.numpy.asarray(z))
        jout = np.asarray(jl.apply({}, {}, j.numpy.asarray(z),
                                   training=False)[0])
        jper = np.asarray(jl.per_example_score(j.numpy.asarray(lab),
                                               j.numpy.asarray(z)))
    pl = PYolo(n_classes=3)
    zt = torch.tensor(z, requires_grad=True)
    pv = pl.per_example_score(torch.tensor(lab), zt,
                              torch.tensor(mask)).sum()
    (pg,) = torch.autograd.grad(pv, zt)
    np.testing.assert_allclose(float(pv.detach()), float(jv), rtol=1e-12)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(
        pl.per_example_score(torch.tensor(lab), torch.tensor(z)).numpy(),
        jper, rtol=1e-12)
    np.testing.assert_allclose(pl.apply({}, torch.tensor(z)).numpy(), jout,
                               rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError, match="channels"):
        PYolo(n_classes=7).infer_shapes((4, 4, 8))


def test_self_attention_flash_route_matches_jax():
    """SelfAttentionLayer(use_flash=True) at t 512 with a padding mask:
    both packages take the flash route (JAX's Pallas kernels in
    interpret mode, the port's plain versions of K4, K5 and K6 on the
    CPU, f32 as the reference keeps it off its accelerator), with the
    mask as the key bias; output, loss and gradients agree."""
    pytest.importorskip("jax")
    import importlib
    fa = importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")
    t = 512
    jnet, pnet = mln_pair(
        lambda P: [P.SelfAttentionLayer(n_heads=2, head_size=8, n_out=8,
                                        use_flash=True),
                   P.GlobalPoolingLayer(pooling_type="avg"),
                   _softmax_out(P, 2)],
        lambda P: P.InputType.recurrent(6, timesteps=t))
    r = np.random.default_rng(5)
    x = r.normal(size=(2, t, 6)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1]]
    mask = (np.arange(t)[None] < np.array([t, 300])[:, None]).astype(
        np.float32)
    jds, pds = batches(x, y, features_mask=mask)
    fa.reset_route_log()
    np.testing.assert_allclose(host(pnet.output(x, features_mask=mask)),
                               host(jnet.output(x, features_mask=mask)),
                               rtol=1e-4, atol=1e-6)
    assert fa.route_log() == (("flash", t, 8),)
    jl, jg = jax_loss_grads(jnet, jds)
    pl, pg = port_loss_grads(pnet, pds)
    assert pl == pytest.approx(jl, rel=1e-5)
    assert_trees_close(pg, jg, GRAD_TOL)


def test_misc_layers_json_and_checkpoint_roundtrip(tmp_path):
    """Every new layer's configuration JSON restores to itself (the
    locally connected layers' inferred output sizes and PReLU's input
    shape included), the ``cnn3d`` input kind and its ``cnn3d_to_ff``
    reshape round trip, and a port checkpoint of the layers restores
    with the same outputs."""
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf.builder import MultiLayerConfiguration
    from deeplearning4j_torch.utils.model_serializer import restore_model
    for name, (layers, itype, _) in CASES.items():
        jnet, pnet = mln_pair(layers, itype)
        d = json.loads(pnet.conf.to_json())
        assert json.loads(MultiLayerConfiguration.from_json(
            pnet.conf.to_json()).to_json()) == d, name
    jnet, pnet = mln_pair(*CASES["conv3d_max_pool"][:2])
    assert pnet.conf.input_type.kind == "cnn3d"
    assert pnet.conf.preprocessors[2].name == "cnn3d_to_ff"
    P = conf_ns("deeplearning4j_torch")
    b = (P.NeuralNetConfiguration.builder().seed(1).list()
         .layer(P.DenseLayer(n_out=6, activation="identity"))
         .layer(P.PReLULayer())
         .layer(P.ElementWiseMultiplicationLayer(activation="tanh"))
         .layer(P.CenterLossOutputLayer(n_out=3, activation="softmax")))
    m = MultiLayerNetwork(b.set_input_type(P.InputType.feed_forward(4))
                          .build()).init(device="cpu")
    m.save(tmp_path / "m.zip")
    m2 = restore_model(tmp_path / "m.zip", device="cpu")
    x = np.random.default_rng(0).normal(size=(4, 4)).astype(np.float32)
    np.testing.assert_allclose(host(m.output(x)), host(m2.output(x)),
                               rtol=1e-6)


def _rel_err(got, want):
    """max |got - want| / (|want| + RMS(want)): each element to its own
    size, as chip_smoke.py's flash_err."""
    got, want = host(got).astype(np.float64), host(want).astype(np.float64)
    rms = np.sqrt(np.mean(want ** 2))
    return float((np.abs(got - want) / (np.abs(want) + rms)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("head_size", [64, 320])
def test_cuda_self_attention_takes_bf16_flash_route(head_size):
    """On the card an f32 SelfAttentionLayer(use_flash=True) at t 512
    casts q, k and v to bf16 (the reference's rule on its accelerator)
    and launches K4 once a forward.  Its output and its input gradient
    agree with the CPU's f32 within bf16 rounding (3e-2 of each
    element's size).  Past head size 256 (320) the chunked kernels take
    it, as the reference's kernels take any head size; it raised
    before they existed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import importlib
    fa = importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.utils.convert import load_numpy_params
    from deeplearning4j_torch.utils.trees import map_leaves
    P = conf_ns("deeplearning4j_torch")
    t, d = 512, 2 * head_size

    def net():
        return MultiLayerNetwork(
            P.NeuralNetConfiguration.builder().seed(3).list()
            .layer(P.SelfAttentionLayer(n_heads=2, head_size=head_size,
                                        n_out=16, use_flash=True))
            .layer(P.GlobalPoolingLayer(pooling_type="avg"))
            .layer(_softmax_out(P, 2))
            .set_input_type(P.InputType.recurrent(d)).build())
    cpu = net().init(device="cpu")
    card = load_numpy_params(net(), map_leaves(
        lambda a: a.numpy(), cpu.params_tree), device="cuda")
    r = np.random.default_rng(9)
    x = r.normal(size=(2, t, d)).astype(np.float32)
    mask = (np.arange(t)[None] < np.array([t, 300])[:, None]).astype(
        np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1]]
    before = fa.flash_fwd_single.launches
    out = card.output(x, features_mask=mask)
    torch.cuda.synchronize()
    assert fa.flash_fwd_single.launches - before == 1
    assert _rel_err(out, cpu.output(x, features_mask=mask)) <= 3e-2
    from deeplearning4j_torch.data.dataset import DataSet
    grads = [port_loss_grads(n, DataSet(x, y, features_mask=mask))[1]
             for n in (card, cpu)]
    for k in ("Wq", "Wk", "Wv", "Wo"):
        g, w = grads[0]["layer_0"][k], grads[1]["layer_0"][k]
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 3e-2, k
