"""The PyTorch port's decoder stack and generator against the JAX package.

Two nets, each loaded into BOTH packages: the checked-in pangrams
checkpoint (trained, 2 x 64, vocab 28) — the port reads the zip with
numpy alone — and a seeded tiny ``zoo.Gpt`` (2 x 32, 4 heads) whose JAX
``params_tree`` is carried over with ``utils.convert.load_numpy_params``.
Inputs are made from a seed with numpy.  Tolerances: f32 forward /
logits 1e-5 (the same ops on two backends' BLAS, summed in different
orders); greedy token streams exactly equal."""
import io
import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models.generation import (  # noqa: E402
    TransformerGenerator as JaxGenerator)
from deeplearning4j_tpu.models.generation import (  # noqa: E402
    _filter_logits as jax_filter, _filter_logits_rows as jax_filter_rows)
from deeplearning4j_tpu.utils.model_serializer import (  # noqa: E402
    restore_model as jax_restore)
from deeplearning4j_tpu.zoo.gpt import Gpt as JaxGpt  # noqa: E402

from deeplearning4j_torch.models import generation as tgen  # noqa: E402
from deeplearning4j_torch.models.generation import (  # noqa: E402
    TransformerGenerator)
from deeplearning4j_torch.models.multi_layer_network import (  # noqa: E402
    MultiLayerNetwork)
from deeplearning4j_torch.nn.conf.builder import (  # noqa: E402
    MultiLayerConfiguration)
from deeplearning4j_torch.utils import (load_numpy_params,  # noqa: E402
                                        restore_model, write_model)
from deeplearning4j_torch.zoo import Gpt  # noqa: E402

PANGRAMS = "deeplearning4j_tpu/zoo/weights/Gpt_pangrams-char.zip"
TINY = dict(vocab_size=50, max_len=32, d_model=32, n_layers=2, n_heads=4,
            d_ff=64, seq_len=8, compute_dtype=None, seed=3)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def nets():
    """name -> (JAX net, port net).  pangrams: the port restores the zip;
    tiny: the port carries the JAX params over."""
    jp = jax_restore(PANGRAMS)
    jt = JaxGpt(**TINY).init_graph()
    pt = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jt.conf.to_json()))
    load_numpy_params(pt, _np_tree(jt.params_tree), device="cpu")
    return {"pangrams": (jp, restore_model(PANGRAMS, device="cpu")),
            "tiny": (jt, pt)}


def _vocab(net):
    return net.layers[0].n_in


def test_config_json_matches_reference():
    """Same builder calls, same configuration.json — the tiny and the
    default-width Gpt (no weights needed)."""
    for kw in (TINY, {}):
        assert Gpt(**kw).conf().to_dict() == JaxGpt(**kw).conf().to_dict()


def test_pangrams_converter_and_zip_agree(nets):
    """Both routes into the port — numpy zip read and the JAX tree
    carried over — give the same tensors."""
    jnet, pnet = nets["pangrams"]
    conv = MultiLayerNetwork(pnet.conf)
    load_numpy_params(conv, _np_tree(jnet.params_tree), device="cpu")
    for lname, leaves in pnet.params_tree.items():
        for name, t in leaves.items():
            assert torch.equal(t, conv.params_tree[lname][name]), name


@pytest.mark.parametrize("which", ["pangrams", "tiny"])
def test_forward_matches_jax(nets, which):
    jnet, pnet = nets[which]
    rng = np.random.default_rng(0)
    ids = rng.integers(0, _vocab(pnet), (3, 20)).astype(np.int32)
    ref = np.asarray(jnet._forward_infer(jnet.params_tree, jnet.state_tree,
                                         jnp.asarray(ids)))
    out = pnet.output(ids).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("which", ["pangrams", "tiny"])
def test_greedy_generate_matches_jax(nets, which):
    jnet, pnet = nets[which]
    rng = np.random.default_rng(1)
    for t0, n_new in ((3, 12), (9, 8)):
        prompts = rng.integers(0, _vocab(pnet), (2, t0)).astype(np.int32)
        ref = JaxGenerator(jnet).generate(prompts, n_new=n_new)
        out = TransformerGenerator(pnet, device="cpu").generate(
            prompts, n_new=n_new)
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out, np.asarray(ref))


def test_step_paged_matches_jax(nets):
    """One paged decode tick on the same pool, tables and tokens: logits
    and the written pool rows agree (1e-5)."""
    jnet, pnet = nets["tiny"]
    rng = np.random.default_rng(2)
    B, h, dh, bs, mb, nb, nl = 3, 4, 8, 4, 4, 13, 2
    kc = rng.normal(size=(nl, nb, h, bs, dh)).astype(np.float32)
    vc = rng.normal(size=(nl, nb, h, bs, dh)).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, nb))[:mb]
                      for _ in range(B)]).astype(np.int32)
    pos = np.asarray([0, 6, 13], np.int32)
    tok = rng.integers(0, 50, B).astype(np.int32)
    wblk = table[np.arange(B), pos // bs].astype(np.int32)
    woff = (pos % bs).astype(np.int32)

    jg = JaxGenerator(jnet)
    emb, blks, head = jg._params()
    jl, jkc, jvc = jg._step_paged(emb, jg._stack_blocks(blks), head,
                                  jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(tok), jnp.asarray(pos),
                                  jnp.asarray(table), jnp.asarray(wblk),
                                  jnp.asarray(woff))
    pg = TransformerGenerator(pnet, device="cpu")
    emb_p, blk_ps, head_p = pg._serving_params()
    t = torch.from_numpy
    pkc, pvc = t(kc.copy()), t(vc.copy())
    pl, pkc, pvc = pg._step_paged(emb_p, blk_ps, head_p, pkc, pvc, t(tok),
                                  t(pos), t(table), t(wblk), t(woff))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(pkc.numpy(), np.asarray(jkc), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(pvc.numpy(), np.asarray(jvc), atol=1e-5,
                               rtol=0)


def test_filters_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 30)).astype(np.float32)
    top_k = np.asarray([30, 5, 1, 12], np.int32)
    top_p = np.asarray([1.0, 0.9, 0.5, 0.3], np.float32)
    ref = np.asarray(jax_filter_rows(jnp.asarray(logits),
                                     jnp.asarray(top_k),
                                     jnp.asarray(top_p)))
    out = tgen._filter_logits_rows(torch.from_numpy(logits),
                                   torch.from_numpy(top_k),
                                   torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_array_equal(out[~np.isinf(out)],
                                  ref[~np.isinf(ref)])
    for k, p in ((7, None), (None, 0.8), (4, 0.6)):
        ref = np.asarray(jax_filter(jnp.asarray(logits), k, p))
        out = tgen._filter_logits(torch.from_numpy(logits), k, p).numpy()
        np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))


def test_prefill_then_decode_equals_full_forward(nets):
    """Inside the port: the stripe decode ticks after a prefill give the
    logits a full-prompt prefill over the same tokens gives (1e-5)."""
    _, pnet = nets["pangrams"]
    g = TransformerGenerator(pnet, device="cpu")
    emb, blks, head = g._serving_params()
    ids = torch.as_tensor(np.random.default_rng(4).integers(0, 28, (2, 12)))
    t0, L = 7, 12
    logits, ks, vs = g._prefill_rows(emb, blks, head, ids[:, :t0])
    kc = torch.zeros((2, 2, 4, L, 16))
    vc = torch.zeros_like(kc)
    kc[:, :, :, :t0], vc[:, :, :, :t0] = ks, vs
    for pos in range(t0, L):
        logits, kc, vc = g._step(emb, blks, head, kc, vc, ids[:, pos], pos)
        full = g._prefill_rows(emb, blks, head, ids[:, :pos + 1])[0]
        np.testing.assert_allclose(logits.numpy(), full.numpy(),
                                   atol=1e-5, rtol=0)


def test_sampled_generate_reproducible_and_filtered(nets):
    _, pnet = nets["tiny"]
    g = TransformerGenerator(pnet, device="cpu")
    p = np.asarray([[1, 2, 3]], np.int32)
    a = g.generate(p, 10, temperature=1.0, top_k=3, seed=7)
    b = g.generate(p, 10, temperature=1.0, top_k=3, seed=7)
    np.testing.assert_array_equal(a, b)
    emb, blks, head = g._serving_params()
    for i in range(3, 13):
        lg = g._prefill_rows(emb, blks, head, torch.as_tensor(a[:, :i]))[0]
        assert int(a[0, i]) in set(torch.topk(lg[0], 3).indices.tolist())
    outs = {tuple(g.generate(p, 10, temperature=2.0, seed=s)[0])
            for s in range(6)}
    assert len(outs) > 1                     # seeds give distinct streams


def test_gelu_stack_matches_jax():
    """A stack built with ``.activation("gelu")`` in both packages: the
    same configuration JSON, and the blocks' tanh-gelu feed-forward gives
    the same forward (1e-5) and greedy stream."""
    from deeplearning4j_tpu.models.multi_layer_network import (
        MultiLayerNetwork as JaxNet)
    from deeplearning4j_tpu.nn.conf import builder as jb
    from deeplearning4j_tpu.nn.conf import inputs as ji
    from deeplearning4j_tpu.nn.conf import layers_recurrent as jr
    from deeplearning4j_tpu.nn.conf import layers_transformer as jt

    from deeplearning4j_torch.nn.conf import (EmbeddingSequenceLayer,
                                              InputType,
                                              NeuralNetConfiguration,
                                              RnnOutputLayer,
                                              TransformerEncoderBlock)

    def conf(nnc, it, emb, blk, out):
        lst = (nnc.builder().seed(5).activation("gelu").list()
               .set_input_type(it.feed_forward(8))
               .layer(emb(n_in=40, n_out=32, max_len=24)))
        for _ in range(2):
            lst = lst.layer(blk(n_heads=4, d_ff=64, causal=True))
        return lst.layer(out(n_out=40, activation="softmax",
                             loss="sparse_mcxent")).build()

    jconf = conf(jb.NeuralNetConfiguration, ji.InputType,
                 jt.EmbeddingSequenceLayer, jt.TransformerEncoderBlock,
                 jr.RnnOutputLayer)
    pconf = conf(NeuralNetConfiguration, InputType, EmbeddingSequenceLayer,
                 TransformerEncoderBlock, RnnOutputLayer)
    assert pconf.to_dict() == jconf.to_dict()
    assert pconf.layers[1].activation == "gelu"
    jnet = JaxNet(jconf).init()
    pnet = load_numpy_params(MultiLayerNetwork(pconf),
                             _np_tree(jnet.params_tree), device="cpu")
    ids = np.random.default_rng(8).integers(0, 40, (2, 12)).astype(np.int32)
    np.testing.assert_allclose(
        pnet.output(ids).numpy(), np.asarray(jnet.output(jnp.asarray(ids))),
        atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        TransformerGenerator(pnet, device="cpu").generate(ids[:, :5], 10),
        np.asarray(JaxGenerator(jnet).generate(ids[:, :5], 10)))


@pytest.mark.parametrize("name", ["gelu", "relu", "tanh", "sigmoid",
                                  "softmax", "hardsigmoid", "swish",
                                  "elu", "softplus", "identity"])
def test_activations_match_jax(name):
    """``gelu`` is jax.nn.gelu's TANH approximation in both packages."""
    from deeplearning4j_tpu.nn.activations import get_activation as jget

    from deeplearning4j_torch.nn.activations import get_activation
    x = np.random.default_rng(5).normal(size=(4, 7)).astype(np.float32) * 3
    np.testing.assert_allclose(
        get_activation(name)(torch.from_numpy(x)).numpy(),
        np.asarray(jget(name)(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


def test_layer_norm_matches_jax():
    from deeplearning4j_tpu.nn.conf.layers_transformer import (
        _layer_norm as jax_ln)

    from deeplearning4j_torch.nn.conf.layers_transformer import _layer_norm
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32) * 4 + 1
    g = rng.normal(size=(16,)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    ref = np.asarray(jax_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    out = _layer_norm(*(torch.from_numpy(a) for a in (x, g, b))).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_write_model_round_trips_through_both_packages(nets, tmp_path):
    _, pnet = nets["pangrams"]
    path = tmp_path / "rt.zip"
    write_model(pnet, path)
    back = restore_model(path, device="cpu")
    jback = jax_restore(str(path))
    for lname, leaves in pnet.params_tree.items():
        for name, t in leaves.items():
            assert torch.equal(back.params_tree[lname][name], t)
            np.testing.assert_array_equal(
                np.asarray(jback.params_tree[lname][name]), t.numpy())
    with zipfile.ZipFile(PANGRAMS) as a, zipfile.ZipFile(path) as b:
        assert json.loads(a.read("configuration.json"))["layers"] == \
            json.loads(b.read("configuration.json"))["layers"]
        ka = set(np.load(io.BytesIO(a.read("coefficients.npz"))).files)
        kb = set(np.load(io.BytesIO(b.read("coefficients.npz"))).files)
        assert ka == kb
    assert (back.iteration_count, back.epoch_count) == (480, 480)


def test_load_numpy_params_checks_shapes(nets):
    jnet, pnet = nets["tiny"]
    tree = _np_tree(jnet.params_tree)
    tree["layer_1"]["Wo"] = tree["layer_1"]["Wo"][:, :5]
    with pytest.raises(ValueError, match="Wo"):
        load_numpy_params(MultiLayerNetwork(pnet.conf), tree, device="cpu")
    del tree["layer_1"]["Wo"]
    with pytest.raises(ValueError, match="layer_1"):
        load_numpy_params(MultiLayerNetwork(pnet.conf), tree, device="cpu")


def test_default_device_is_cuda(nets):
    """Entry points default to "cuda"; without a card that default
    raises instead of quietly running on the CPU."""
    _, pnet = nets["tiny"]
    if torch.cuda.is_available():
        assert TransformerGenerator(pnet).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        restore_model(PANGRAMS)
    with pytest.raises(RuntimeError, match="cuda"):
        TransformerGenerator(pnet)
    with pytest.raises(RuntimeError, match="cuda"):
        Gpt(**TINY).init_graph()


def test_generator_validation(nets):
    _, pnet = nets["tiny"]
    g = TransformerGenerator(pnet, device="cpu")
    p = np.asarray([[1, 2, 3]], np.int32)
    with pytest.raises(ValueError, match="top_k"):
        g.generate(p, n_new=2, temperature=1.0, top_k=0)
    with pytest.raises(ValueError, match="top_k"):
        g.generate(p, n_new=2, temperature=1.0, top_k=51)
    with pytest.raises(ValueError, match="temperature"):
        g.generate(p, n_new=2, top_p=0.5)
    with pytest.raises(ValueError, match="positional"):
        g.generate(p, n_new=40)
    assert g.generate(p, n_new=2, temperature=1.0, top_k=50).shape == (1, 5)
