"""The port's graph rewrites (``deeplearning4j_torch.autodiff.rewrites``)
against the JAX package's: the cases of ``tests/test_rewrites.py`` in
both packages (the same fusions fire or are refused, outputs and
gradients equal); ``optimize_for_tpu``'s counts on the tiny BERT and on
the graph-only BERT-base equal the reference's (the counts the chip
smoke asserts on the card); and the ``DL4J_TPU_REWRITE_CHECK`` shape
probe, which the port runs on ``meta`` tensors."""
import numpy as np
import pytest
import torch

import chip_smoke
from torch_graph_util import (BERT_BASE_GRAPH_ONLY, BERT_TINY,
                              BERT_TINY_GOLD, npv, ns)

pytest.importorskip("jax")
BOTH = ("port", "jax")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _attention_ir(N, with_bias=True, scale_after_add=False):
    """Hand-built BERT-style attention: q/k/v placeholders [b,h,t,d]."""
    sd = N.create()
    q = sd.placeholder("q", (2, 2, 8, 4))
    k = sd.placeholder("k", (2, 2, 8, 4))
    v = sd.placeholder("v", (2, 2, 8, 4))
    s = sd.op("matmul", q, k, transpose_b=True, name="qk")
    if scale_after_add:   # invalid ordering: scale would hit the bias
        b = sd.placeholder("bias", (2, 1, 1, 8))
        s = sd.op("add", s, b, name="masked")
        s = sd.op("div", s, sd.constant("scale", np.float32(2.0)),
                  name="scaled")
    else:
        s = sd.op("div", s, sd.constant("scale", np.float32(2.0)),
                  name="scaled")
        if with_bias:
            b = sd.placeholder("bias", (2, 1, 1, 8))
            s = sd.op("add", s, b, name="masked")
        s = sd.op("add", s, sd.constant("zero", np.float32(0.0)),
                  name="shifted")
    p = sd.op("softmax", s, name="probs")
    p = sd.op("identity", p, name="drop")
    out = sd.op("matmul", p, v, name="context")
    return sd, out.name


def _feeds(with_bias=True, seed=0):
    rng = np.random.default_rng(seed)
    f = {n: rng.normal(size=(2, 2, 8, 4)).astype(np.float32) for n in "qkv"}
    if with_bias:
        bias = np.zeros((2, 1, 1, 8), np.float32)
        bias[:, :, :, 6:] = -1e9
        f["bias"] = bias
    return f


def test_fuse_attention_parity_with_bias():
    feeds = _feeds()
    res = []
    for which in BOTH:
        N = ns(which)
        sd, out = _attention_ir(N)
        before = npv(sd.output(feeds, [out])[out])
        assert N.fuse_attention(sd) == 1
        ops = [o.op_name for o in sd.ops]
        assert "fused_attention" in ops and "softmax" not in ops
        fused = next(o for o in sd.ops if o.op_name == "fused_attention")
        assert fused.attrs["scale"] == pytest.approx(0.5)
        assert len(fused.inputs) == 4
        after = npv(sd.output(feeds, [out])[out])
        np.testing.assert_allclose(after, before, atol=2e-6)
        res.append((sd.to_dict(), after))
    assert res[0][0] == res[1][0]
    np.testing.assert_allclose(res[0][1], res[1][1], atol=1e-5)


def test_fuse_attention_no_bias_gradient_equals_reference():
    feeds = _feeds(with_bias=False)
    grads = []
    for which in BOTH:
        N = ns(which)
        sd, out = _attention_ir(N, with_bias=False)
        w = sd.var("w", np.ones((4, 4), np.float32) * 0.3)
        proj = sd.op("matmul", sd.vars[out], w, name="proj")
        sd.set_loss_variables(sd.reduce_mean(sd.op("square", proj),
                                             name="loss"))
        g0 = npv(sd.calculate_gradients(feeds)["w"])
        assert N.fuse_attention(sd) == 1
        g1 = npv(sd.calculate_gradients(feeds)["w"])
        np.testing.assert_allclose(g1, g0, atol=2e-6)
        grads.append(g1)
    np.testing.assert_allclose(grads[0], grads[1], atol=1e-6)


@pytest.mark.parametrize("which", BOTH)
def test_fuse_attention_refusals(which):
    N = ns(which)
    sd, _ = _attention_ir(N, scale_after_add=True)
    assert N.fuse_attention(sd) == 0      # softmax((qk+b)*s) != ...
    sd, _ = _attention_ir(N, with_bias=False)
    sd.op("reduce_sum", sd.vars["probs"], name="probe")
    assert N.fuse_attention(sd) == 0      # a second consumer of probs


def test_fused_zip_roundtrip(tmp_path):
    N = ns("port")
    sd, out = _attention_ir(N)
    feeds = _feeds()
    N.fuse_attention(sd)
    before = npv(sd.output(feeds, [out])[out])
    p = str(tmp_path / "fused.sdz")
    sd.save(p)
    after = npv(N.load(p).output(feeds, [out])[out])
    np.testing.assert_allclose(after, before, atol=1e-6)


def _matmuls(N, same_input=True, rank3=False):
    rng = np.random.default_rng(0)
    sd = N.create()
    shape = (None, 6, 8) if rank3 else (None, 8)
    x1 = sd.placeholder("x", shape)
    x2 = x1 if same_input else sd.placeholder("x2", shape)
    for i, (x, n) in enumerate(((x1, 3), (x2, 5), (x1, 3))):
        w = sd.var(f"w{i + 1}", rng.normal(size=(8, n)).astype(np.float32))
        sd.op("matmul", x, w, name=f"y{i + 1}")
    return sd


@pytest.mark.parametrize("which", BOTH)
def test_fuse_parallel_matmuls_requires_equal_inputs(which):
    N = ns(which)
    assert N.rewrites.fuse_parallel_matmuls(
        _matmuls(N, same_input=False)) == 1   # w1 and w3 share x only


@pytest.mark.parametrize("rank3", [False, True])
def test_fuse_parallel_matmuls_numerics_and_grads(rank3):
    x = np.random.default_rng(0).normal(
        size=(2, 6, 8) if rank3 else (4, 8)).astype(np.float32)
    res = []
    for which in BOTH:
        N = ns(which)
        sd = _matmuls(N, rank3=rank3)
        base = {k: npv(v) for k, v in sd.output(
            {"x": x}, ["y1", "y2", "y3"]).items()}
        assert N.rewrites.fuse_parallel_matmuls(sd) == 1
        fused = {k: npv(v) for k, v in sd.output(
            {"x": x}, ["y1", "y2", "y3"]).items()}
        for k in base:
            assert fused[k].shape == base[k].shape
            np.testing.assert_allclose(fused[k], base[k], atol=1e-6)
        sd.set_loss_variables(sd.reduce_mean(
            sd.op("square", sd.vars["y2"]), name="l"))
        g = {k: npv(v) for k, v in sd.calculate_gradients(
            {"x": x}, wrt=["w2", "w1"]).items()}
        assert np.abs(g["w2"]).max() > 0
        np.testing.assert_allclose(g["w1"], 0, atol=1e-7)
        res.append((fused, g))
    for k in res[1][0]:
        np.testing.assert_allclose(res[0][0][k], res[1][0][k], atol=1e-5)
    np.testing.assert_allclose(res[0][1]["w2"], res[1][1]["w2"], atol=1e-5)


@pytest.mark.parametrize("which", BOTH)
def test_fuse_gelu_rejects_wrong_sign(which):
    N = ns(which)
    sd = N.create()
    xp = sd.placeholder("x", (None, 8))
    hm = sd.op("mul", sd.constant("half", np.float32(0.5)), xp, name="hm")
    ng = sd.op("neg", xp, name="ng")
    inner = sd.op("mul", sd.constant("c", np.float32(-0.7071067811865476)),
                  ng, name="inner")
    sd.op("mul", hm, sd.op("erfc", inner, name="ec"), name="out")
    assert N.rewrites.fuse_gelu(sd) == 0


def test_optimize_for_tpu_counts_and_parity_on_tiny_bert():
    """The same rewritten graph as the reference's (its outputs against
    the reference's are held in tests/test_torch_tf_import.py), and the
    goldens."""
    g = np.load(BERT_TINY_GOLD)
    dicts = []
    for which in BOTH:
        N = ns(which)
        sd = N.import_frozen_pb(BERT_TINY)
        counts = N.optimize_for_tpu(sd)
        assert counts == {"parallel_matmuls": 2, "layer_norm": 5,
                          "gelu": 2, "attention": 2, "flatten_reshapes": 8}
        for n in sd.ops:
            if n.op_name == "matmul" and "expect_k" in n.attrs:
                assert n.attrs["expect_k"] in (64, 128)
        dicts.append(sd.to_dict())
    assert dicts[0] == dicts[1]
    port = ns("port").import_frozen_pb(BERT_TINY)
    ns("port").optimize_for_tpu(port)
    out = npv(port.output({"i": g["ids"], "m": g["mask"], "t": g["tt"]},
                          ["Identity"])["Identity"])
    np.testing.assert_allclose(out, g["last_hidden"], atol=3e-5)


def _split_ir(N, split_axis):
    sd = N.create()
    sd.placeholder("x", (2, 3, 4))
    shp = sd.constant("shp", np.array([6, 4], np.int64))
    flat = sd.op("reshape", sd.vars["x"], shp, name="flat")
    w = sd.var("W", value=np.random.default_rng(0).normal(
        size=(4, 6)).astype(np.float32))
    mm = sd.op("matmul", flat, w, name="mm")
    parts = sd.op("split", mm, n_out=2, num_split=2, axis=split_axis,
                  name="sp")
    shp2 = sd.constant("shp2", np.array([2, 3, 3], np.int64))
    return sd, [sd.op("reshape", p, shp2, name=f"out{i}").name
                for i, p in enumerate(parts)]


@pytest.mark.parametrize("axis,expect_folds", [(-1, 1), (1, 0)])
def test_fold_flatten_reshapes_split_axis_guard(axis, expect_folds):
    x = np.random.default_rng(1).normal(size=(2, 3, 4)).astype(np.float32)
    for which in BOTH:
        N = ns(which)
        sd, outs = _split_ir(N, axis)
        before = sd.output({"x": x}, outs)
        assert N.rewrites.fold_flatten_reshapes(sd) == expect_folds
        after = sd.output({"x": x}, outs)
        for name in outs:
            np.testing.assert_allclose(npv(after[name]), npv(before[name]),
                                       atol=1e-6)


def test_graph_only_bert_base_rewrites_as_the_reference():
    """12 fused attention sites, and the reference's counts — the ones
    the chip smoke asserts on the card (``BERT_BASE_REWRITES``)."""
    res = []
    for which in BOTH:
        N = ns(which)
        sd = N.import_frozen_pb(BERT_BASE_GRAPH_ONLY)
        res.append((N.optimize_for_tpu(sd), sd.to_dict()))
    assert res[0][0] == res[1][0] == chip_smoke.BERT_BASE_REWRITES
    assert res[0][0]["attention"] == 12
    assert res[0][1] == res[1][1]


def test_rewrite_check_probe(monkeypatch):
    """``DL4J_TPU_REWRITE_CHECK=1``: the passes run under the meta-tensor
    shape probe with the same counts, and a pass that changes an output
    shape fails at rewrite time."""
    monkeypatch.setenv("DL4J_TPU_REWRITE_CHECK", "1")
    N = ns("port")
    sd = N.import_frozen_pb(BERT_TINY)
    sig = N.rewrites._shape_signature(sd)
    assert sig[1]["Identity"] == ((2, 16, 64), "float32")
    assert N.optimize_for_tpu(sd)["attention"] == 2

    sd2, outs = _split_ir(N, -1)
    shp2 = sd2.values["shp2"]

    def bad():
        sd2.values["shp2"] = np.array([3, 2, 3], np.int64)
        sd2._fn_cache.clear()
        return 1
    with pytest.raises(AssertionError, match="changed inferred outputs"):
        N.rewrites._run_rewrite_pass(sd2, "bad", bad)
    sd2.values["shp2"] = shp2
