"""The port's ONNX importer (``deeplearning4j_torch.autodiff.onnx_import``
over its copy of ``onnx_serde``) against the JAX package's and torch's
own forwards: the hand-built graphs of ``tests/test_onnx_import.py`` (an
MLP with Gemm, a small CNN, the attention block and the optional-input
and padding cases) and the ``torch.onnx.export`` files of
``tests/test_onnx_real_export.py`` (MLP, ResNet-18, LSTM, BiLSTM, GRU)
give the same outputs in both packages; the attention block fuses in
neither (the rewrite needs ``matmul(transpose_b)``, the importer emits
``Transpose`` + ``MatMul``), though the graph is logged as
attention-shaped."""
import logging

import numpy as np
import pytest
import torch

from deeplearning4j_torch.autodiff import onnx_serde as O
from torch_graph_util import npv, ns

pytest.importorskip("jax")
BOTH = ("port", "jax")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_both(model, feeds, outs):
    """{which: {out: numpy}} of ``model`` imported by both packages."""
    res = {}
    for which in BOTH:
        sd = ns(which).import_onnx_model(model)
        res[which] = {k: npv(v) for k, v in sd.output(feeds, outs).items()}
    return res


def _assert_both(res, expected, atol=1e-5):
    for which in BOTH:
        for k, want in expected.items():
            np.testing.assert_allclose(res[which][k], want, atol=atol,
                                       err_msg=f"{which} {k}")
    for k in expected:
        np.testing.assert_allclose(res["port"][k], res["jax"][k],
                                   atol=1e-5)


def test_wire_codec_roundtrip_and_reference_codec_agree(tmp_path):
    from deeplearning4j_tpu.autodiff import onnx_serde as RO
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    ints = rng.integers(-5, 5, size=7).astype(np.int64)
    m = O.model(
        [O.node("MatMul", ["x", "w"], ["y"]),
         O.node("Relu", ["y"], ["out"], alpha_test=0.5)],
        [O.value_info("x", (None, 4))],
        [O.value_info("out", (None, 3))],
        [O.tensor("w", w), O.tensor("ids", ints)])
    p = str(tmp_path / "m.onnx")
    O.save_model(m, p)
    m2 = O.load_model(p)
    g = m2["graph"]
    assert [n["op_type"] for n in g["node"]] == ["MatMul", "Relu"]
    np.testing.assert_array_equal(O.tensor_to_numpy(g["initializer"][0]), w)
    np.testing.assert_array_equal(O.tensor_to_numpy(g["initializer"][1]),
                                  ints)
    assert m2 == RO.load_model(p)
    raw = O.encode(m, O.MODEL)
    assert O.decode(raw, O.MODEL) == RO.decode(raw, RO.MODEL)
    bits = np.asarray([0x3FC0, 0xBE80], np.uint16)
    t = {"name": "b", "dims": [2], "data_type": O.DT_BF16,
         "raw_data": bits.tobytes()}
    np.testing.assert_array_equal(O.tensor_to_numpy(t), [1.5, -0.25])


def _mlp_model():
    torch.manual_seed(0)
    net = torch.nn.Sequential(
        torch.nn.Linear(6, 16), torch.nn.ReLU(),
        torch.nn.Linear(16, 8), torch.nn.Tanh(),
        torch.nn.Linear(8, 3), torch.nn.Softmax(dim=-1))
    lin = [m for m in net if isinstance(m, torch.nn.Linear)]
    inits, nodes, prev = [], [], "x"
    for i, l in enumerate(lin):
        inits += [O.tensor(f"w{i}", l.weight.detach().numpy()),
                  O.tensor(f"b{i}", l.bias.detach().numpy())]
        nodes.append(O.node("Gemm", [prev, f"w{i}", f"b{i}"], [f"h{i}"],
                            alpha=1.0, beta=1.0, transB=1))
        prev = f"h{i}"
        if i < 2:
            nodes.append(O.node("Relu" if i == 0 else "Tanh", [prev],
                                [f"a{i}"]))
            prev = f"a{i}"
    nodes.append(O.node("Softmax", [prev], ["out"], axis=-1))
    return net, O.model(nodes, [O.value_info("x", (None, 6))],
                        [O.value_info("out", (None, 3))], inits)


def test_mlp_gemm_golden_vs_torch():
    net, m = _mlp_model()
    x = np.random.default_rng(1).normal(size=(5, 6)).astype(np.float32)
    with torch.no_grad():
        expected = net(torch.tensor(x)).numpy()
    _assert_both(_run_both(m, {"x": x}, ["out"]), {"out": expected})
    assert ns("port").import_onnx_model(m).vars["w0"].var_type == \
        "VARIABLE"


def test_cnn_golden_vs_torch():
    torch.manual_seed(1)
    conv = torch.nn.Conv2d(3, 8, 3, stride=1, padding=1)
    bn = torch.nn.BatchNorm2d(8).eval()
    bn.running_mean.data = torch.randn(8) * 0.1
    bn.running_var.data = torch.rand(8) + 0.5
    fc = torch.nn.Linear(8, 4)
    x = np.random.default_rng(2).normal(size=(2, 3, 8, 8)).astype(
        np.float32)
    with torch.no_grad():
        h = torch.relu(bn(conv(torch.tensor(x))))
        h = torch.nn.functional.max_pool2d(h, 2).mean(dim=(2, 3))
        expected = fc(h).numpy()
    inits = [O.tensor(n, p.detach().numpy()) for n, p in (
        ("cw", conv.weight), ("cb", conv.bias), ("g", bn.weight),
        ("beta", bn.bias), ("mu", bn.running_mean),
        ("var", bn.running_var), ("fw", fc.weight), ("fb", fc.bias))]
    nodes = [
        O.node("Conv", ["x", "cw", "cb"], ["c"], strides=[1, 1],
               pads=[1, 1, 1, 1], group=1, dilations=[1, 1]),
        O.node("BatchNormalization", ["c", "g", "beta", "mu", "var"],
               ["bn"], epsilon=float(bn.eps)),
        O.node("Relu", ["bn"], ["r"]),
        O.node("MaxPool", ["r"], ["p"], kernel_shape=[2, 2],
               strides=[2, 2]),
        O.node("GlobalAveragePool", ["p"], ["gap"]),
        O.node("Flatten", ["gap"], ["fl"], axis=1),
        O.node("Gemm", ["fl", "fw", "fb"], ["out"], transB=1),
    ]
    m = O.model(nodes, [O.value_info("x", (None, 3, 8, 8))],
                [O.value_info("out", (None, 4))], inits)
    _assert_both(_run_both(m, {"x": x}, ["out"]), {"out": expected},
                 atol=2e-5)


def attention_block_model(b=2, t=6, d=8, seed=3):
    """The attention block of tests/test_onnx_import.py: (the model,
    its input, torch's output)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    wq, wk, wv = (rng.normal(size=(d, d)).astype(np.float32)
                  for _ in range(3))
    ln_g = rng.normal(size=(d,)).astype(np.float32)
    ln_b = rng.normal(size=(d,)).astype(np.float32)
    with torch.no_grad():
        tx = torch.tensor(x)
        q, k, v = (tx @ torch.tensor(w) for w in (wq, wk, wv))
        s = (q @ k.transpose(-1, -2)) / np.sqrt(d)
        att = torch.softmax(s, -1) @ v
        expected = torch.nn.functional.layer_norm(
            att, (d,), torch.tensor(ln_g), torch.tensor(ln_b)).numpy()
    inits = [O.tensor("wq", wq), O.tensor("wk", wk), O.tensor("wv", wv),
             O.tensor("ln_g", ln_g), O.tensor("ln_b", ln_b),
             O.tensor("scale", np.float32(1.0 / np.sqrt(d)))]
    nodes = [
        O.node("MatMul", ["x", "wq"], ["q"]),
        O.node("MatMul", ["x", "wk"], ["k"]),
        O.node("MatMul", ["x", "wv"], ["v"]),
        O.node("Transpose", ["k"], ["kT"], perm=[0, 2, 1]),
        O.node("MatMul", ["q", "kT"], ["qk"]),
        O.node("Mul", ["qk", "scale"], ["scaled"]),
        O.node("Softmax", ["scaled"], ["probs"], axis=-1),
        O.node("MatMul", ["probs", "v"], ["ctx"]),
        O.node("LayerNormalization", ["ctx", "ln_g", "ln_b"], ["out"],
               axis=-1, epsilon=1e-5),
    ]
    m = O.model(nodes, [O.value_info("x", (b, t, d))],
                [O.value_info("out", (b, t, d))], inits)
    return m, x, expected


def test_attention_block_golden_and_fuses_in_neither(caplog):
    m, x, expected = attention_block_model()
    _assert_both(_run_both(m, {"x": x}, ["out"]), {"out": expected})
    counts = {}
    for which in BOTH:
        N = ns(which)
        sd = N.import_onnx_model(m)
        with caplog.at_level(logging.WARNING):
            counts[which] = N.optimize_for_tpu(sd)
        assert not any(n.op_name == "fused_attention" for n in sd.ops)
        got = npv(sd.output({"x": x}, ["out"])["out"])
        np.testing.assert_allclose(got, expected, atol=1e-5)
    assert counts["port"] == counts["jax"]
    assert counts["port"]["attention"] == 0
    assert counts["port"]["parallel_matmuls"] == 1
    assert sum("looks attention-shaped" in r.getMessage()
               for r in caplog.records) == 2


@pytest.mark.parametrize("which", BOTH)
def test_optional_input_positions(which):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    N = ns(which)
    m = O.model([{"op_type": "Clip", "input": ["x", "", "mx"],
                  "output": ["out"], "name": "clip", "attribute": []}],
                [O.value_info("x", (3, 4))], [O.value_info("out", (3, 4))],
                [O.tensor("mx", np.float32(0.25))])
    got = npv(N.import_onnx_model(m).output({"x": x}, ["out"])["out"])
    np.testing.assert_allclose(got, np.minimum(x, 0.25), atol=1e-6)
    m = O.model([{"op_type": "Slice", "input": ["x", "st", "en", "", "sp"],
                  "output": ["out"], "name": "sl", "attribute": []}],
                [O.value_info("x", (3, 4))], [O.value_info("out", (2, 2))],
                [O.tensor("st", np.asarray([0, 0], np.int64)),
                 O.tensor("en", np.asarray([3, 4], np.int64)),
                 O.tensor("sp", np.asarray([2, 2], np.int64))])
    got = npv(N.import_onnx_model(m).output({"x": x}, ["out"])["out"])
    np.testing.assert_allclose(got, x[::2, ::2], atol=1e-6)
    m = O.model([O.node("Gemm", ["x", "w", ""], ["out"], transB=0)],
                [O.value_info("x", (3, 4))], [O.value_info("out", (3, 5))],
                [O.tensor("w", rng.normal(size=(4, 5)).astype(np.float32))])
    sd = N.import_onnx_model(m)
    got = npv(sd.output({"x": x}, ["out"])["out"])
    np.testing.assert_allclose(got, x @ sd.values["w"], atol=1e-5)


@pytest.mark.parametrize("which", BOTH)
def test_split_sizes_pads_same_lower_and_opset_rules(which):
    N = ns(which)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    m = O.model([O.node("Split", ["x"], ["a", "b"], axis=0, split=[1, 4])],
                [O.value_info("x", (5, 3))],
                [O.value_info("a", (1, 3)), O.value_info("b", (4, 3))], [])
    outs = N.import_onnx_model(m).output({"x": x}, ["a", "b"])
    np.testing.assert_allclose(npv(outs["a"]), x[:1], atol=1e-6)
    np.testing.assert_allclose(npv(outs["b"]), x[1:], atol=1e-6)
    xi = rng.normal(size=(1, 2, 4, 4)).astype(np.float32)
    expected = torch.nn.functional.avg_pool2d(
        torch.tensor(xi), 2, stride=2, padding=1,
        count_include_pad=True).numpy()
    m = O.model([O.node("AveragePool", ["x"], ["out"], kernel_shape=[2, 2],
                        strides=[2, 2], pads=[1, 1, 1, 1],
                        count_include_pad=1)],
                [O.value_info("x", (1, 2, 4, 4))],
                [O.value_info("out", (1, 2, 3, 3))], [])
    got = npv(N.import_onnx_model(m).output({"x": xi}, ["out"])["out"])
    np.testing.assert_allclose(got, expected, atol=1e-5)
    x5 = rng.normal(size=(1, 2, 5, 5)).astype(np.float32)
    w = rng.normal(size=(3, 2, 2, 2)).astype(np.float32)
    expected = torch.nn.functional.conv2d(
        torch.nn.functional.pad(torch.tensor(x5), (1, 0, 1, 0)),
        torch.tensor(w)).numpy()
    m = O.model([O.node("Conv", ["x", "w"], ["out"], strides=[1, 1],
                        auto_pad="SAME_LOWER", dilations=[1, 1], group=1,
                        kernel_shape=[2, 2])],
                [O.value_info("x", (1, 2, 5, 5))],
                [O.value_info("out", (1, 3, 5, 5))], [O.tensor("w", w)])
    got = npv(N.import_onnx_model(m).output({"x": x5}, ["out"])["out"])
    np.testing.assert_allclose(got, expected, atol=1e-5)
    x2 = rng.normal(size=(2, 3)).astype(np.float32)
    m = O.model([O.node("Unsqueeze", ["x"], ["out"], axes=[-1, -3])],
                [O.value_info("x", (2, 3))],
                [O.value_info("out", (2, 1, 3, 1))], [], opset_version=11)
    got = npv(N.import_onnx_model(m).output({"x": x2}, ["out"])["out"])
    np.testing.assert_array_equal(got, x2[:, None, :, None])
    x3 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    m = O.model([O.node("Softmax", ["x"], ["out"])],
                [O.value_info("x", (2, 3, 4))],
                [O.value_info("out", (2, 3, 4))], [], opset_version=11)
    got = npv(N.import_onnx_model(m).output({"x": x3}, ["out"])["out"])
    e = np.exp(x3.reshape(2, 12) - x3.reshape(2, 12).max(-1, keepdims=True))
    np.testing.assert_allclose(got, (e / e.sum(-1, keepdims=True))
                               .reshape(2, 3, 4), atol=1e-5)


def test_unknown_op_fails_loudly():
    m = O.model([O.node("TotallyMadeUp", ["x"], ["y"])],
                [O.value_info("x", (2, 2))], [O.value_info("y", (2, 2))],
                [])
    with pytest.raises(NotImplementedError, match="TotallyMadeUp"):
        ns("port").import_onnx_model(m)


# ---------------------------------------------------------------------------
# Files written by torch.onnx.export
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def exporter():
    import importlib
    return importlib.import_module("test_onnx_real_export")


def _exported_both(exporter, tmp_path, module, args, outs, **kw):
    p = str(tmp_path / "m.onnx")
    exporter._export(module, args, p, input_names=["x"],
                     output_names=outs, **kw)
    model = O.load_model(p)
    return _run_both(model, {"x": args[0].numpy()}, outs)


def test_torch_exported_mlp(exporter, tmp_path):
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.ReLU(),
                            torch.nn.Linear(16, 8), torch.nn.Tanh(),
                            torch.nn.Linear(8, 3))
    x = torch.tensor(np.random.default_rng(0).normal(
        size=(5, 6)).astype(np.float32))
    with torch.no_grad():
        expected = m(x).numpy()
    res = _exported_both(exporter, tmp_path, m, (x,), ["out"],
                         dynamic_axes={"x": {0: "b"}})
    _assert_both(res, {"out": expected})


def test_torch_exported_resnet18(exporter, tmp_path):
    torch.manual_seed(0)
    m = exporter._ResNet18().eval()
    x = torch.tensor(np.random.default_rng(1).normal(
        size=(2, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        expected = m(x).numpy()
    res = _exported_both(exporter, tmp_path, m, (x,), ["out"])
    for which in BOTH:
        np.testing.assert_allclose(res[which]["out"], expected, atol=5e-4)
    np.testing.assert_allclose(res["port"]["out"], res["jax"]["out"],
                               atol=5e-4)


@pytest.mark.parametrize("kind", ["lstm", "bilstm", "gru"])
def test_torch_exported_recurrent(exporter, tmp_path, kind):
    torch.manual_seed(0)
    if kind == "gru":
        m = torch.nn.GRU(input_size=4, hidden_size=5)
        outs = ["y", "h"]
    else:
        m = torch.nn.LSTM(input_size=4, hidden_size=6,
                          bidirectional=kind == "bilstm")
        outs = ["y", "h", "c"]
    x = torch.randn(5, 2, 4)
    with torch.no_grad():
        got = m(x)
    flat = [got[0]] + (list(got[1]) if kind != "gru" else [got[1]])
    expected = {k: v.numpy() for k, v in zip(outs, flat)}
    res = _exported_both(exporter, tmp_path, m, (x,), outs)
    _assert_both(res, expected)
