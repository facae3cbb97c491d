"""The graph IR (``deeplearning4j_torch.autodiff.samediff``) against the
JAX package's: each case of ``tests/test_samediff.py`` built and run in
both packages on the same seeded numpy inputs (outputs 1e-5, gradients
1e-5, fit losses 1e-5); the zip written by either package loads in the
other; the port's plan cache folds the shape chain once; and
``utils.convert.samediff_from_dict`` carries a JAX-built graph across.
The ``gpu`` cases (no JAX needed) hold ``fused_attention`` on the card to
the kernels-or-raise rule and the imported causal graph to the CPU."""
import numpy as np
import pytest
import torch

from torch_graph_util import GPT_TOY, GPT_TOY_GOLD, npv, ns

BOTH = ("port", "jax")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(N):
    sd = N.create()
    x = sd.placeholder("x", (None, 4))
    rng = np.random.default_rng(0)
    w = sd.var("w", rng.normal(size=(4, 3)).astype(np.float32))
    b = sd.var("b", np.zeros(3, np.float32))
    z = sd.matmul(x, w, name="z")
    h = sd.op("add", z, b, name="h")
    sd.softmax(h, name="y")
    return sd


def _xv(*shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(fn):
    """fn(N) in both packages -> (port result, jax result)."""
    return fn(ns("port")), fn(ns("jax"))


def _close(got, want, tol=1e-5):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    g, w = npv(got), npv(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_build_exec_mlp():
    xv = _xv(5, 4)
    got, want = _both(lambda N: _mlp(N).output({"x": xv}, ["y"])["y"])
    _close(got, want)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"


def test_operator_sugar_and_eval():
    def run(N):
        sd = N.create()
        a = sd.constant("a", np.arange(6, dtype=np.float32).reshape(2, 3))
        b = sd.constant("b", np.ones((2, 3), np.float32))
        return ((a + b) * 2.0 - 1.0).eval()
    got, want = _both(run)
    _close(got, want)
    _close(got, (np.arange(6).reshape(2, 3) + 1) * 2.0 - 1)


def _shape_graph(N):
    sd = N.create()
    x = sd.placeholder("x", (None, 3, 4))
    s = sd.op("shape", x)
    b = sd.op("strided_slice", s, [0], [1], shrink_axis_mask=1)
    tgt = sd.op("pack", b, sd.constant("m1", np.int64(-1)))
    y = sd.reshape(x, tgt, name="flat")
    return sd, y.name


def test_shape_metaprogramming_constant_folds():
    xv = np.arange(24, dtype=np.float32).reshape(2, 3, 4)

    def run(N):
        sd, y = _shape_graph(N)
        return sd.output({"x": xv}, [y])[y]
    got, want = _both(run)
    assert tuple(got.shape) == (2, 12)
    _close(got, want)


def test_plan_folds_the_shape_chain_once_per_feed_shape():
    """The port's cached plan runs only the ops that touch feeds or
    parameters; the shape chain is folded once per feed shape."""
    sd, y = _shape_graph(ns("port"))
    for b in (2, 2, 5):
        xv = np.zeros((b, 3, 4), np.float32)
        out = sd.output({"x": xv}, [y])[y]
        assert tuple(out.shape) == (b, 12)
    assert len(sd._fn_cache) == 2                  # batch 2 and batch 5
    for needed, plan in sd._fn_cache.values():
        assert [n.op_name for n in plan["nodes"]] == ["reshape"]
    sd.op("neg", sd.vars[y], name="n")             # a new op: plans reset
    assert not sd._fn_cache


def test_gradients_match_analytic():
    rng = np.random.default_rng(2)
    xv = rng.normal(size=(8, 4)).astype(np.float32)
    lv = rng.normal(size=(8, 1)).astype(np.float32)
    w0 = np.random.default_rng(1).normal(size=(4, 1)).astype(np.float32)

    def run(N):
        sd = N.create()
        x = sd.placeholder("x", (8, 4))
        w = sd.var("w", w0)
        lab = sd.placeholder("lab", (8, 1))
        diff = sd.matmul(x, w) - lab
        sd.set_loss_variables(sd.reduce_mean(sd.square(diff), name="loss"))
        return sd.calculate_gradients({"x": xv, "lab": lv}, ["w"])["w"]
    got, want = _both(run)
    _close(got, want)
    _close(got, 2.0 / 8 * xv.T @ (xv @ w0 - lv), 1e-4)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_zip_written_by_one_package_loads_in_the_other(tmp_path, writer,
                                                      reader):
    xv = _xv(3, 4)

    def build(N):
        sd = N.create()
        x = sd.placeholder("x", (None, 4))
        w = sd.var("w", np.random.default_rng(0).normal(
            size=(4, 2)).astype(np.float32))
        sd.tanh(sd.matmul(x, w), name="out")
        return sd
    W, R = ns(writer), ns(reader)
    sd = build(W)
    p = str(tmp_path / "g.sdz")
    sd.save(p)
    sd2 = R.load(p)
    assert sd2.to_dict() == sd.to_dict()
    _close(sd2.output({"x": xv}, ["out"])["out"],
           sd.output({"x": xv}, ["out"])["out"], 1e-6)


def test_fit_linear_regression_equal_losses():
    rng = np.random.default_rng(0)
    true_w = np.array([[1.5], [-2.0], [0.5]], np.float32)
    xv = rng.normal(size=(256, 3)).astype(np.float32)
    yv = xv @ true_w + 0.3

    def run(N):
        sd = N.create()
        x = sd.placeholder("x", (None, 3))
        lab = sd.placeholder("lab", (None, 1))
        w = sd.var("w", np.zeros((3, 1), np.float32))
        b = sd.var("b", np.zeros((1,), np.float32))
        pred = sd.op("add", sd.matmul(x, w), b)
        sd.set_loss_variables(sd.reduce_mean(sd.square(pred - lab),
                                             name="loss"))
        sd.set_training_config(N.TrainingConfig(
            updater=N.Adam(learning_rate=0.1),
            data_set_feature_mapping=["x"], data_set_label_mapping=["lab"]))
        it = N.ListDataSetIterator(N.DataSet(xv, yv).batch_by(64))
        losses = sd.fit(it, n_epochs=15)
        return np.asarray(losses), sd.values["w"]
    (pl, pw), (jl, jw) = _both(run)
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pw, jw, rtol=1e-5, atol=1e-5)
    assert pl[-1] < pl[0] * 0.1


def test_unknown_op_fails_at_build():
    sd = ns("port").create()
    a = sd.constant("a", np.ones(2))
    with pytest.raises(KeyError):
        sd.op("definitely_not_an_op", a)


def test_multi_output_ops():
    xv = np.arange(24, dtype=np.float32).reshape(4, 6)

    def run(N):
        sd = N.create()
        x = sd.placeholder("x", (4, 6))
        parts = sd.op("split", x, n_out=3, num_split=3, axis=1)
        assert len(parts) == 3
        sd.concat(*parts[::-1], axis=1, name="back")
        return sd.output({"x": xv}, ["back"])["back"]
    got, want = _both(run)
    _close(got, want)


def test_gather_batch_dims_matches_tf_semantics():
    rng = np.random.default_rng(0)
    pv = rng.normal(size=(2, 5, 3)).astype(np.float32)
    iv = rng.integers(0, 5, (2, 4)).astype(np.int32)

    def run(N):
        sd = N.create()
        p = sd.placeholder("p", (2, 5, 3))
        i = sd.placeholder("i", (2, 4), "int32")
        sd.op("gather", p, i, axis=1, batch_dims=1, name="g")
        return sd.output({"p": pv, "i": iv}, ["g"])["g"]
    got, want = _both(run)
    _close(got, want)
    _close(got, np.stack([pv[b][iv[b]] for b in range(2)]))


def test_variable_out_op_requires_n_out():
    sd = ns("port").create()
    x = sd.placeholder("x", (4, 6))
    with pytest.raises(ValueError, match="n_out"):
        sd.op("split", x, num_split=3, axis=1)


def test_default_device_is_the_card():
    """Entry points run on the card unless the caller passes the CPU;
    without CUDA the default raises instead of falling back."""
    from deeplearning4j_torch.autodiff import SameDiff
    if torch.cuda.is_available():
        assert SameDiff.create().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            SameDiff.create()


def test_samediff_from_dict_carries_a_jax_graph_with_its_values():
    from deeplearning4j_torch.utils.convert import samediff_from_dict
    J = ns("jax")
    sd = _mlp(J)
    sd.set_loss_variables(sd.reduce_mean(sd.vars["y"], name="loss"))
    trained = {"w": sd.values["w"] * 2.0}
    port = samediff_from_dict(sd.to_portable_dict(), trained, device="cpu")
    sd.values["w"] = trained["w"]
    xv = _xv(5, 4)
    _close(port.output({"x": xv}, ["y"])["y"],
           sd.output({"x": xv}, ["y"])["y"])
    assert port.loss_variables == ["loss"]
    with pytest.raises(ValueError, match="shape"):
        samediff_from_dict(sd.to_portable_dict(), {"w": np.zeros(3)},
                           device="cpu")
    with pytest.raises(KeyError):
        samediff_from_dict(sd.to_portable_dict(), {"nope": np.zeros(3)},
                           device="cpu")


def _fa():
    import importlib
    return importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")


@pytest.mark.gpu
def test_cuda_fused_attention_takes_the_kernels_or_raises():
    """On the card a ``fused_attention`` at t >= 512 launches the flash
    kernels (K4 forward, K5 and K6 backward) or raises; below 512 it
    takes the plain route and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deeplearning4j_torch.autodiff.ops import OP_REGISTRY, device_scope
    fa, fn = _fa(), OP_REGISTRY["fused_attention"].fn
    r = np.random.default_rng(0)

    def qkv(t):
        return [torch.tensor(r.normal(size=(2, 2, t, 64)).astype(
            np.float32), device="cuda", requires_grad=True)
            for _ in range(3)]
    names = ("flash_fwd_single", "flash_bwd_dkdv", "flash_bwd_dq")
    before = {n: getattr(fa, n).launches for n in names}
    q, k, v = qkv(512)
    bias = torch.zeros((2, 1, 1, 512), device="cuda")
    bias[1, ..., 300:] = -1e9
    with device_scope("cuda"):
        out = fn(q, k, v, bias=bias, compute_dtype="bfloat16")
        out.float().square().sum().backward()
        assert out.dtype == torch.float32
        assert {n: getattr(fa, n).launches - before[n]
                for n in names} == dict.fromkeys(names, 1)
        with pytest.raises(ValueError, match="no plain route"):
            fn(q, k, v, bias=torch.zeros((512, 512), device="cuda"),
               bias_layout="qk")
        small = fn(*qkv(256))
    assert small.shape == (2, 2, 256, 64)
    assert fa.flash_fwd_single.launches - before["flash_fwd_single"] == 1


@pytest.mark.gpu
def test_cuda_fused_attention_past_head_dim_256():
    """``fused_attention`` at head dim 320 and t 512 on the card launches
    the chunked kernels (K4, K5, K6 once each; it raised before) in f32,
    and its output and q/k/v gradients agree with the CPU's within 1e-5
    of each element's size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deeplearning4j_torch.autodiff.ops import OP_REGISTRY, device_scope
    fa, fn = _fa(), OP_REGISTRY["fused_attention"].fn
    torch.backends.cuda.matmul.allow_tf32 = False
    r = np.random.default_rng(320)
    host = [r.normal(size=(2, 2, 512, 320)).astype(np.float32)
            for _ in range(4)]
    names = ("flash_fwd_single", "flash_bwd_dkdv", "flash_bwd_dq")
    got = {}
    for dev in ("cuda", "cpu"):
        q, k, v = (torch.tensor(a, device=dev, requires_grad=True)
                   for a in host[:3])
        before = {n: getattr(fa, n).launches for n in names}
        with device_scope(dev):
            out = fn(q, k, v)
            out.backward(torch.tensor(host[3], device=dev))
        got[dev] = [x.detach().cpu().numpy().astype(np.float64)
                    for x in (out, q.grad, k.grad, v.grad)]
        if dev == "cuda":
            torch.cuda.synchronize()
            assert {n: getattr(fa, n).launches - before[n]
                    for n in names} == dict.fromkeys(names, 1)
    for name, a, b in zip("oqkv", got["cuda"], got["cpu"]):
        rms = np.sqrt(np.mean(b ** 2))
        assert float((np.abs(a - b) / (np.abs(b) + rms)).max()) <= 1e-5, name


@pytest.mark.gpu
def test_cuda_imported_causal_graph_matches_the_cpu():
    """The fused toy GPT (t 512, causal) on the card: K4's causal route,
    within 1e-4 of the CPU's output and TensorFlow's golden."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deeplearning4j_torch.autodiff import rewrites, tf_import
    torch.backends.cuda.matmul.allow_tf32 = False
    g = np.load(GPT_TOY_GOLD)
    outs = {}
    for dev in ("cpu", "cuda"):
        sd = tf_import.import_frozen_pb(GPT_TOY, device=dev)
        rewrites.optimize_for_tpu(sd)
        before = _fa().flash_fwd_single.launches
        outs[dev] = npv(sd.output({"i": g["ids"]}, ["Identity"])["Identity"])
        if dev == "cuda":
            assert _fa().flash_fwd_single.launches - before == 2
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], atol=1e-4)
    np.testing.assert_allclose(outs["cuda"], g["last_hidden"], atol=1e-4)
