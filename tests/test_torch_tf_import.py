"""The port's TensorFlow importer (``deeplearning4j_torch.autodiff.
tf_import``) and its wire codec (``tf_serde``) against TensorFlow and the
JAX package: every committed frozen ``.pb`` (the graph-only BERT-base
included) imports to the same IR TensorFlow's own parse gives the
reference; ``make_ndarray`` and the dtype names follow TensorFlow's
rules; the tiny BERT's fused and unfused outputs match TensorFlow's
goldens and the reference; three fine-tune steps from one init give the
same losses (1e-5) and parameters (1e-4); a zip saved by either package
loads in the other."""
import json

import numpy as np
import pytest
import torch

from deeplearning4j_torch.autodiff import tf_serde
from torch_graph_util import (BERT_BASE_GRAPH_ONLY, BERT_TINY,
                              BERT_TINY_GOLD, PB_FIXTURES, ir, npv, ns)

pytest.importorskip("jax")
tf = pytest.importorskip("tensorflow")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", PB_FIXTURES,
                         ids=[p.rsplit("/", 1)[-1] for p in PB_FIXTURES])
def test_codec_gives_the_ir_of_tensorflows_parse(path):
    port = ns("port").import_frozen_pb(path)
    ref = ns("jax").import_frozen_pb(path)
    assert ir(port) == ir(ref)


def test_graph_only_bert_base_is_the_full_graph_with_weights_emptied():
    from tensorflow.core.framework import graph_pb2
    gd = graph_pb2.GraphDef()
    with open(BERT_BASE_GRAPH_ONLY, "rb") as f:
        gd.ParseFromString(f.read())
    side = json.load(open(BERT_BASE_GRAPH_ONLY[:-3] + ".json"))
    consts = {c["name"]: c for c in side["consts"]}
    assert len(gd.node) == 3005 and len(consts) == 199
    assert {c["init"] for c in consts.values()} == {"normal", "ones",
                                                    "zeros"}
    for n in gd.node:
        if n.name in consts:
            t = n.attr["value"].tensor
            assert not t.tensor_content and not t.float_val
            assert [d.size for d in t.tensor_shape.dim] == \
                consts[n.name]["shape"]
    shapes = {tuple(c["shape"]) for c in consts.values()}
    assert (30522, 768) in shapes and (768, 3072) in shapes


def test_import_graph_def_takes_dict_bytes_or_a_tensorflow_proto():
    from tensorflow.core.framework import graph_pb2
    raw = open(BERT_TINY, "rb").read()
    gd = graph_pb2.GraphDef()
    gd.ParseFromString(raw)
    P = ns("port")
    irs = [ir(P.import_graph_def(x))
           for x in (raw, gd, tf_serde.decode_graph_def(raw))]
    assert irs[0] == irs[1] == irs[2]


def _proto(dtype, shape, **fields):
    from tensorflow.core.framework import tensor_pb2
    t = tensor_pb2.TensorProto(dtype=dtype)
    for d in shape:
        t.tensor_shape.dim.add(size=d)
    for k, v in fields.items():
        if k == "tensor_content":
            t.tensor_content = v
        else:
            getattr(t, k).extend(v)
    return t


MAKE_NDARRAY = [
    ("content_f32", 1, [2, 3], {"tensor_content": np.arange(
        6, dtype=np.float32).tobytes()}),
    ("float_val_repeats_last", 1, [2, 3], {"float_val": [1.5, -2.0]}),
    ("empty_is_zeros", 1, [4, 2], {}),
    ("double", 2, [3], {"double_val": [1.0, 2.5, -3.25]}),
    ("int32", 3, [2, 2], {"int_val": [1, -2, 3, 4]}),
    ("uint8", 4, [3], {"int_val": [1, 200, 255]}),
    ("int64", 9, [2], {"int64_val": [-(1 << 40), 7]}),
    ("int64_scalar_repeat", 9, [3], {"int64_val": [5]}),
    ("bool", 10, [3], {"bool_val": [True, False, True]}),
    ("half", 19, [2], {"half_val": [np.float16(1.5).view(np.uint16),
                                    np.float16(-0.25).view(np.uint16)]}),
    ("bfloat16", 14, [2], {"half_val": [0x3FC0, 0xBE80]}),
    ("string", 7, [3], {"string_val": [b"a", b"bc"]}),
]


@pytest.mark.parametrize("cid,dtype,shape,fields", MAKE_NDARRAY,
                         ids=[c[0] for c in MAKE_NDARRAY])
def test_make_ndarray_follows_tensorflow(cid, dtype, shape, fields):
    from tensorflow.python.framework import tensor_util
    t = _proto(dtype, shape, **fields)
    want = tensor_util.MakeNdarray(t)
    got = tf_serde.make_ndarray(tf_serde.decode(t.SerializeToString(),
                                                tf_serde.TENSOR))
    assert got.shape == want.shape
    if dtype == 14:      # numpy has no bfloat16: the port widens to f32
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want.astype(np.float32))
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_dtype_names_follow_tensorflow():
    from tensorflow.python.framework import dtypes
    for enum, name in tf_serde.DTYPE_NAMES.items():
        assert dtypes.as_dtype(enum).as_numpy_dtype.__name__ == name
        assert tf_serde.dtype_name(enum + 100) == name


@pytest.fixture(scope="module")
def golden():
    return np.load(BERT_TINY_GOLD)


def _bert_out(sd, g):
    out = sd.output({"i": g["ids"], "m": g["mask"], "t": g["tt"]},
                    ["Identity", "Identity_1"])
    return npv(out["Identity"]), npv(out["Identity_1"])


@pytest.mark.parametrize("fused", [False, True])
def test_bert_tiny_matches_tensorflow_goldens_and_the_reference(golden,
                                                               fused):
    res = []
    for which in ("port", "jax"):
        N = ns(which)
        sd = N.import_frozen_pb(BERT_TINY)
        if fused:
            counts = N.optimize_for_tpu(sd)
            assert counts == {"parallel_matmuls": 2, "layer_norm": 5,
                              "gelu": 2, "attention": 2,
                              "flatten_reshapes": 8}
        res.append(_bert_out(sd, golden))
    (ph, pp), (jh, jp) = res
    np.testing.assert_allclose(ph, golden["last_hidden"], atol=3e-5)
    np.testing.assert_allclose(pp, golden["pooler"], atol=3e-5)
    np.testing.assert_allclose(ph, jh, atol=1e-5)
    np.testing.assert_allclose(pp, jp, atol=1e-5)


def _finetune(which, steps=3):
    """The imported tiny BERT, fused, with the classifier head, three
    Adam(2e-5) steps on one seeded batch."""
    N = ns(which)
    sd = N.import_frozen_pb(BERT_TINY)
    N.optimize_for_tpu(sd)
    N.attach_classifier_head(sd)
    sd.set_training_config(N.TrainingConfig(
        updater=N.Adam(learning_rate=2e-5),
        data_set_feature_mapping=["i", "m", "t"],
        data_set_label_mapping=["labels"]))
    r = np.random.default_rng(5)
    ids = r.integers(0, 500, (4, 16)).astype(np.int32)
    mask = np.ones((4, 16), np.int32)
    mask[1, 9:] = 0
    ds = N.MultiDataSet([ids, mask, np.zeros((4, 16), np.int32)],
                        [np.asarray([0, 1, 1, 0], np.int32)])
    losses = sd.fit([ds] * steps)
    return sd, np.asarray(losses)


def test_three_finetune_steps_equal_the_reference():
    psd, pl = _finetune("port")
    jsd, jl = _finetune("jax")
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)
    assert set(psd.values) == set(jsd.values)
    for k in jsd.values:
        np.testing.assert_allclose(psd.values[k], jsd.values[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_saved_zip_loads_in_the_other_package(golden, tmp_path, writer,
                                             reader):
    W = ns(writer)
    sd = W.import_frozen_pb(BERT_TINY)
    W.optimize_for_tpu(sd)
    p = str(tmp_path / "bert.sdz")
    sd.save(p)
    sd2 = ns(reader).load(p)
    np.testing.assert_allclose(_bert_out(sd2, golden)[0],
                               golden["last_hidden"], atol=3e-5)


def test_import_saved_model_matches_the_reference(tmp_path):
    class M(tf.Module):
        def __init__(self):
            self.w = tf.Variable(np.random.default_rng(0).normal(
                size=(4, 3)).astype(np.float32))

        @tf.function(input_signature=[tf.TensorSpec((None, 4), tf.float32)])
        def __call__(self, x):
            return {"y": tf.nn.relu(tf.matmul(x, self.w))}

    m = M()
    path = str(tmp_path / "sm")
    tf.saved_model.save(m, path, signatures=m.__call__)
    from deeplearning4j_torch.autodiff.tf_import import import_saved_model
    from deeplearning4j_tpu.autodiff.tf_import import (
        import_saved_model as ref_import)
    psd = import_saved_model(path, device="cpu")
    jsd = ref_import(path)
    assert ir(psd) == ir(jsd)
    x = np.random.default_rng(1).normal(size=(2, 4)).astype(np.float32)
    ph = [v.name for v in psd.vars.values() if v.var_type == "PLACEHOLDER"]
    want = m(tf.constant(x))["y"].numpy()
    got = npv(list(psd.output({ph[0]: x}).values())[0])
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.fixture(scope="module")
def tiny_graph_only(tmp_path_factory):
    """A graph-only BERT at t 512 from the fixture generator's recipe,
    at a tiny width (2 x 32, 2 heads of 16, the tiny-sentiment vocab)."""
    import importlib.util
    import os

    from deeplearning4j_torch.data.tiny_sentiment import build_vocab
    spec = importlib.util.spec_from_file_location(
        "gen_bert_base_graph_only", os.path.join(
            os.path.dirname(__file__), "fixtures",
            "gen_bert_base_graph_only.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    raw, side = gen.graph_only(dict(
        vocab_size=len(build_vocab()), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=512, type_vocab_size=2), seq_len=512,
        min_emptied=64)
    d = tmp_path_factory.mktemp("graph_only")
    (d / "tiny_graph_only.pb").write_bytes(raw)
    (d / "tiny_graph_only.json").write_text(json.dumps(side))
    return str(d / "tiny_graph_only.pb")


def test_samediff_phase_rehearsal_on_cpu(monkeypatch, tiny_graph_only):
    """``chip_smoke.py``'s samediff phase whole on the CPU at a tiny
    width: a graph-only BERT (2 x 32) at t 512 through parts (a)-(e),
    with counting stand-ins for the flash wrappers (their plain
    versions): K4 = K5 = K6 = 2 a step in (b) and in gpt_toy's
    fine-tune, and the rewrite counts the reference gives on the file."""
    import importlib

    import chip_smoke
    fa = importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")

    def counted(orig):
        def wrapper(*a, **kw):
            wrapper.launches += 1
            return orig(*a, **kw)
        wrapper.launches = 0
        return wrapper

    for name in chip_smoke.FLASH_WRAPPERS:
        monkeypatch.setattr(fa, name, counted(getattr(fa, name)))
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    ref = ns("jax").import_frozen_pb(tiny_graph_only)
    expect = ns("jax").optimize_for_tpu(ref)
    assert expect["attention"] == 2
    cfg = dict(chip_smoke.SAMEDIFF_CFG, graph=tiny_graph_only,
               rewrites=expect, layers=2, b_f32=2, b=4, steps=2, lr=2e-3,
               csv_rows=600, csv_batch=32, csv_epochs=6)
    peaks = []
    counts = chip_smoke.samediff_parts(
        torch, np, "cpu", cfg, lambda: None, "cpu",
        lambda reset=False: peaks.append(reset), lambda step: step() and None)
    per = {"flash_fwd": 0, "flash_fwd_single": 4, "flash_bwd_dkdv": 4,
           "flash_bwd_dq": 4}
    gpt = {"flash_fwd": 0, "flash_fwd_single": 6, "flash_bwd_dkdv": 6,
           "flash_bwd_dq": 6}
    assert counts == {"bert": per, "gpt_toy": gpt}
    (row,) = lines
    a = row["a_import_forward"]
    assert a["fused_sites"] == 2 and a["rewrites"] == expect
    assert all(v <= 1e-4 for v in a["f32_vs_cpu_f64_normwise"].values())
    b = row["b_finetune"]
    assert b["launches"] == per and b["held_out_sentences"] == 80
    assert all(v == 0 for v in b["kernel_vs_plain"].values())
    assert b["losses"][-1] < b["losses"][0]
    assert row["d_onnx"]["attention"]["rewrites"]["attention"] == 0
    assert row["e_datavec"]["accuracy_after"] > 0.9
