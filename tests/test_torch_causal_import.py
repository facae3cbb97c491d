"""Imported causal masks in the port, against the JAX package and
TensorFlow's goldens (``tests/test_causal_import.py``): the frozen toy
GPT (t 512) fuses to ``fused_attention(causal=True)`` with the mask
operand dropped in both packages, matches TensorFlow's goldens fused
and unfused, and fine-tunes through the flash route (the wrappers' plain
versions on the CPU); ``fold_causal_masks=False`` keeps the mask as a
declared ``[t, t]`` bias with the causal path's numbers."""
import importlib

import numpy as np
import pytest
import torch

from torch_graph_util import GPT_TOY, GPT_TOY_GOLD, npv, ns

pytest.importorskip("jax")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fused():
    out = {}
    for which in ("port", "jax"):
        N = ns(which)
        sd = N.import_frozen_pb(GPT_TOY)
        out[which] = (sd, N.optimize_for_tpu(sd))
    return out


def test_causal_mask_fuses_and_drops_bias_in_both(fused):
    (psd, pc), (jsd, jc) = fused["port"], fused["jax"]
    assert pc == jc and pc["attention"] == 2
    assert psd.to_dict() == jsd.to_dict()
    nodes = [n for n in psd.ops if n.op_name == "fused_attention"]
    assert len(nodes) == 2
    for n in nodes:
        assert n.attrs["causal"] is True and len(n.inputs) == 3


@pytest.mark.parametrize("fuse", [False, True])
def test_causal_import_matches_tensorflow_goldens(fused, fuse):
    g = np.load(GPT_TOY_GOLD)
    sd = fused["port"][0] if fuse else ns("port").import_frozen_pb(GPT_TOY)
    fa = importlib.import_module("deeplearning4j_torch.kernels."
                                 "flash_attention")
    fa.reset_route_log()
    out = npv(sd.output({"i": g["ids"]}, ["Identity"])["Identity"])
    np.testing.assert_allclose(out, g["last_hidden"], atol=3e-5)
    assert (("flash", 512, 32) in fa.route_log()) == fuse


def test_causal_fused_graph_finetunes_via_flash_route():
    fa = importlib.import_module("deeplearning4j_torch.kernels."
                                 "flash_attention")
    N = ns("port")
    sd = N.import_frozen_pb(GPT_TOY)
    N.optimize_for_tpu(sd)
    pooled = sd.reduce_mean(sd.vars["Identity"], axis=1)
    w = sd.var("cls_W", np.random.default_rng(0).normal(
        scale=0.02, size=(64, 2)).astype(np.float32))
    logits = sd.matmul(pooled, w, name="logits")
    labels = sd.placeholder("labels", (None,), "int32")
    per_ex = sd.op("sparse_softmax_cross_entropy_with_logits", labels,
                   logits)
    sd.set_loss_variables(sd.reduce_mean(per_ex, name="loss"))
    sd.set_training_config(N.TrainingConfig(
        updater=N.Adam(learning_rate=1e-3),
        data_set_feature_mapping=["i"], data_set_label_mapping=["labels"]))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 500, (2, 512)).astype(np.int32)
    fa.reset_route_log()
    losses = sd.fit([N.DataSet(ids, np.asarray([0, 1], np.int32))],
                    n_epochs=3)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert ("flash", 512, 32) in fa.route_log()


def test_fold_causal_masks_opt_out_keeps_bias_operand():
    for which in ("port", "jax"):
        N = ns(which)
        sd = N.import_frozen_pb(GPT_TOY)
        assert N.optimize_for_tpu(sd, fold_causal_masks=False)[
            "attention"] == 2
        for n in (n for n in sd.ops if n.op_name == "fused_attention"):
            assert n.attrs["causal"] is False
            assert n.attrs["bias_layout"] == "qk" and len(n.inputs) == 4
    from deeplearning4j_torch.autodiff.ops import OP_REGISTRY, device_scope
    fn = OP_REGISTRY["fused_attention"].fn
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(size=(2, 2, 8, 4)).astype(
        np.float32)) for _ in range(3))
    mask = np.triu(np.full((8, 8), -1e9, np.float32), k=1)
    with device_scope("cpu"):
        kept = fn(q, k, v, bias=mask, bias_layout="qk", scale=0.5)
        folded = fn(q, k, v, causal=True, scale=0.5)
    np.testing.assert_allclose(npv(kept), npv(folded), atol=2e-6)
