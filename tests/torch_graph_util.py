"""Shared helpers of the graph-import tests (``tests/test_torch_*``): one
namespace per package over the same names — ``ns("port")`` builds on the
CPU, ``ns("jax")`` is the JAX package — and a numpy view of either
package's values."""
import os
import types

import numpy as np

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
BERT_TINY = os.path.join(FIX, "bert_tiny_frozen.pb")
BERT_TINY_GOLD = os.path.join(FIX, "golden.npz")
BERT_SENTIMENT = os.path.join(FIX, "bert_tiny_sentiment_frozen.pb")
GPT_TOY = os.path.join(FIX, "gpt_toy_frozen.pb")
GPT_TOY_GOLD = os.path.join(FIX, "gpt_toy_golden.npz")
BERT_BASE_GRAPH_ONLY = os.path.join(FIX, "bert_base_graph_only.pb")
PB_FIXTURES = (BERT_TINY, BERT_SENTIMENT, GPT_TOY, BERT_BASE_GRAPH_ONLY)


def ns(which: str):
    """The graph API of one package: ``create``, ``load``,
    ``import_graph_def``, ``import_frozen_pb``, ``import_onnx_model``,
    ``optimize_for_tpu``, ``fuse_attention``, ``TrainingConfig``,
    ``Adam``, ``Sgd``, ``DataSet``, ``MultiDataSet``,
    ``ListDataSetIterator``, ``attach_classifier_head``."""
    n = types.SimpleNamespace(which=which)
    if which == "port":
        from deeplearning4j_torch.autodiff import (SameDiff, TrainingConfig,
                                                   onnx_import, rewrites,
                                                   tf_import)
        from deeplearning4j_torch.data.dataset import DataSet, MultiDataSet
        from deeplearning4j_torch.data.iterator import ListDataSetIterator
        from deeplearning4j_torch.optimize.updaters import Adam, Sgd
        from deeplearning4j_torch.utils import bert_fixture
        kw = {"device": "cpu"}
    else:
        from deeplearning4j_tpu.autodiff import (SameDiff, TrainingConfig,
                                                 onnx_import, rewrites,
                                                 tf_import)
        from deeplearning4j_tpu.data.dataset import DataSet, MultiDataSet
        from deeplearning4j_tpu.data.iterator import ListDataSetIterator
        from deeplearning4j_tpu.optimize.updaters import Adam, Sgd
        from deeplearning4j_tpu.utils import bert_fixture
        kw = {}
    n.SameDiff = SameDiff
    n.create = lambda: SameDiff.create(**kw)
    n.load = lambda path: SameDiff.load(path, **kw)
    n.import_graph_def = lambda gd, **a: tf_import.import_graph_def(
        gd, **a, **kw)
    n.import_frozen_pb = lambda path, **a: tf_import.import_frozen_pb(
        path, **a, **kw)
    n.import_onnx_model = lambda m, **a: onnx_import.import_onnx_model(
        m, **a, **kw)
    n.optimize_for_tpu = rewrites.optimize_for_tpu
    n.fuse_attention = rewrites.fuse_attention
    n.rewrites = rewrites
    n.TrainingConfig, n.Adam, n.Sgd = TrainingConfig, Adam, Sgd
    n.DataSet, n.MultiDataSet = DataSet, MultiDataSet
    n.ListDataSetIterator = ListDataSetIterator
    n.attach_classifier_head = bert_fixture.attach_classifier_head
    return n


def npv(x):
    """A numpy copy of a tensor, jax array or host value."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ir(sd) -> dict:
    """The graph's structure (``to_dict``) with its values as
    (dtype, shape, bytes), comparable across packages."""
    d = sd.to_dict()
    d["values"] = {k: (np.asarray(v).dtype.str, np.shape(v),
                       np.asarray(v).tobytes() if np.asarray(v).dtype.kind
                       != "O" else repr(np.asarray(v).tolist()))
                   for k, v in sd.values.items()}
    return d
