"""Generate ``bert_base_graph_only.pb`` and its sidecar
``bert_base_graph_only.json``: the frozen BERT-base graph (the recipe of
``deeplearning4j_tpu/utils/bert_fixture.py``: ``BertConfig()`` defaults,
12 x 768, 12 heads of 64, ff 3072, vocab 30522, t 512, dynamic batch)
with the ``tensor_content`` of every float Const of at least 256
elements emptied — shape and dtype kept, every other Const as written.
A TensorFlow Const with no values reads as zeros of its shape, in both
packages' importers.  The sidecar lists each emptied Const with its
shape and BERT's initialiser (``normal`` N(0, 0.02) for matrices and
embeddings, ``ones`` for layer-norm scales, ``zeros`` for biases and
shifts), so a reader can seed the weights with numpy.

Run from the repository root (needs tensorflow and transformers):

    python tests/fixtures/gen_bert_base_graph_only.py

``graph_only(config_kwargs, seq_len)`` builds the same pair for any
``BertConfig`` (the chip smoke's CPU rehearsal uses a tiny one).
"""
import json
import os

os.environ["CUDA_VISIBLE_DEVICES"] = ""
os.environ["TRANSFORMERS_NO_ADVISORY_WARNINGS"] = "1"

OUT = os.path.dirname(os.path.abspath(__file__))
T = 512
MIN_EMPTIED = 256


def graph_only(config_kwargs=None, seq_len=T, min_emptied=MIN_EMPTIED):
    """(serialized frozen GraphDef with the large float Consts emptied,
    the sidecar dict)."""
    import numpy as np
    import tensorflow as tf
    from tensorflow.python.framework import tensor_util
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    from transformers import BertConfig, TFBertModel

    cfg = BertConfig(**(config_kwargs or {}))
    tf.random.set_seed(0)
    model = TFBertModel(cfg)

    # the placeholders take these names: i, m, t (as the reference's)
    def call(i, m, t):
        return model(input_ids=i, attention_mask=m, token_type_ids=t)

    spec = tf.TensorSpec((None, seq_len), tf.int32)
    conc = tf.function(call).get_concrete_function(spec, spec, spec)
    gd = convert_variables_to_constants_v2(conc).graph.as_graph_def()
    emptied = []
    for node in gd.node:
        if node.op != "Const":
            continue
        tp = node.attr["value"].tensor
        if tp.dtype not in (tf.float32.as_datatype_enum,
                            tf.float64.as_datatype_enum):
            continue
        value = tensor_util.MakeNdarray(tp)
        if value.size < min_emptied:
            continue
        if np.all(value == 1.0):
            init = "ones"
        elif np.all(value == 0.0):
            init = "zeros"
        else:
            init = "normal"
        emptied.append({"name": node.name, "shape": list(value.shape),
                        "dtype": value.dtype.name, "init": init})
        tp.tensor_content = b""
        del tp.float_val[:]
        del tp.double_val[:]
    side = {"config": {k: getattr(cfg, k) for k in (
                "vocab_size", "hidden_size", "num_hidden_layers",
                "num_attention_heads", "intermediate_size",
                "max_position_embeddings", "type_vocab_size")},
            "t": seq_len, "min_emptied_elements": min_emptied,
            "init": {"normal": "N(0, 0.02)", "ones": "1", "zeros": "0"},
            "consts": emptied}
    return gd.SerializeToString(), side


if __name__ == "__main__":
    raw, side = graph_only()
    with open(os.path.join(OUT, "bert_base_graph_only.pb"), "wb") as f:
        f.write(raw)
    with open(os.path.join(OUT, "bert_base_graph_only.json"), "w") as f:
        json.dump(side, f, indent=1)
    print("emptied", len(side["consts"]), "bytes", len(raw))
