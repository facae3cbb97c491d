"""BERT-base import fixture (port of ``deeplearning4j_tpu/utils/bert_fixture.py``;
BASELINE config 3's model artifact).

``ensure_bert_base_fixture`` generates — once, cached under
``DL4J_TPU_FIXTURE_CACHE`` (default ``deeplearning4j_tpu_fixtures`` in
the temp directory, the reference's cache) — a BERT-base-sized (12x768,
30522 vocab, ~110M param, ~438 MB) random-init FROZEN TF graph plus
TF-run goldens, in a subprocess that imports tensorflow/transformers.
Far too large to commit, and the card's machine has no TensorFlow: there
the committed ``tests/fixtures/bert_base_graph_only.pb`` (the same graph
with its weights emptied) stands in.

``attach_classifier_head`` adds the SST-2 fine-tune head to the port's
``SameDiff``.
"""
import os
import subprocess
import sys
import tempfile

CACHE = os.environ.get("DL4J_TPU_FIXTURE_CACHE", os.path.join(
    tempfile.gettempdir(), "deeplearning4j_tpu_fixtures"))

_GEN = r"""
import os
os.environ["CUDA_VISIBLE_DEVICES"] = ""
import numpy as np
import tensorflow as tf
from transformers import BertConfig, TFBertModel
from tensorflow.python.framework.convert_to_constants import (
    convert_variables_to_constants_v2)
cfg = BertConfig()          # BERT-base defaults
tf.random.set_seed(0)
model = TFBertModel(cfg)
B, T = 2, {t}
ids = np.random.default_rng(0).integers(
    0, cfg.vocab_size, (B, T)).astype(np.int32)
mask = np.ones((B, T), np.int32); mask[1, T // 2:] = 0
tt = np.zeros((B, T), np.int32)
out = model(input_ids=ids, attention_mask=mask, token_type_ids=tt)
def call(i, m, t):
    return model(input_ids=i, attention_mask=m, token_type_ids=t)
conc = tf.function(call).get_concrete_function(
    tf.TensorSpec((None, T), tf.int32), tf.TensorSpec((None, T), tf.int32),
    tf.TensorSpec((None, T), tf.int32))
frozen = convert_variables_to_constants_v2(conc)
with open({pb!r}, "wb") as f:
    f.write(frozen.graph.as_graph_def().SerializeToString())
np.savez({gold!r}, ids=ids, mask=mask, tt=tt,
         last_hidden=out.last_hidden_state.numpy(),
         pooler=out.pooler_output.numpy())
print("GEN_OK")
"""


def attach_classifier_head(sd, n_classes: int = 2, seed: int = 0):
    """Idempotently attach pooled-output -> n-class head + CE loss to an
    imported BERT graph (the SST-2 fine-tune head of BASELINE config 3).
    Expects the frozen graph's pooler output at ``Identity_1``."""
    import numpy as np
    if "loss" in sd.vars:
        return
    pooled = sd.vars["Identity_1"]
    # imported vars carry no static shapes — walk back from the pooler
    # output to the nearest constant (its dense bias) for the hidden
    # size (768 on BERT-base, 64 on the tiny test fixture)
    prod = {o: n for n in sd.ops for o in n.outputs}
    dim, frontier = None, ["Identity_1"]
    for _ in range(6):
        if dim is not None:
            break
        nxt = []
        for nm in frontier:
            val = sd.values.get(nm)
            if val is not None and getattr(val, "ndim", 0) >= 1:
                dim = int(np.asarray(val).shape[-1])
                break
            node = prod.get(nm)
            if node is not None:
                nxt.extend(node.inputs)
        frontier = nxt
    dim = dim or 768
    w = sd.var("cls_W", np.random.default_rng(seed).normal(
        scale=0.02, size=(dim, n_classes)).astype(np.float32))
    b = sd.var("cls_b", np.zeros(n_classes, np.float32))
    logits = sd.op("add", sd.matmul(pooled, w), b, name="logits")
    labels = sd.placeholder("labels", (None,), "int32")
    per_ex = sd.op("sparse_softmax_cross_entropy_with_logits", labels,
                   logits)
    loss = sd.reduce_mean(per_ex, name="loss")
    sd.set_loss_variables(loss)


def fixture_paths(t: int = 512):
    pb = os.path.join(CACHE, f"bert_base_frozen_t{t}.pb")
    gold = os.path.join(CACHE, f"bert_base_golden_t{t}.npz")
    return pb, gold


def ensure_bert_base_fixture(t: int = 512):
    """Returns (frozen_pb_path, golden_npz_path), generating on first
    call (~3 min: a TF CPU forward at [2, t] plus freezing; needs
    tensorflow and transformers)."""
    pb, gold = fixture_paths(t)
    if not (os.path.exists(pb) and os.path.exists(gold)):
        os.makedirs(CACHE, exist_ok=True)
        code = _GEN.format(pb=pb, gold=gold, t=t)
        r = subprocess.run([sys.executable, "-c", code],
                           capture_output=True, timeout=1800)
        if b"GEN_OK" not in r.stdout:
            raise RuntimeError("fixture generation failed: "
                               + r.stderr.decode()[-2000:])
    return pb, gold
