"""GPT-style causal decoder LM (port of ``deeplearning4j_tpu/zoo/gpt.py``).

``Gpt()`` keeps the reference's defaults: vocab 32000, d 768, 12 layers,
6 heads of 128, ff 3072, positional table 2048, bf16 compute — and
builds the same ``configuration.json`` (embedding -> 12 causal
``TransformerEncoderBlock`` -> ``RnnOutputLayer`` softmax head).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_recurrent import RnnOutputLayer
from deeplearning4j_torch.nn.conf.layers_transformer import (
    EmbeddingSequenceLayer, TransformerEncoderBlock)
from deeplearning4j_torch.zoo.base import ZooModel

# the reference's default updater, as its configuration JSON stores it
# (``Adam(learning_rate=3e-4).to_dict()``)
_ADAM_3E4 = {"type": "Adam", "learning_rate": 3e-4, "beta1": 0.9,
             "beta2": 0.999, "epsilon": 1e-8}


@dataclasses.dataclass
class Gpt(ZooModel):
    """Decoder-only causal LM.  ``Gpt()`` is GPT-2-small-shaped (12 x 768,
    6 heads of 128, ff 3072); shrink for tests."""

    vocab_size: int = 32000
    max_len: int = 2048
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 6
    d_ff: int = 3072
    dropout: float = 0.0
    seq_len: int = 2048           # training sequence length
    compute_dtype: Optional[str] = "bfloat16"
    use_flash: bool = True
    updater: Optional[dict] = None

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or _ADAM_3E4))
        if self.compute_dtype:
            b = b.compute_dtype(self.compute_dtype)
        lst = (b.list()
               .set_input_type(InputType.feed_forward(self.seq_len))
               .layer(EmbeddingSequenceLayer(
                   n_in=self.vocab_size, n_out=self.d_model,
                   max_len=self.max_len, dropout=self.dropout or None)))
        for _ in range(self.n_layers):
            lst = lst.layer(TransformerEncoderBlock(
                n_heads=self.n_heads, d_ff=self.d_ff, causal=True,
                dropout=self.dropout or None, use_flash=self.use_flash))
        return (lst
                .layer(RnnOutputLayer(n_out=self.vocab_size,
                                      activation="softmax",
                                      loss="sparse_mcxent"))
                .build())
