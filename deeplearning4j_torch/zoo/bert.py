"""BERT encoder classifier (port of ``deeplearning4j_tpu/zoo/bert.py``).

``Bert()`` keeps the reference's defaults, BERT-base: vocab 30522, 12
layers of 768, 12 heads of 64, ff 3072, positional table 512, bf16
compute, Adam(2e-5) — and builds the same ``configuration.json``
(``EmbeddingSequenceLayer`` -> N x ``TransformerEncoderBlock`` -> masked
average ``GlobalPoolingLayer`` -> softmax ``OutputLayer``).  At
``seq_len`` 512 every block's attention takes the flash route: the
forward is K4 (one key block covers the row), the backward K5 then K6,
and a [b, t] features mask becomes the kernels' key bias.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_conv import GlobalPoolingLayer
from deeplearning4j_torch.nn.conf.layers_core import OutputLayer
from deeplearning4j_torch.nn.conf.layers_transformer import (
    EmbeddingSequenceLayer, TransformerEncoderBlock)
from deeplearning4j_torch.optimize.updaters import Adam
from deeplearning4j_torch.zoo.base import ZooModel


@dataclasses.dataclass
class Bert(ZooModel):
    """BERT-shaped encoder classifier.  ``Bert()`` is BERT-base;
    shrink n_layers/d_model for tests."""

    n_classes: int = 2
    vocab_size: int = 30522
    max_len: int = 512
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    dropout: float = 0.0
    seq_len: int = 128            # training sequence length
    compute_dtype: Optional[str] = "bfloat16"
    use_flash: bool = True
    updater: object = None

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or Adam(learning_rate=2e-5)))
        if self.compute_dtype:
            b = b.compute_dtype(self.compute_dtype)
        lst = (b.list()
               .set_input_type(InputType.feed_forward(self.seq_len))
               .layer(EmbeddingSequenceLayer(
                   n_in=self.vocab_size, n_out=self.d_model,
                   max_len=self.max_len, dropout=self.dropout or None)))
        for _ in range(self.n_layers):
            lst = lst.layer(TransformerEncoderBlock(
                n_heads=self.n_heads, d_ff=self.d_ff,
                dropout=self.dropout or None, use_flash=self.use_flash))
        return (lst
                .layer(GlobalPoolingLayer(pooling_type="avg"))
                .layer(OutputLayer(n_out=self.n_classes,
                                   activation="softmax", loss="mcxent"))
                .build())

    def flops_per_token_train(self) -> float:
        """Analytic fwd+bwd FLOPs/token for MFU accounting: 6 FLOPs per
        matmul parameter (2 fwd + 4 bwd) plus the attention
        score/context matmuls (4*t*d/token/layer fwd, x3 for train)."""
        d, ff, L, t = self.d_model, self.d_ff, self.n_layers, self.seq_len
        matmul_params = L * (4 * d * d + 2 * d * ff)
        return 6.0 * matmul_params + 12.0 * L * t * d
