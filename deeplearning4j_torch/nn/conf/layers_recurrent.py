"""Recurrent layer configs (port of
``deeplearning4j_tpu/nn/conf/layers_recurrent.py``).  Only
``RnnOutputLayer`` so far — the decoder's per-position LM head; the LSTMs
come with the recurrent slice."""
from __future__ import annotations

import dataclasses

from deeplearning4j_torch.nn.conf.base import register_layer
from deeplearning4j_torch.nn.conf.layers_core import OutputLayer


@register_layer
@dataclasses.dataclass
class RnnOutputLayer(OutputLayer):
    """Per-timestep output layer over [b, t, f]: the dense projection
    broadcasts over time ([b, t, in] @ [in, out]); the base scorer folds
    [b, t, V] pre-activations into per-timestep scores, with sparse [b, t]
    labels for ``sparse_mcxent`` and [b, t] label masks."""

    WANTED_KINDS = ("rnn",)
    OUTPUT_KIND = "rnn"
