"""ZooModel base (port of ``deeplearning4j_tpu/zoo/base.py``): a model
family's configuration plus its construction on a device."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class ZooModel:
    n_classes: int = 1000
    seed: int = 123
    input_shape: Tuple[int, int, int] = (224, 224, 3)

    def conf(self):
        """Build the model configuration."""
        raise NotImplementedError

    def init_graph(self, device="cuda"):
        """Construct + initialize the model on ``device`` (DL4J
        ``ZooModel.init()``)."""
        from deeplearning4j_torch.models.multi_layer_network import (
            MultiLayerNetwork)
        return MultiLayerNetwork(self.conf()).init(device=device)
