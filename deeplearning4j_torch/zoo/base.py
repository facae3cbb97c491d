"""ZooModel base (port of ``deeplearning4j_tpu/zoo/base.py``): a model
family's configuration plus its construction on a device."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class ZooModel:
    n_classes: int = 1000
    seed: int = 123
    input_shape: Tuple[int, int, int] = (224, 224, 3)  # NHWC (DL4J: CHW)

    def conf(self):
        """Build the model configuration (graph or multi-layer)."""
        raise NotImplementedError

    def init_graph(self, device="cuda"):
        """Construct + initialize the model on ``device`` (DL4J
        ``ZooModel.init()``): a ``ComputationGraph`` for a graph
        configuration, a ``MultiLayerNetwork`` for a list one."""
        from deeplearning4j_torch.models.computation_graph import (
            ComputationGraph, ComputationGraphConfiguration)
        from deeplearning4j_torch.models.multi_layer_network import (
            MultiLayerNetwork)
        c = self.conf()
        if isinstance(c, ComputationGraphConfiguration):
            return ComputationGraph(c).init(device=device)
        return MultiLayerNetwork(c).init(device=device)
