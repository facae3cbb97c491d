"""ZooModel base (port of ``deeplearning4j_tpu/zoo/base.py``): a model
family's configuration plus its construction on a device.  Upstream a
ZooModel downloads pretrained weights by URL and checksum; here
``init_pretrained`` restores a local checkpoint (the registry with
checksums is ``zoo.pretrained``)."""
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

    # DL4J initPretrained(PretrainedType) — local checkpoint stand-in
    def init_pretrained(self, checkpoint_path: str, device="cuda"):
        from deeplearning4j_torch.utils.model_serializer import restore_model
        return restore_model(checkpoint_path, device=device)
