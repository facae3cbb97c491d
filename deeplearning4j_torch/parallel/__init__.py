"""Serving, batched inference and training-state checkpoints (port of
``deeplearning4j_tpu.parallel``: the generation server at tp = 1, the
batching ``ParallelInference``, and the checkpointer
``fit(resume=True)`` restores from)."""
from deeplearning4j_torch.parallel.checkpoint import (CheckpointListener,
                                                      ShardedCheckpointer)
from deeplearning4j_torch.parallel.generation_server import GenerationServer
from deeplearning4j_torch.parallel.inference import ParallelInference

__all__ = ["GenerationServer", "ParallelInference", "ShardedCheckpointer",
           "CheckpointListener"]
