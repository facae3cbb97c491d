"""Training and serving over device meshes (port of
``deeplearning4j_tpu.parallel``): ``MeshConfig`` and the mesh-sharded
``ShardedTrainer`` (data, tensor and pipeline parallel), ring attention,
the GPipe schedule, ``torch.distributed`` bring-up, elastic checkpoint
re-layout, the scaling harness, the generation server (one device, or a
``("data", "tp")`` slice of devices), batched ``ParallelInference`` and
the checkpointer ``fit(resume=True)`` restores from.

The reference places every collective with GSPMD inside one jitted
program; the port runs each shard's tensors on its device and does the
collectives itself (``parallel.mesh``)."""
from deeplearning4j_torch.parallel.mesh import MeshConfig
from deeplearning4j_torch.parallel.trainer import ShardedTrainer
from deeplearning4j_torch.parallel.inference import ParallelInference
from deeplearning4j_torch.parallel.generation_server import GenerationServer
from deeplearning4j_torch.parallel.kv_tiering import HostKVTier
from deeplearning4j_torch.parallel.distributed import (
    global_devices, global_mesh, host_local_batch_to_global, initialize)
from deeplearning4j_torch.parallel.checkpoint import (CheckpointListener,
                                                      ShardedCheckpointer)
from deeplearning4j_torch.parallel import elastic

# DL4J-familiar alias: `initialize_distributed`
initialize_distributed = initialize

from deeplearning4j_torch.parallel.ring_attention import (  # noqa: E402
    ring_attention, ring_self_attention)
from deeplearning4j_torch.parallel.pipeline import (  # noqa: E402
    PipelinedTransformerLM, gpipe_apply, stack_block_params)
from deeplearning4j_torch.parallel.scaling import (  # noqa: E402
    measure_scaling)

__all__ = ["MeshConfig", "ShardedTrainer", "ParallelInference",
           "GenerationServer", "HostKVTier",
           "initialize", "initialize_distributed", "global_devices",
           "global_mesh",
           "host_local_batch_to_global", "ShardedCheckpointer",
           "CheckpointListener", "ring_attention", "ring_self_attention",
           "gpipe_apply", "stack_block_params", "PipelinedTransformerLM",
           "measure_scaling", "elastic"]
