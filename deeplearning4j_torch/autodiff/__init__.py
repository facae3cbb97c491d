"""Graph IR + autodiff: the SameDiff pillar (port of
``deeplearning4j_tpu/autodiff``).

Reference: ``org.nd4j.autodiff.samediff.SameDiff`` (define-by-run recorded
DAG, interpreted op-by-op by ``InferenceSession``/``TrainingSession``) and
its serialization.  The port interprets the recorded DAG eagerly in
PyTorch on the graph's device, with the host-folded parts cached per feed
shape; gradients come from ``torch.autograd``.  ``tf_import`` and
``onnx_import`` read TensorFlow and ONNX graphs through in-repo wire
codecs; ``rewrites.optimize_for_tpu`` fuses imported attention onto the
flash kernels.
"""
from deeplearning4j_torch.autodiff.ops import OP_REGISTRY, register_op
from deeplearning4j_torch.autodiff.samediff import (
    SameDiff, SDVariable, TrainingConfig)

__all__ = ["SameDiff", "SDVariable", "TrainingConfig", "OP_REGISTRY",
           "register_op"]
