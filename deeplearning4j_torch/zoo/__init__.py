"""Model zoo (port of ``deeplearning4j_tpu.zoo``; the decoder so far)."""
from deeplearning4j_torch.zoo.gpt import Gpt

__all__ = ["Gpt"]
