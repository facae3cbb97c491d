"""Model zoo (port of ``deeplearning4j_tpu.zoo``: the decoder and the
BERT encoder so far)."""
from deeplearning4j_torch.zoo.bert import Bert
from deeplearning4j_torch.zoo.gpt import Gpt

__all__ = ["Bert", "Gpt"]
