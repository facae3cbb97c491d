"""Serving (port of ``deeplearning4j_tpu.parallel``; the generation server
at tp = 1 so far)."""
from deeplearning4j_torch.parallel.generation_server import GenerationServer

__all__ = ["GenerationServer"]
