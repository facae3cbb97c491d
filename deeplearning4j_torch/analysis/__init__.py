"""Runtime sanitizers (port of the runtime half of
``deeplearning4j_tpu.analysis``).  The reference's static passes (the
lint rules, the baseline and gate) read source code, not tensors, and
run over the port's files as they are; only
:mod:`~deeplearning4j_torch.analysis.sanitize` is carried here."""
from deeplearning4j_torch.analysis import sanitize
from deeplearning4j_torch.analysis.sanitize import SanitizerError

__all__ = ["sanitize", "SanitizerError"]
