"""Evaluation: classification, binary, regression metrics, ROC (port of
``deeplearning4j_tpu.eval``, numpy only, the same code).

Twin of ``org.nd4j.evaluation.*`` (``Evaluation``,
``EvaluationBinary``, ``RegressionEvaluation``, ``ROC``/``ROCMultiClass``).
Accumulation is streaming (call ``eval`` per batch) like DL4J, so large
test sets never materialize at once.
"""

from deeplearning4j_torch.eval.calibration import EvaluationCalibration
from deeplearning4j_torch.eval.classification import Evaluation, EvaluationBinary
from deeplearning4j_torch.eval.regression import RegressionEvaluation
from deeplearning4j_torch.eval.roc import ROC, ROCMultiClass

__all__ = ["Evaluation", "EvaluationBinary", "EvaluationCalibration",
           "RegressionEvaluation", "ROC", "ROCMultiClass"]
