"""Training: updaters, schedules, the solver step, listeners and the fit
loop (port of ``deeplearning4j_tpu.optimize``)."""
from deeplearning4j_torch.optimize.listeners import (CollectScoresListener,
                                                     PerformanceListener,
                                                     ScoreIterationListener,
                                                     TrainingListener)
from deeplearning4j_torch.optimize.updaters import (AdaDelta, Adam, AdamW,
                                                    BaseUpdater, Nesterovs,
                                                    NoOp, Sgd,
                                                    updater_from_dict)

__all__ = ["TrainingListener", "ScoreIterationListener",
           "PerformanceListener", "CollectScoresListener", "BaseUpdater",
           "NoOp", "Sgd", "Nesterovs", "Adam", "AdamW", "AdaDelta",
           "updater_from_dict"]
