"""Training: updaters, schedules, the solver step, listeners and the fit
loop (port of ``deeplearning4j_tpu.optimize``)."""
from deeplearning4j_torch.optimize.listeners import (CollectScoresListener,
                                                     EvaluativeListener,
                                                     PerformanceListener,
                                                     ScoreIterationListener,
                                                     TimeIterationListener,
                                                     TrainingListener)
from deeplearning4j_torch.optimize.schedules import schedule_from_spec
from deeplearning4j_torch.optimize.updaters import (
    AdaDelta, AdaGrad, AdaMax, Adam, AdamW, AMSGrad, BaseUpdater, Ema, Nadam,
    Nesterovs, NoOp, RmsProp, Sgd, updater_from_dict)

__all__ = [
    "Sgd", "Adam", "AdamW", "AdaMax", "Nesterovs", "RmsProp", "AdaGrad",
    "AdaDelta", "AMSGrad", "Nadam", "NoOp", "Ema", "updater_from_dict",
    "schedule_from_spec",
    "BaseUpdater", "TrainingListener", "ScoreIterationListener",
    "PerformanceListener", "CollectScoresListener", "TimeIterationListener",
    "EvaluativeListener",
]
