"""Checkpoint I/O and state carrying (port of ``deeplearning4j_tpu.utils``)."""
from deeplearning4j_torch.utils.convert import (load_numpy_opt_state,
                                                load_numpy_params)
from deeplearning4j_torch.utils.model_serializer import (restore_model,
                                                         write_model)

__all__ = ["load_numpy_opt_state", "load_numpy_params", "restore_model",
           "write_model"]
