"""Checkpoint I/O and state carrying (port of ``deeplearning4j_tpu.utils``)."""
from deeplearning4j_torch.utils.convert import (load_numpy_opt_state,
                                                load_numpy_params,
                                                load_numpy_state,
                                                samediff_from_dict)
from deeplearning4j_torch.utils.model_serializer import (
    restore_computation_graph, restore_model, restore_multi_layer_network,
    write_model)

__all__ = ["load_numpy_opt_state", "load_numpy_params", "load_numpy_state",
           "restore_computation_graph", "restore_model",
           "restore_multi_layer_network", "samediff_from_dict",
           "write_model"]
