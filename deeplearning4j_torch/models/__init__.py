"""Models (port of ``deeplearning4j_tpu.models``): the sequential stack,
the computation graph, and KV-cache generation over the stack."""
