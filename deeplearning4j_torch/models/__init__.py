"""Models (port of ``deeplearning4j_tpu.models``): the sequential stack and
KV-cache generation over it."""
