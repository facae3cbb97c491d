"""Activations, weight init and layer configs (port of
``deeplearning4j_tpu.nn``)."""
