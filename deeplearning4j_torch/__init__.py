"""deeplearning4j_torch — the PyTorch/CUDA port of ``deeplearning4j_tpu``.

Same module paths, parameter names, layouts, configuration JSON and
checkpoint zip as the JAX package, which stays the reference the port is
held against.  The port imports ``torch`` and ``numpy`` only — never
``jax`` and nothing of ``deeplearning4j_tpu``.

Entry points (``MultiLayerNetwork.init``, ``restore_model``,
``TransformerGenerator``, ``GenerationServer``) take ``device=`` and
default to ``"cuda"``; on a machine without CUDA that default raises
instead of quietly running on the CPU.  Pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels.

Slices so far: serving the causal decoder (``zoo.Gpt`` ->
``MultiLayerNetwork`` -> ``models.generation.TransformerGenerator`` ->
``parallel.generation_server.GenerationServer``, speculative decode
included) on the paged decode and verify kernels, and training the same
stack (``MultiLayerNetwork.fit``) on the flash-attention kernels,
forward and backward — every kernel hand-written CUDA under
``kernels/csrc/``; the fleet (``serving.ServingFleet``) and its SLO control
plane (``telemetry.{tsdb,slo,exposition,fleet}``,
``serving.{degrade,autoscale}``); BERT and ResNet-50 training; and
resumable training (``parallel.CheckpointListener`` +
``fit(resume=True)``, ``resilience.auto_resume_fit``, preemption and the
bad-step policy), every updater, and ``utils.gradient_check``.
"""
__version__ = "0.1.0"
