"""Data-parallel scaling-efficiency harness (port of
``deeplearning4j_tpu/parallel/scaling.py``).

Train the same model at several mesh widths with a FIXED per-device
batch (weak scaling, the DP regime), report examples/sec and efficiency
against linear.  The mesh is the only variable: the same call runs on
CPU devices (tests), one card, or several.  On one card listed n times
the rows measure the port's sharded step driven n ways on one device,
not scaling across cards.
"""
from __future__ import annotations

import json
import time
from typing import Callable, List, Optional, Sequence

from deeplearning4j_torch.parallel.mesh import MeshConfig, default_devices
from deeplearning4j_torch.parallel.trainer import ShardedTrainer


def measure_scaling(model_fn: Callable[[], object],
                    make_batch: Callable[[int], tuple],
                    per_device_batch: int = 32,
                    device_counts: Optional[Sequence[int]] = None,
                    n_steps: int = 10, warmup: int = 2,
                    out_path: Optional[str] = None,
                    devices=None) -> List[dict]:
    """``model_fn()`` builds a fresh model; ``make_batch(global_n)``
    returns (features, labels) for a global batch of ``global_n``
    examples.  Returns one row per device count —
    ``{"devices", "global_batch", "examples_per_sec",
    "efficiency_vs_linear"}`` — and writes them as a JSON artefact when
    ``out_path`` is given.  ``devices`` defaults to every CUDA device."""
    all_devs = list(devices) if devices is not None else default_devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32, 64)
                         if n <= len(all_devs)]
    rows: List[dict] = []
    for n in device_counts:
        model = model_fn()
        trainer = ShardedTrainer(model, MeshConfig(data=n),
                                 devices=all_devs[:n])
        # two rotating input buffers, a scalar readback at the end
        batches = [make_batch(n * per_device_batch) for _ in range(2)]
        loss = None
        for i in range(warmup):
            loss = trainer.fit_batch(*batches[i % 2])
        if loss is not None:        # warmup=0 is legal
            float(loss)
        t0 = time.perf_counter()
        for i in range(n_steps):
            loss = trainer.fit_batch(*batches[i % 2])
        float(loss)
        dt = time.perf_counter() - t0
        gb = int(batches[0][0].shape[0])
        rows.append({"devices": n, "global_batch": gb,
                     "examples_per_sec": round(gb * n_steps / dt, 2)})
    base = rows[0]["examples_per_sec"] / rows[0]["devices"]
    for r in rows:
        r["efficiency_vs_linear"] = round(
            r["examples_per_sec"] / (base * r["devices"]), 4)
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"metric": "dp_weak_scaling", "rows": rows}, f,
                      indent=1)
    return rows
