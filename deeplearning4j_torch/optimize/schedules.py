"""Learning-rate schedules (port of
``deeplearning4j_tpu/optimize/schedules.py``).

A schedule is fn(step) -> lr.  The reference traces it into the compiled
step on a device scalar; the port's step index is a host integer, so the
same formulas run in Python floats.  Stepped per ITERATION (DL4J
``ScheduleType.ITERATION``).
"""
from __future__ import annotations

import math


def schedule_from_spec(spec):
    """spec: float (fixed) or dict {"type": ..., ...} -> fn(step) -> lr."""
    if spec is None:
        return lambda step: 0.0
    if isinstance(spec, (int, float)):
        v = float(spec)
        return lambda step: v
    t = str(spec.get("type", "fixed")).lower()
    if t == "fixed":
        v = float(spec["value"])
        return lambda step: v

    lr = float(spec.get("initial", spec.get("value", 0.1)))
    if t == "exponential":
        gamma = float(spec.get("gamma", 0.99))
        return lambda step: lr * gamma ** step
    if t == "inverse":
        gamma, power = (float(spec.get("gamma", 0.99)),
                        float(spec.get("power", 1.0)))
        return lambda step: lr / (1.0 + gamma * step) ** power
    if t == "poly":
        power = float(spec.get("power", 1.0))
        max_iter = float(spec["max_iter"])
        return lambda step: (lr * (1.0 - min(step, max_iter) / max_iter)
                             ** power)
    if t == "step":
        decay, step_size = float(spec.get("decay", 0.1)), float(spec["step"])
        return lambda step: lr * decay ** math.floor(step / step_size)
    if t == "sigmoid":
        gamma, step_size = float(spec.get("gamma", 0.99)), float(spec["step"])
        return lambda step: lr / (1.0 + math.exp(-gamma * (step - step_size)))
    if t == "ramp":  # warmup to lr over `warmup` steps, then constant
        warmup = float(spec.get("warmup", 1000))
        return lambda step: lr * min(1.0, (step + 1) / warmup)
    if t == "warmup_cosine":
        warmup = float(spec.get("warmup", 1000))
        total = float(spec["max_iter"])

        def fn(step):
            if step < warmup:
                return lr * min(1.0, (step + 1) / warmup)
            prog = min(max((step - warmup) / max(total - warmup, 1), 0), 1)
            return 0.5 * lr * (1 + math.cos(math.pi * prog))
        return fn
    if t == "cycle":
        cycle_len = float(spec["cycle_length"])
        max_lr = float(spec.get("max", lr * 10))

        def fn(step):
            pos = (step % cycle_len) / cycle_len
            return lr + (max_lr - lr) * (1.0 - abs(2.0 * pos - 1.0))
        return fn
    if t == "map":
        # {"type":"map","values":{"0":0.1,"1000":0.01}} — piecewise constant
        points = sorted((int(k), float(v)) for k, v in spec["values"].items())

        def fn(step):
            out = points[0][1]
            for s, v in points:
                if step >= s:
                    out = v
            return out
        return fn
    raise ValueError(f"Unknown schedule type {t!r}")
