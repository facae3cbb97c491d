#!/usr/bin/env python3
"""K2's f32 error at its bound, over many seeds, on one CUDA card.

    python3 scripts/verify_seeds.py [N_SEEDS]

Runs ``chip_smoke.verify_case`` for the kernel phase's case
``verify_path_w17`` in float32 (the split-K v3 build,
``paged_verify_kernel<float>``: 8 slots, 6 heads of 128, block 16, a
64-entry table, W 17, one slot within W of the table's end) at seeds 0
.. N_SEEDS - 1 (64 by default).  For each seed it prints the kernel's
error against the plain f32 version (``chip_smoke.flash_err``, the
measure ``PAGED_TOL`` bounds) and both the kernel's and the plain f32
version's error against the same function in f64 throughout
(``chip_smoke.verify_reference_f64``) on the same inputs.  Where the
kernel's f64 error tracks the plain version's, the kernel-vs-plain
readings are the two f32 summation orders' noise; where the kernel alone
drifts, its merge is at fault.  Ends with a summary line (each measure's
median and max, the seeds over ``PAGED_TOL``, the largest ratio of the
kernel's f64 error to the plain version's) and the card's name and power
limit; exits nonzero without a card."""
import importlib.util
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 17
CASE = dict(B=8, h=6, dh=128, bs=16, mb=64, W=W,
            positions=[0, 15, 16, 17, 511, 1024 - W + 1, 700, 250])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv) -> int:
    n_seeds = int(argv[0]) if argv else 64
    import torch
    if not torch.cuda.is_available():
        print("verify_seeds: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from deeplearning4j_torch.kernels import paged_attention as pa
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = cs.PAGED_TOL["K2"]["float32"]
    rows = []
    for seed in range(n_seeds):
        err, detail = cs.verify_case(torch, pa, dtype=torch.float32,
                                     seed=seed, f64=True, **CASE)
        row = {"seed": seed, "kernel_vs_plain": err,
               "kernel_vs_f64": detail["kernel_vs_f64"],
               "plain_vs_f64": detail["plain_vs_f64"],
               "max_abs_err": detail["max_abs_err"]}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def spread(key):
        xs = [r[key] for r in rows]
        return {"median": statistics.median(xs), "max": max(xs)}

    print(json.dumps({
        "summary": {k: spread(k) for k in ("kernel_vs_plain",
                                           "kernel_vs_f64",
                                           "plain_vs_f64")},
        "over_tol": [r["seed"] for r in rows if r["kernel_vs_plain"] > tol],
        "tol": tol,
        "max_ratio_kernel_to_plain_f64": max(
            r["kernel_vs_f64"] / r["plain_vs_f64"] for r in rows),
        "card": cs.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
