#!/usr/bin/env python3
"""Hold the kernel phase's flash cases, kernels and plain versions
alike, to the same functions in f64, on one CUDA card.

    python3 scripts/flash_case_f64.py [CASE ...]

Each CASE names an entry of ``chip_smoke.FLASH_CASES`` (default: every
case past head dim 512).  The case runs as the kernel phase runs it
(``chip_smoke.flash_case``, its seed 100 + its place in the list) in
float32, K3 (or K4), K5 and K6 on the card, and prints for each output
(O, LSE, dQ, dK, dV, dBias) ``chip_smoke.flash_err``'s measure three
ways: kernel vs plain (what ``FLASH_TOL`` bounds), kernel vs f64 and
plain vs f64 (the plain versions run in f64 throughout on the same
inputs, with their own LSE and delta).  Where the kernel's f64 error is
the plain version's size, a kernel-vs-plain reading over the bound is
the two f32 summation orders' noise; where the kernel alone drifts, the
kernel is at fault.  One JSON line per case, then the card's name and
power limit; exits nonzero without a card."""
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_case_f64: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    fa = importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = argv or [c[0] for c in cs.FLASH_CASES if c[4] > 512]
    places = {c[0]: i for i, c in enumerate(cs.FLASH_CASES)}
    unknown = set(names) - set(places)
    if unknown:
        print(f"unknown cases {sorted(unknown)}", file=sys.stderr)
        return 2
    for name in names:
        i = places[name]
        _, b, t, h, dh, causal, bias, single = cs.FLASH_CASES[i]
        errs = cs.flash_case(torch, fa, b, t, h, dh, torch.float32, causal,
                             bias, single, seed=100 + i, f64=True)
        print(json.dumps({"case": name, "dtype": "float32",
                          "tol": cs.FLASH_TOL["float32"],
                          "outputs": {
                              out: {"kernel_vs_plain": err,
                                    "kernel_vs_f64": d["kernel_vs_f64"],
                                    "plain_vs_f64": d["plain_vs_f64"]}
                              for out, (err, d) in errs.items()}}),
              flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
