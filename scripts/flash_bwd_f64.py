#!/usr/bin/env python3
"""Hold the bf16 flash backward (K5 and K6) and its plain version to the
same function in f64 on one CUDA card.

    python3 scripts/flash_bwd_f64.py

At the inputs of ``tests/test_torch_flash_attention.py``'s
``test_cuda_wide_bwd_causal_long_t`` (b 1, 2 heads, causal, t 2000 and
2048, with and without a key bias, bthd views of a bf16 [b, t, 3d]
projection, the same seeds) at head dims 256, 320, 384, 448 and 512,
K5 and K6 run on the plain forward's O and LSE.  For dQ, dK and dV it
prints, with ``chip_smoke.flash_err``'s measure (each element to its
own size or to the output's RMS): kernel vs plain, kernel vs f64 and
plain vs f64 (the f64 run takes the bf16 inputs, computes LSE and delta
itself and rounds nothing), and at the element where kernel and plain
differ most, the three values.  Both bf16 builds round P and dS * scale
to bf16, so each lies some rounding away from the f64 result; this
shows how far.  One JSON line per case, then the card's name and power
limit; exits nonzero without a card."""
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAD_DIMS = (256, 320, 384, 448, 512)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_f64: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    fa = importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")
    bh = fa._to_bh
    for dh in HEAD_DIMS:
        for t in (2000, 2048):
            for with_bias in (False, True):
                g = torch.Generator(device="cuda").manual_seed(
                    dh + t + with_bias + 1)
                b, h = 1, 2
                qkv = torch.randn((b, t, 3 * h * dh), generator=g,
                                  device="cuda").to(torch.bfloat16)
                q, k, v = (z.reshape(b, t, h, dh)
                           for z in qkv.split(h * dh, dim=-1))
                bias = (torch.randn((b * h, t), generator=g, device="cuda")
                        if with_bias else None)
                do = torch.randn((b, t, h, dh), generator=g,
                                 device="cuda").to(torch.bfloat16)
                kw = dict(causal=True, scale=dh ** -0.5)
                o, lse = fa.flash_fwd_reference(bh(q), bh(k), bh(v), bias,
                                                **kw)
                delta = fa.row_delta(do, fa._from_bh(o, b, h))
                dk, dv, _ = fa.flash_bwd_dkdv(q, k, v, bias, do, lse, delta,
                                              need_dbias=with_bias, **kw)
                dq = fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, **kw)
                plain = fa.flash_bwd_reference(bh(q), bh(k), bh(v), bias,
                                               bh(do), lse, delta, **kw)
                x64 = [bh(x).double() for x in (q, k, v, do)]
                b64 = None if bias is None else bias.double()
                o64, lse64 = fa.flash_fwd_reference(*x64[:3], b64, **kw)
                exact = fa.flash_bwd_reference(
                    *x64[:3], b64, x64[3], lse64, (x64[3] * o64).sum(-1),
                    **kw)
                row = {"dh": dh, "t": t, "bias": with_bias}
                for name, got, want, ref in (
                        ("dq", bh(dq), plain[0], exact[0]),
                        ("dk", bh(dk), plain[1], exact[1]),
                        ("dv", bh(dv), plain[2], exact[2])):
                    got, want, ref = got.double(), want.double(), ref.double()
                    rms = want.square().mean().sqrt()
                    rel = (got - want).abs() / (want.abs() + rms)
                    at = tuple(int(i) for i in torch.unravel_index(
                        rel.argmax(), rel.shape))
                    row[name] = {
                        "kernel_vs_plain": cs.flash_err(torch, got, want)[0],
                        "kernel_vs_f64": cs.flash_err(torch, got, ref)[0],
                        "plain_vs_f64": cs.flash_err(torch, want, ref)[0],
                        "at": at, "kernel": float(got[at]),
                        "plain": float(want[at]), "f64": float(ref[at])}
                print(json.dumps(row), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
