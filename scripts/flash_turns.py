#!/usr/bin/env python3
"""Time the port's bf16 flash kernels at head dims 256, 192, 320, 384,
576 and 768 of two checkouts in turns on one CUDA card.

    python3 scripts/flash_turns.py BEFORE_DIR AFTER_DIR

Each directory is a checkout of the repository (for example the parent
commit unpacked with ``git archive``).  The turns run BEFORE, AFTER,
AFTER, BEFORE, each in a process of its own that imports that
checkout's ``deeplearning4j_torch`` (its kernels built in its own
``kernels/_build``), and time ``flash_fwd`` (K3) at b 8, t 2048, causal,
``flash_fwd_single`` (K4) at t 512, and the backward at t 2048:
``flash_bwd_dkdv`` (K5) and ``flash_bwd_dq`` (K6) on the turn's own
forward's LSE — bthd views of a [b, t, 3d] projection, at 3 heads of
256 and at 4 heads of 192 — by CUDA-graph replay over 4 rotating input
sets (``chip_smoke.time_ms``'s measure, from this script's checkout).
Past 256 the same at ``chip_smoke.py`` phase ``infer`` (g)'s shape (b
16, 2 heads of 320, not causal, K3, K5 and K6 at t 1024, K4 at t 512)
and at phase ``wide`` (d)'s (b 8, 2 heads of 384, causal, t 2048 and
512).  Past 512, K3 and K4 alone (the backward there is the chunked
build in both trees): at the extra phase ``chunked``'s 2 heads of 576
and at ``wide`` (g)'s one head of 768 (b 8, causal, t 2048 and 512).
Each turn also times SDPA's whole backward (dq, dk and dv at
once, ``chip_smoke.sdpa_bwd_ms``) on the same inputs as the yardstick
of the backward, and holds its kernels to their plain
versions (``chip_smoke.flash_err``, ``FLASH_TOL``).  Prints one JSON
line per turn, then a summary with the card's name and power limit;
exits nonzero without a card or when a kernel disagrees."""
import importlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (head dim, heads, b, K3's t (and K5/K6's), K4's t, causal, backward
# timed)
SHAPES = ((256, 3, 8, 2048, 512, True, True),
          (192, 4, 8, 2048, 512, True, True),
          (320, 2, 16, 1024, 512, False, True),
          (384, 2, 8, 2048, 512, True, True),
          (576, 2, 8, 2048, 512, True, False),
          (768, 1, 8, 2048, 512, True, False))
N_SETS = 4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sets(torch, g, b, h, dh, t):
    """N_SETS bf16 (q, k, v, dO) bthd views of [b, t, 3 h dh]
    projections."""
    sets = []
    for _ in range(N_SETS):
        qkv = torch.randn((b, t, 3 * h * dh), generator=g,
                          device="cuda").to(torch.bfloat16)
        do = torch.randn((b, t, h, dh), generator=g,
                         device="cuda").to(torch.bfloat16)
        sets.append([z.reshape(b, t, h, dh)
                     for z in qkv.split(h * dh, dim=-1)] + [do])
    return sets


def turn(tree: str) -> dict:
    """One turn: this process times ``tree``'s kernels."""
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, os.path.abspath(tree))
    fa = importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")
    cs = _chip_smoke()
    g = torch.Generator(device="cuda").manual_seed(9)
    out = {"tree": tree, "ms": {}, "err": {}}

    def hold(key, got, want):
        err = cs.flash_err(torch, got.float(), want.float())[0]
        if not err <= cs.FLASH_TOL["bfloat16"]:
            raise AssertionError(f"{tree}: {key} kernel vs plain {err}")
        out["err"][key] = err

    bh = fa._to_bh
    for dh, h, b, t_stream, t_single, causal, with_bwd in SHAPES:
        kw = dict(causal=causal, scale=dh ** -0.5)
        for name, t in (("flash_fwd", t_stream),
                        ("flash_fwd_single", t_single)):
            sets = _sets(torch, g, b, h, dh, t)
            fn = getattr(fa, name)
            o, _ = fn(*sets[0][:3], None, **kw)
            ro, _ = fa.flash_fwd_reference(*(bh(x) for x in sets[0][:3]),
                                           None, single=name.endswith(
                                               "single"), **kw)
            key = f"{name}/dh{dh}"
            hold(key, bh(o), ro)
            out["ms"][key] = cs.time_ms(
                torch, lambda i: fn(*sets[i % N_SETS][:3], None, **kw))
            del sets, o, ro
            torch.cuda.empty_cache()
        if not with_bwd:
            continue
        # the backward at t_stream on this turn's forward
        sets = _sets(torch, g, b, h, dh, t_stream)
        outs = [fa.flash_fwd(*s[:3], None, **kw) for s in sets]
        deltas = [fa.row_delta(s[3], o) for s, (o, _) in zip(sets, outs)]
        bwd = {
            "flash_bwd_dkdv": lambda i: fa.flash_bwd_dkdv(
                *sets[i % N_SETS][:3], None, sets[i % N_SETS][3],
                outs[i % N_SETS][1], deltas[i % N_SETS], **kw),
            "flash_bwd_dq": lambda i: fa.flash_bwd_dq(
                *sets[i % N_SETS][:3], None, sets[i % N_SETS][3],
                outs[i % N_SETS][1], deltas[i % N_SETS], **kw)}
        rq, rk, rv, _ = fa.flash_bwd_reference(
            *(bh(x) for x in sets[0][:3]), None, bh(sets[0][3]),
            outs[0][1], deltas[0], **kw)
        dk, dv, _ = bwd["flash_bwd_dkdv"](0)
        hold(f"flash_bwd_dkdv/dh{dh}/dk", bh(dk), rk)
        hold(f"flash_bwd_dkdv/dh{dh}/dv", bh(dv), rv)
        hold(f"flash_bwd_dq/dh{dh}/dq", bh(bwd["flash_bwd_dq"](0)), rq)
        del rq, rk, rv, dk, dv
        for name, fn in bwd.items():
            out["ms"][f"{name}/dh{dh}"] = cs.time_ms(torch, fn)
        sdpa_in = [tuple(x.transpose(1, 2).contiguous() for x in s)
                   for s in sets]
        out["ms"][f"sdpa_bwd/dh{dh}"] = cs.sdpa_bwd_ms(
            torch, F, sdpa_in, kw["scale"], N_SETS, causal=causal)[0]
        del sets, outs, deltas, sdpa_in
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if argv[:1] == ["--turn"]:
        print(json.dumps(turn(argv[1])), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("flash_turns: needs a CUDA card", file=sys.stderr)
        return 2
    before, after = argv
    turns = []
    for tree in (before, after, after, before):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", tree], capture_output=True,
                             text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        turns.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    card = _chip_smoke().card_line()
    summary = {}
    for key in turns[0]["ms"]:
        b_ms = [turns[i]["ms"][key] for i in (0, 3)]
        a_ms = [turns[i]["ms"][key] for i in (1, 2)]
        summary[key] = {"before_ms": b_ms, "after_ms": a_ms,
                        "speedup": min(b_ms) / max(a_ms)}
    print(json.dumps({"summary": summary, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
