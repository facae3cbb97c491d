#!/usr/bin/env python3
"""Time the port's paged attention kernels at head dims 256, 192 and 160
of two checkouts in turns on one CUDA card.

    python3 scripts/paged_turns.py BEFORE_DIR AFTER_DIR

Each directory is a checkout of the repository (for example the parent
commit unpacked with ``git archive``).  The turns run BEFORE, AFTER,
AFTER, BEFORE, each in a process of its own that imports that
checkout's ``deeplearning4j_torch`` (its kernels built in its own
``kernels/_build``), and time ``paged_decode_attention`` (K1) and
``paged_verify_attention`` (K2, W 5) in bf16 at ``chip_smoke.py``
phase ``timings``' shapes — 8 slots at ``path_mid``'s contexts, block
16, 64-entry tables, 12 layers' pools in rotation so the 50 MB L2
cannot hold them — at 3 heads of 256, 4 of 192 and 3 of 160, by CUDA-graph
replay (``chip_smoke.time_ms``, from this script's checkout), beside
one SDPA call over the same K/V gathered beforehand and the bound
(``chip_smoke.paged_bound``).  Each turn holds its kernels to their
plain versions (``chip_smoke.flash_err``, ``PAGED_TOL``).  Prints one
JSON line per turn, then a summary with the card's name and power
limit; exits nonzero without a card or when a kernel disagrees.

    python3 scripts/paged_turns.py --runtime-dh

runs the same turns with this checkout as BEFORE and, as AFTER, a copy
of its package (under ``archive_check/runtime_dh``, which git ignores)
whose wide builds read every head dim at run time: the builds with the
head dim folded in (K1 at the multiples of 64, K2 where dh is its width
class) switched off by a source edit — what folding them buys at 256
and 192 (at 160 both trees run the same runtime builds).

    python3 scripts/paged_turns.py --stages

times this checkout's wide builds alone at the same shapes with the
split-K chunk forced larger through ``split_rows`` (the shape the chunk
is chosen for): K1 at chunks 32, 64, 128 and 224 rows (ring stages
min(3, pages a split) = 2, 3, 3, 3 at block 16), K2 at 64, 128 and 256
keys (stages min(2, 64-key tiles a split) = 1, 2, 2) — fewer, longer
splits whose copies overlap inside a block against more blocks in
flight.  Prints one JSON line with the card's name and power limit."""
import importlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((256, 3), (192, 4), (160, 3))   # (head dim, heads)
B, BS, MB, NL, W = 8, 16, 64, 12, 5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turn(tree: str) -> dict:
    """One turn: this process times ``tree``'s kernels."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, os.path.abspath(tree))
    pa = importlib.import_module(
        "deeplearning4j_torch.kernels.paged_attention")
    cs = _chip_smoke()
    positions = cs.path_mid(np)
    dev, dtype, L = "cuda", torch.bfloat16, MB * BS
    out = {"tree": tree, "ms": {}, "err": {}, "bound_ms": {}, "build": {}}
    for dh, h in SHAPES:
        g = torch.Generator(device=dev).manual_seed(dh)
        nb = 1 + B * MB
        kp = torch.randn((NL, nb, h, BS, dh), generator=g,
                         device=dev).to(dtype)
        vp = torch.randn((NL, nb, h, BS, dh), generator=g,
                         device=dev).to(dtype)
        table = (torch.randperm(nb - 1, generator=g, device=dev)[:B * MB]
                 .reshape(B, MB) + 1).to(torch.int32)
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        scale = 1.0 / math.sqrt(dh)
        q1 = torch.randn((B, h, dh), generator=g, device=dev).to(dtype)
        q2 = torch.randn((B, W, h, dh), generator=g, device=dev).to(dtype)
        kl = [pa.paged_gather(kp[i], table) for i in range(NL)]
        vl = [pa.paged_gather(vp[i], table) for i in range(NL)]
        rows = pos.long()[:, None] + torch.arange(W, device=dev)[None, :]
        cols = torch.arange(L, device=dev)
        mask1 = (cols[None, :] <= pos.long()[:, None])[:, None, None, :]
        mask2 = (cols[None, None, :] <= rows[:, :, None])[:, None]
        q2h = q2.transpose(1, 2).contiguous()
        for kern, wrapper, q, lib in (
                ("K1", pa.paged_decode_attention, q1,
                 lambda i: F.scaled_dot_product_attention(
                     q1[:, :, None, :], kl[i % NL], vl[i % NL],
                     attn_mask=mask1, scale=scale)),
                ("K2", pa.paged_verify_attention, q2,
                 lambda i: F.scaled_dot_product_attention(
                     q2h, kl[i % NL], vl[i % NL], attn_mask=mask2,
                     scale=scale))):
            key = f"{kern}/dh{dh}"
            plain = getattr(pa, f"{wrapper.__name__}_reference")
            err = cs.flash_err(torch, wrapper(q, kp[0], vp[0], table, pos,
                                              scale).float(),
                               plain(q, kp[0], vp[0], table, pos,
                                     scale).float())[0]
            if not err <= cs.PAGED_TOL[kern]["bfloat16"]:
                raise AssertionError(f"{tree}: {key} kernel vs plain {err}")
            out["err"][key] = err
            wrapper.builds = {}
            wrapper(q, kp[0], vp[0], table, pos, scale)
            out["build"][key] = sorted(getattr(wrapper, "builds", {}))
            out["ms"][key] = cs.time_ms(
                torch, lambda i: wrapper(q, kp[i % NL], vp[i % NL], table,
                                         pos, scale))
            out["ms"][f"sdpa_{key}"] = cs.time_ms(torch, lib)
            out["bound_ms"][key] = cs.paged_bound(
                positions, h, dh, BS, L, None if kern == "K1" else W)[0]
        del kp, vp, kl, vl
        torch.cuda.empty_cache()
    return out


# split_rows (slots, heads) that force each chunk at a 1024-row table on
# 132 SMs (``decode_split_rows``, ``verify_split_rows``); None: the
# call's own (B, h)
STAGE_SPLIT_ROWS = (None, (38, 1), (88, 1), (132, 1))


def stages() -> dict:
    """The wide builds at forced chunks (see the module's docstring),
    each held to its plain version."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from deeplearning4j_torch.kernels import paged_attention as pa
    cs = _chip_smoke()
    positions = cs.path_mid(np)
    dev, dtype, L = "cuda", torch.bfloat16, MB * BS
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for dh, h in SHAPES:
        g = torch.Generator(device=dev).manual_seed(dh)
        nb = 1 + B * MB
        kp = torch.randn((NL, nb, h, BS, dh), generator=g,
                         device=dev).to(dtype)
        vp = torch.randn((NL, nb, h, BS, dh), generator=g,
                         device=dev).to(dtype)
        table = (torch.randperm(nb - 1, generator=g, device=dev)[:B * MB]
                 .reshape(B, MB) + 1).to(torch.int32)
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        scale = 1.0 / math.sqrt(dh)
        q1 = torch.randn((B, h, dh), generator=g, device=dev).to(dtype)
        q2 = torch.randn((B, W, h, dh), generator=g, device=dev).to(dtype)
        for kern, wrapper, q, verify in (
                ("K1", pa.paged_decode_attention, q1, False),
                ("K2", pa.paged_verify_attention, q2, True)):
            plain = getattr(pa, f"{wrapper.__name__}_reference")(
                q, kp[0], vp[0], table, pos, scale).float()
            seen = set()
            for sr in STAGE_SPLIT_ROWS:
                route, chunk = pa.call_route(q, kp[0], table, verify, sr,
                                             n_sm)
                if route != "wide" or chunk in seen:
                    continue
                seen.add(chunk)
                err = cs.flash_err(torch, wrapper(
                    q, kp[0], vp[0], table, pos, scale,
                    split_rows=sr).float(), plain)[0]
                if not err <= cs.PAGED_TOL[kern]["bfloat16"]:
                    raise AssertionError(f"{kern}/dh{dh} chunk {chunk}: "
                                         f"kernel vs plain {err}")
                rows.append({
                    "kernel": kern, "dh": dh, "h": h, "chunk": chunk,
                    "stages": (min(3, chunk // BS) if not verify
                               else min(2, chunk // 64)),
                    "n_split": -(-L // chunk), "err": err,
                    "ms": cs.time_ms(torch, lambda i: wrapper(
                        q, kp[i % NL], vp[i % NL], table, pos, scale,
                        split_rows=sr))})
        del kp, vp
        torch.cuda.empty_cache()
    return {"stages": rows, "card": cs.card_line()}


# the source edits that switch the folded wide builds off (--runtime-dh)
CSRC = "deeplearning4j_torch/kernels/csrc"
RUNTIME_DH_EDITS = (
    (f"{CSRC}/paged_decode.cu", "  switch (dh) {   // the multiples",
     "  switch (-1) {   // the multiples"),
    (f"{CSRC}/paged_verify.cu", "  const bool exact = dh % 64 == 0;",
     "  const bool exact = false;"))


def runtime_dh_tree() -> str:
    """A copy of this checkout's package (what a turn imports) with
    ``RUNTIME_DH_EDITS`` applied."""
    dst = os.path.join(ROOT, "archive_check", "runtime_dh")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "deeplearning4j_torch"),
                    os.path.join(dst, "deeplearning4j_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for path, old, new in RUNTIME_DH_EDITS:
        with open(os.path.join(dst, path)) as f:
            src = f.read()
        if src.count(old) != 1:
            raise RuntimeError(f"{path}: the edit's anchor {old!r} is not "
                               "there once")
        with open(os.path.join(dst, path), "w") as f:
            f.write(src.replace(old, new))
    return dst


def main(argv) -> int:
    if argv[:1] == ["--stages"]:
        import torch
        if not torch.cuda.is_available():
            print("paged_turns: needs a CUDA card", file=sys.stderr)
            return 2
        print(json.dumps(stages()), flush=True)
        return 0
    if argv[:1] == ["--turn"]:
        print(json.dumps(turn(argv[1])), flush=True)
        return 0
    if argv[:1] == ["--runtime-dh"]:
        argv = [ROOT, runtime_dh_tree()]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("paged_turns: needs a CUDA card", file=sys.stderr)
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
                        "speedup": min(b_ms) / max(a_ms),
                        "bound_ms": turns[1]["bound_ms"].get(key)}
    print(json.dumps({"summary": summary, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
