#!/usr/bin/env python3
"""Which cost sets the pace of the bf16 cluster forward (K3 and K4 past
head dim 512, ``flash_fwd_bf16_cluster_kernel``): time this checkout's
kernel beside copies of it with one cost taken out, on one CUDA card.

    python3 scripts/flash_cluster_costs.py [VARIANT ...]

Each variant is a copy of ``deeplearning4j_torch/`` under
``deeplearning4j_torch/kernels/_build/variants/<name>/`` (a directory
git ignores) whose ``csrc/flash_fwd.cu`` is edited by exact text
replacement (the script fails if the text is not found); the copies'
results are wrong by design and are only timed:

* ``no_exchange``: no exchange at all — each block runs the softmax on
  whatever its sum buffer holds;
* ``sync_only``: the exchange's two waits on the same blocks, each
  block sending one 16-byte store where it sent its partial and its
  sums (the waits and the lockstep, no data moved);
* ``no_overlap``: tile j + 1's Q K^T after tile j's sums have come,
  not while they travel;
* ``no_pv``: the whole exchange, no ``P V`` product.

Every variant's library is built first (one ``nvcc`` each, all at once);
then the turns run BASE, variants..., variants reversed, BASE, each in a
process of its own, timing ``flash_fwd`` (K3, b 8, t 2048, causal) and
``flash_fwd_single`` (K4, t 512) at 2 heads of 576, 1 of 768 and 4 of
1024 by CUDA-graph replay over 4 rotating input sets
(``chip_smoke.time_ms``).  The base is held to the plain version
(``FLASH_TOL``).  Prints one JSON line per turn, then a summary (each
variant's median ms beside the base's) with the card's name and power
limit; exits nonzero without a card."""
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "deeplearning4j_torch")
VARIANT_DIR = os.path.join(PKG, "kernels", "_build", "variants")
# (head dim, heads); K3 at b 8, t 2048 causal, K4 at t 512
SHAPES = ((576, 2), (768, 1), (1024, 4))
N_SETS = 4

_EXPECT = """    mbar_expect(bar_part, (uint32_t)(n_rank * (v_hi - v_lo) * 16));
    mbar_expect(bar_sum + 8 * (j & 1), kVecs * 16);
"""
_SEND = """#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int v = i * kWgThreads + tid;
        const uint32_t o = vec_owner(v);
        st_async4(part_s + ((int)rank * run + v - (int)o * kVecs / (int)n_rank) * 16, bar_part,
                  o, s[i]);
      }
"""
_REDUCE_HEAD = """      mbar_wait_cluster(bar_part, j & 1);
      for (int v = v_lo + tid; v < v_hi; v += kWgThreads) {
"""
_REDUCE_TAIL = """        for (uint32_t q = 0; q < n_rank; ++q) st_async4(sum_j + v * 16, bar_sum_j, q, sum);
      }
"""
_SUM_WAIT = """      mbar_wait_cluster(bar_sum_j, (j >> 1) & 1);
"""
_AHEAD = """      if (j + 1 < n_seq) scores(j + 1);
"""
_SEND_NEXT = """      if (j + 1 < n_seq) send_partial();
"""
_PV = """#pragma unroll
        for (int kc = 0; kc < NJ / 2; ++kc)
          Wgmma<N>::rs(o, pf[kc], sw128_desc(v_s + kc * 16 * 128, L::kKvPanel, 1024), 1);
"""


def _cut(text: str, start: str, end: str) -> str:
    """``text`` from ``start`` to the end of ``end`` (both in it once)."""
    a = text.index(start)
    return text[a:text.index(end, a) + len(end)]


# variant -> [(old text, new text)]; "reduce" stands for tile j's
# reduce-scatter step, cut out of the source as it stands
VARIANTS = {
    "no_exchange": [(_EXPECT, ""), (_SEND, ""), ("reduce", ""),
                    (_SUM_WAIT, "")],
    # one 16-byte store to each block where the data went, each phase:
    # the same waits on the same blocks, no data moved
    "sync_only": [
        (_EXPECT, _EXPECT.replace("(v_hi - v_lo) * 16", "16")
         .replace("kVecs * 16", "n_rank * 16")),
        (_SEND, """      if (tid < (int)n_rank) st_async4(part_s + rank * 16, bar_part, tid, s[0]);
"""),
        ("reduce", """      mbar_wait_cluster(bar_part, j & 1);
      if (tid < (int)n_rank) st_async4(sum_j + rank * 16, bar_sum_j, tid, s[0]);
""")],
    # tile j + 1's Q K^T after tile j's sums have come, not while they
    # travel
    "no_overlap": [(_AHEAD, ""), (_SEND_NEXT, """      if (j + 1 < n_seq) {
        scores(j + 1);
        send_partial();
      }
""")],
    "no_pv": [(_PV, "")],
}


def make_variant(name: str) -> str:
    """A copy of the package with ``name``'s edits; returns its root (the
    directory to put on ``sys.path``)."""
    root = os.path.join(VARIANT_DIR, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, os.path.join(root, "deeplearning4j_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = os.path.join(root, "deeplearning4j_torch", "kernels", "csrc",
                       "flash_fwd.cu")
    with open(src) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if old == "reduce":
            old = _cut(text, _REDUCE_HEAD, _REDUCE_TAIL)
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to replace is not in "
                             f"flash_fwd.cu once:\n{old}")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text)
    return root


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(tree: str) -> None:
    """Build ``tree``'s flash_fwd library (in its own kernels/_build)."""
    sys.path.insert(0, tree)
    importlib.import_module("deeplearning4j_torch.kernels._build").build_all(
        ["flash_fwd"])


def turn(tree: str, check: bool) -> dict:
    """One turn: this process times ``tree``'s K3 and K4 at SHAPES."""
    import torch
    sys.path.insert(0, tree)
    fa = importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")
    cs = _chip_smoke()
    g = torch.Generator(device="cuda").manual_seed(9)
    bh = fa._to_bh
    out = {"tree": tree, "ms": {}, "builds": {}}
    for dh, h in SHAPES:
        kw = dict(causal=True, scale=dh ** -0.5)
        for name, t in (("flash_fwd", 2048), ("flash_fwd_single", 512)):
            sets = []
            for _ in range(N_SETS):
                qkv = torch.randn((8, t, 3 * h * dh), generator=g,
                                  device="cuda").to(torch.bfloat16)
                sets.append([z.reshape(8, t, h, dh)
                             for z in qkv.split(h * dh, dim=-1)])
            fn = getattr(fa, name)
            key = f"{name}/{h}x{dh}"
            if check:
                o, _ = fn(*sets[0], None, **kw)
                ro, _ = fa.flash_fwd_reference(
                    *(bh(x) for x in sets[0]), None,
                    single=name.endswith("single"), **kw)
                err = cs.flash_err(torch, bh(o).float(), ro.float())[0]
                if not err <= cs.FLASH_TOL["bfloat16"]:
                    raise AssertionError(f"{key}: kernel vs plain {err}")
                del o, ro
            out["ms"][key] = cs.time_ms(
                torch, lambda i: fn(*sets[i % N_SETS], None, **kw))
            out["builds"][key] = fa.fwd_build(dh, True)
            del sets
            torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if argv[:1] == ["--build"]:
        build(argv[1])
        return 0
    if argv[:1] == ["--turn"]:
        print(json.dumps(turn(argv[1], argv[2] == "check")), flush=True)
        return 0
    names = argv or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        print(f"unknown variants {sorted(unknown)}; known "
              f"{sorted(VARIANTS)}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("flash_cluster_costs: needs a CUDA card", file=sys.stderr)
        return 2
    trees = {"base": ROOT, **{n: make_variant(n) for n in names}}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--build", tree]) for tree in trees.values()]
    if any(p.wait() != 0 for p in procs):
        return 1
    order = ["base"] + names + names[::-1] + ["base"]
    turns = {n: [] for n in trees}
    for name in order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn",
             trees[name],
             "check" if name == "base" else "time"],
            capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        row = json.loads(res.stdout.strip().splitlines()[-1])
        row["variant"] = name
        turns[name].append(row)
        print(json.dumps(row), flush=True)
    summary = {key: {n: sorted(r["ms"][key] for r in rows)
                     for n, rows in turns.items()}
               for key in turns["base"][0]["ms"]}
    print(json.dumps({"summary": summary,
                      "card": _chip_smoke().card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
