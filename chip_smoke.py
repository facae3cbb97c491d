#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``deeplearning4j_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port only (no JAX, nothing of ``deeplearning4j_tpu``),
prints one JSON line per phase, and ends with
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Any failure raises
and exits nonzero without that line; without CUDA it exits 2 at once.

Phases:
  1. build   — compile every CUDA source under deeplearning4j_torch/kernels/
               csrc (one nvcc per source, all at once) and load them.
  2. kernel  — the paged decode kernel (K1) and the paged verify kernel
               (K2) against their plain PyTorch versions on the card: the
               serving path's shapes (8 slots, 6 heads of 128, block 16,
               64-entry tables; K2 at W = 2, 5 and 17 — two row groups —
               with one slot within W of the table's end) at mixed
               positions, K1 at positions on
               its split edges and with slots that fill only the first
               split beside slots that fill all, the pangrams
               checkpoint's shapes, block size 8 (K1); f32 and bf16, each
               element held to its own size (``flash_err``).
               Tables point at shuffled blocks; block 0 and every row past
               a slot's last valid position are NaN in the kernel's pool,
               so a finite, matching result on the valid rows proves the
               kernel never lets an unread row leak in.  Then the flash
               kernels K3/K4 (forward) and K5/K6 (backward) against their
               plain versions, f32 and bf16, on bthd views of a [b, t, 3d]
               projection whose rows past t are NaN: the training shapes
               (t 2048 on K3, t 512 on K4), a ragged t with a key bias,
               causal + bias at dh 64 (K3 and K4), plain at dh 64,
               BERT-base's attention (b 4, t 512, 12 heads of 64, a
               padding bias, on K4), t 896 on K4 (seven key tiles) and
               dh 32 (zero-padded to 64 by the wrappers) on K3-K6.
               Past the fast kernels' head dims: K1 and K2 at dh 12 (rows
               not 16-byte aligned), 160 and 256 (the any-dh kernel), K3-K6
               at dh 160 (padded to the 192 build) and 256.
  3. pangrams — the checked-in pangrams Gpt served by GenerationServer on
               the card (f32) equals the port's offline generate(), up to
               the near-tie rule; a shared prefix runs the cache-hit path.
  4. full    — default-width zoo.Gpt() (12 x 768, 6 x 128 heads, vocab
               32000, seeded random weights): (a) f32 greedy against
               offline generate(); (b) bf16, 16 mixed greedy/sampled
               requests, 4 sharing a 256-token system prompt — the main
               path, with K1's launch count reset before and read after.
  5. spec    — speculative decode through GenerationServer: (a) the
               pangrams checkpoint with a half-depth self-draft, k = 4,
               against offline generate() (near-tie rule) with a prefix
               hit, beside the plain server on the same requests, device
               kernels per committed token from a CUDA-only profile of
               each; (b) the default-width zoo.Gpt() in bf16 with phase
               4(b)'s 16 mixed requests, speculative={"k": 4, "rounds": 2,
               "draft_layers": 2, "adaptive": True} — the speculative main
               path: K1 and K2 counts reset before and read after, K2
               launched n_layers times per verify pass.
  6. fleet   — ServingFleet over the port's GenerationServer replicas,
               default-width zoo.Gpt() in bf16, seeded weights (replicas
               of n_slots 8, max_len 1024, block 16, tick_batch 8): (a) two
               unified replicas on the card serve phase 4(b)'s 16 requests
               across two tenants — greedy streams vs offline generate()
               under the bf16 near-tie rule, the shared system prompt
               routed by affinity, K1 counted from a reset (>= 12 x
               ticks); (b) the same with one replica killed mid-flight;
               (c) roles ("prefill", "decode"), prefill_threshold 256, both
               replicas speculative (k 4, 2 rounds, 2 draft layers): block
               handoff export_prefix -> import_blocks, K2 == 12 x verify
               passes, the prefill replica claims no draft blocks; (d) a
               host-tier spill -> fetch round trip compared byte for byte,
               and a stuck tick recovered by the watchdog under a submit
               with retries.  Tokens/s, TTFT p50/p99 and the
               fleet_request_phase_seconds split are printed with the
               card's name and power limit.
  7. train   — training through MultiLayerNetwork.fit: (a) default-width
               zoo.Gpt() in f32 at b 2, t 1024, one loss and gradient with
               use_flash on and off on the same params (rtol 1e-3); (b) the
               training main path: default-width Gpt() in bf16 (f32 master
               weights, Adam(3e-4)), b 8, t 2048, five fit steps on one
               seeded batch after a warm-up step — the loss finite and
               falling, K3, K5 and K6 each launched 12 x 5 times with the
               counts reset before and read after, no long-t fallback;
               tokens/s, peak memory, a CUDA-only profile of one step, and
               the same steps on plain attention (loss curves within 1e-3
               of each other, no flash launch); (c) the same at t 512,
               where the forward is K4 (with its own step profile).
  8. timings — K1 and K2, their plain versions and one PyTorch SDPA call
               each at the path shapes (CUDA-graph replay, medians), beside
               the memory bound; K3-K6 at the training shapes beside their
               plain versions, SDPA's forward and its backward alone
               (graph replay, the backward with the spread of its 9
               replays), all on the same rotating input sets, and the
               bound.

``--phases`` runs a subset (e.g. ``--phases build,kernel``).  The extra
phase ``profile`` (not run by default) traces a steady bf16 decode window
of the full-width server with ``torch.profiler``: device busy share,
kernel launches per tick and the top kernels by device time.  The extra
phases ``k3``, ``k4``, ``k5`` and ``k6`` time one flash kernel alone at
the training shapes (K4 also at BERT-base's, 12 heads of 64 with a
padding bias; K6 beside SDPA's backward), and ``k2`` the verify kernel
at phase 4(b)'s mid contexts with W = 5 beside one SDPA call, three
medians each, for quick comparisons of kernel versions in turns.  The
extra phase ``wide`` times the head-dim-256 builds (K1, K2 at 3 heads of
256; K3-K6 at b 8, 3 heads of 256) beside their plain versions and SDPA.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

PHASES = ("build", "kernel", "pangrams", "full", "spec", "fleet", "train",
          "timings")
EXTRA_PHASES = ("profile", "k2", "k3", "k4", "k5", "k6",
                "wide")  # only when asked
# near-tie rule: where a served stream and the offline stream diverge,
# the teacher-forced logits of the two tokens at the first divergence
# must lie within this much of each other (f32 logits; the two paths
# sum in different orders, so only a genuine near tie may flip argmax)
NEAR_TIE_F32 = 1e-4
# K1 and K2 vs plain, each element held to its own size as the flash
# kernels are (``flash_err``): f32 differs only by summation order (online
# softmax over tiles and splits vs one softmax over the row); bf16 by
# rounding points (the plain version rounds scores and P to bf16 and
# multiplies P.V in bf16, the kernels keep scores and the accumulator in
# f32 and round P at a running max).  Random-V outputs at a 1000-row
# context are ~0.03-0.1 in size, so an absolute bound of 2e-2 (the
# measure before) would pass a split that drops a chunk.  On an H100 the
# largest readings are K1 4.3e-7 (f32) and 9.2e-3 (bf16), K2 v2 7.3e-7 and
# 1.8e-2 (W = 5); the bounds are ~3x those.  K2 v3 reads 1.2e-6 / 1.8e-2
# at W = 5 and 1.9e-6 / 2.3e-2 at W = 17 (two row groups, larger
# contexts).
PAGED_TOL = {"K1": {"float32": 1.5e-6, "bfloat16": 3e-2},
             "K2": {"float32": 2.5e-6, "bfloat16": 5e-2}}
# the flash kernels' outputs span orders of magnitude (early causal rows
# near 4, most rows near 0.05 at t 2048; gradients up to ~10), so each
# element is held to its own size: max |kernel - plain| / (|plain| +
# RMS(plain)) — an allclose with rtol = the bound and atol = the bound x
# the output's RMS.  In bf16 the outputs' own rounding differs by up to
# one ulp (2^-7 relative), and K3 rounds P at each tile's running max
# where the plain version rounds it at the row's final max: on an H100
# the largest reading is 1.2e-2 (K3's O at t 2048), the others <= 7.4e-3,
# f32 <= 4e-6.  A K5 that skips its last query tile reads 1.27.
FLASH_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
SPEC_FULL = {"k": 4, "rounds": 2, "draft_layers": 2, "adaptive": True}
# (head dim, heads) of the K1/K2 cases the fast kernels do not take
ANY_DH = ((12, 6), (160, 3), (256, 3))
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12            # dense tensor-core bf16 peak


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# -- phase 2 -----------------------------------------------------------
def kernel_case(torch, pa, B, h, dh, bs, mb, positions, dtype, seed):
    """K1 vs the plain version on shuffled tables with NaN poison past
    every slot's position.  Returns :func:`flash_err` of the output."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    need = [p // bs + 1 for p in positions]
    assert max(need) <= mb
    nb = 1 + sum(need) + 5
    kp = torch.randn((nb, h, bs, dh), generator=g, device=dev).to(dtype)
    vp = torch.randn((nb, h, bs, dh), generator=g, device=dev).to(dtype)
    q = torch.randn((B, h, dh), generator=g, device=dev).to(dtype)
    perm = (torch.randperm(nb - 1, generator=g, device=dev) + 1).tolist()
    table = torch.zeros((B, mb), dtype=torch.int32)
    k_bad, v_bad = kp.clone(), vp.clone()
    k_bad[0] = float("nan")
    v_bad[0] = float("nan")
    for b, n in enumerate(need):
        ids, perm = perm[:n], perm[n:]
        table[b, :n] = torch.tensor(ids, dtype=torch.int32)
        last, off = ids[-1], positions[b] % bs
        k_bad[last, :, off + 1:] = float("nan")
        v_bad[last, :, off + 1:] = float("nan")
    table = table.to(dev)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(dh)
    out = pa.paged_decode_attention(q, k_bad, v_bad, table, pos, scale)
    ref = pa.paged_decode_attention_reference(q, kp, vp, table, pos, scale)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"kernel read poisoned rows (B={B} h={h} "
                             f"dh={dh} bs={bs} {dtype})")
    return flash_err(torch, out.float(), ref.float())


def verify_case(torch, pa, B, h, dh, bs, mb, W, positions, dtype, seed):
    """K2 vs the plain version on shuffled tables.  Each slot has a budget
    of 1..W valid rows (a slot near the table's end keeps all W: its
    deeper rows see the whole table); block 0, unneeded table entries and
    every row past a slot's last valid position are NaN in the kernel's
    pool.  Returns :func:`flash_err` over the valid rows."""
    dev, L = "cuda", mb * bs
    g = torch.Generator(device=dev).manual_seed(seed)
    budget = [W if p + W > L else 1 + (b * 7 + seed) % W
              for b, p in enumerate(positions)]
    last = [min(p + c - 1, L - 1) for p, c in zip(positions, budget)]
    need = [x // bs + 1 for x in last]
    nb = 1 + sum(need) + 5
    kp = torch.randn((nb, h, bs, dh), generator=g, device=dev).to(dtype)
    vp = torch.randn((nb, h, bs, dh), generator=g, device=dev).to(dtype)
    q = torch.randn((B, W, h, dh), generator=g, device=dev).to(dtype)
    perm = (torch.randperm(nb - 1, generator=g, device=dev) + 1).tolist()
    table = torch.zeros((B, mb), dtype=torch.int32)
    k_bad, v_bad = kp.clone(), vp.clone()
    k_bad[0] = float("nan")
    v_bad[0] = float("nan")
    for b, n in enumerate(need):
        ids, perm = perm[:n], perm[n:]
        table[b, :n] = torch.tensor(ids, dtype=torch.int32)
        off = last[b] % bs
        k_bad[ids[-1], :, off + 1:] = float("nan")
        v_bad[ids[-1], :, off + 1:] = float("nan")
    table = table.to(dev)
    pos0 = torch.tensor(positions, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(dh)
    out = pa.paged_verify_attention(q, k_bad, v_bad, table, pos0, scale)
    ref = pa.paged_verify_attention_reference(q, kp, vp, table, pos0, scale)
    torch.cuda.synchronize()
    valid = (torch.arange(W)[None, :]
             < torch.tensor(budget)[:, None]).to(dev)
    got, want = out[valid].float(), ref[valid].float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"K2 read poisoned rows (B={B} W={W} h={h} "
                             f"dh={dh} bs={bs} {dtype})")
    return flash_err(torch, got, want)


def phase_kernel(torch, pa):
    path_pos = [0, 15, 16, 17, 511, 1023, 700, 250]
    # K1 splits the context into chunks of C rows (C = 64 at these shapes):
    # positions on split edges and the table's last row; then slots whose
    # context fits the first split beside slots that fill every split
    C = pa.decode_split_rows(8, 6, 64 * 16, torch.cuda.get_device_properties(
        0).multi_processor_count)
    cases = [
        ("path", dict(B=8, h=6, dh=128, bs=16, mb=64, positions=path_pos)),
        ("split_edges", dict(B=8, h=6, dh=128, bs=16, mb=64,
                             positions=[C - 1, C, C + 1, 1023, 0,
                                        2 * C - 1, 2 * C, 2 * C + 1])),
        ("first_split_only", dict(B=8, h=6, dh=128, bs=16, mb=64,
                                  positions=[0, 1023, C - 1, 1023, 5, 1023,
                                             C // 2, 1022])),
        ("pangrams", dict(B=4, h=4, dh=16, bs=8, mb=8,
                          positions=[0, 7, 8, 63])),
        ("bs8", dict(B=8, h=6, dh=128, bs=8, mb=128,
                     positions=[0, 7, 8, 9, 511, 1023, 300, 64])),
    ] + [
        # head dims the fast kernel does not take (any-dh kernel): not a
        # multiple of 8 (bf16 rows 24 bytes, not 16-byte aligned), and
        # above 128 (a 256-wide register row)
        (f"dh{dh}", dict(B=8, h=h, dh=dh, bs=16, mb=64, positions=path_pos))
        for dh, h in ANY_DH]
    errs, details = {}, {}
    for name, kw in cases:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            err, detail = kernel_case(torch, pa, dtype=dtype,
                                      seed=len(errs), **kw)
            errs[f"{name}/{dname}"] = err
            details[f"{name}/{dname}"] = detail
            if not err <= PAGED_TOL["K1"][dname]:
                raise AssertionError(f"K1 {name}/{dname}: error {err} > "
                                     f"{PAGED_TOL['K1'][dname]} ({detail})")
    # K2 at the path shapes (one slot within W of the table's end) and
    # the pangrams shapes
    vcases = [
        (f"verify_path_w{W}", dict(B=8, h=6, dh=128, bs=16, mb=64, W=W,
                                   positions=[0, 15, 16, 17, 511,
                                              1024 - W + 1, 700, 250]))
        for W in (2, 5, 17)] + [
        ("verify_pangrams_w5", dict(B=4, h=4, dh=16, bs=8, mb=8, W=5,
                                    positions=[0, 7, 30, 61]))] + [
        (f"verify_dh{dh}_w{W}", dict(B=8, h=h, dh=dh, bs=16, mb=64, W=W,
                                     positions=[0, 15, 16, 17, 511,
                                                1024 - W + 1, 700, 250]))
        for (dh, h), W in zip(ANY_DH, (5, 17, 5))]
    for name, kw in vcases:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            err, detail = verify_case(torch, pa, dtype=dtype,
                                      seed=len(errs), **kw)
            errs[f"{name}/{dname}"] = err
            details[f"{name}/{dname}"] = detail
            if not err <= PAGED_TOL["K2"][dname]:
                raise AssertionError(f"K2 {name}/{dname}: error {err} > "
                                     f"{PAGED_TOL['K2'][dname]} ({detail})")
    errs.update(phase_flash_kernel(torch))
    emit({"phase": "kernel", "error": errs, "paged_tolerance": PAGED_TOL,
          "flash_tolerance": FLASH_TOL, "k1_split_rows": C,
          "paged_detail": details,
          "measure": "max |kernel - plain| / (|plain| + RMS(plain))"})
    return errs


def key_bias(torch, kind, b, h, t, g):
    """A [b*h, t] f32 key bias on the card: None, "random" (normal) or
    "pad" (-1e9 on the last 20% of keys, as a padding mask folds)."""
    if kind is None:
        return None
    if kind == "pad":
        bias = torch.zeros((b * h, t), device="cuda")
        bias[:, int(t * 0.8):] = -1e9
        return bias
    return torch.randn((b * h, t), generator=g, device="cuda")


def flash_case(torch, fa, b, t, h, dh, dtype, causal, bias_kind, single,
               seed):
    """K3 (or K4 with ``single``), K5 and K6 against their plain versions
    on bthd views of a [b, t + 8, 3 h dh] projection whose rows past t
    are NaN (as are dO's), so a finite, matching result proves no kernel
    reads a row at or past t.  Returns {output: (error, detail)}, the
    error as :func:`flash_err` takes it."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    tp = t + 8
    qkv = torch.randn((b, tp, 3 * h * dh), generator=g, device=dev).to(dtype)
    qkv[:, t:] = float("nan")
    dob = torch.randn((b, tp, h, dh), generator=g, device=dev).to(dtype)
    dob[:, t:] = float("nan")
    q, k, v = (z.reshape(b, tp, h, dh)[:, :t]
               for z in qkv.split(h * dh, dim=-1))
    do = dob[:, :t]
    bias = key_bias(torch, bias_kind, b, h, t, g)
    with_bias = bias is not None
    scale = dh ** -0.5
    kw = dict(causal=causal, scale=scale)
    fwd = fa.flash_fwd_single if single else fa.flash_fwd
    o, lse = fwd(q, k, v, bias, **kw)
    bh = fa._to_bh
    delta = fa.row_delta(do, o)
    dk, dv, db = fa.flash_bwd_dkdv(q, k, v, bias, do, lse, delta,
                                   need_dbias=with_bias, **kw)
    dq = fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, **kw)
    ro, rl = fa.flash_fwd_reference(bh(q), bh(k), bh(v), bias, single=single,
                                    **kw)
    rq, rk, rv, rb = fa.flash_bwd_reference(bh(q), bh(k), bh(v), bias,
                                            bh(do), lse, delta, **kw)
    torch.cuda.synchronize()
    got = {"o": bh(o), "lse": lse, "dq": bh(dq), "dk": bh(dk), "dv": bh(dv)}
    want = {"o": ro, "lse": rl, "dq": rq, "dk": rk, "dv": rv}
    if with_bias:
        got["dbias"], want["dbias"] = db, rb
    errs = {}
    for name in got:
        x, r = got[name].float(), want[name].float()
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"flash {name}: non-finite values (a row "
                                 f"past t={t} leaked, or overflow)")
        errs[name] = flash_err(torch, x, r)
    return errs


def flash_err(torch, x, r):
    """(max |x - r| / (|r| + RMS(r)), detail): the error of each element
    relative to its own size, or to the output's RMS where it is near 0;
    the detail gives the max abs error, max |r| and RMS(r)."""
    rms = float(r.square().mean().sqrt())
    diff = (x - r).abs()
    err = float((diff / (r.abs() + rms).clamp_min(1e-30)).max())
    return err, {"max_abs_err": float(diff.max()),
                 "max_abs_plain": float(r.abs().max()), "rms_plain": rms}


# (name, b, t, h, dh, causal, bias, K4): the training path's shapes (t 2048
# on K3, t 512 on K4), ragged t with a key bias (K3 and K4), dh 64,
# BERT-base's attention at max_len 512 (12 heads of 64, not causal, a
# padding bias: -1e9 on the last 20% of keys), the longest t that
# ``_auto_blocks`` sends to K4 (7 key tiles: the ring wraps on an odd
# count) and dh 32, which the wrappers zero-pad to the kernels' 64.  Bias:
# None, "random" (normal) or "pad".
FLASH_CASES = [
    ("path", 8, 2048, 6, 128, True, None, False),
    ("path_k4", 8, 512, 6, 128, True, None, True),
    ("ragged_bias", 2, 1000, 3, 128, False, "random", False),
    ("ragged_causal_bias_dh64_k4", 2, 777, 4, 64, True, "random", True),
    ("ragged_causal_bias_dh64", 2, 777, 4, 64, True, "random", False),
    ("plain_dh64", 2, 256, 2, 64, False, None, False),
    ("bert_k4", 4, 512, 12, 64, False, "pad", True),
    ("k4_t896", 2, 896, 6, 128, True, None, True),
    ("ragged_causal_bias_dh32", 2, 777, 4, 32, True, "random", False),
    ("ragged_bias_dh32_k4", 2, 333, 4, 32, False, "random", True),
    # past dh 128: dh 160 (zero-padded to the 192 build) and 256, on the
    # plain-FMA tiles the bf16 route takes there
    ("ragged_causal_bias_dh160", 2, 777, 3, 160, True, "random", False),
    ("ragged_bias_dh160_k4", 2, 333, 3, 160, False, "random", True),
    ("causal_dh256", 2, 1000, 3, 256, True, None, False),
    ("causal_pad_dh256_k4", 2, 512, 3, 256, True, "pad", True),
]


def phase_flash_kernel(torch):
    """K3-K6 against their plain versions (f32 and bf16) at
    ``FLASH_CASES``; returns {case/dtype/kernel: error}."""
    fa = flash_module()
    kernel_of = {"o": "K3", "lse": "K3", "dq": "K6", "dk": "K5", "dv": "K5",
                 "dbias": "K5"}
    errs, details = {}, {}
    for i, (name, b, t, h, dh, causal, bias, single) in enumerate(
            FLASH_CASES):
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            case = flash_case(torch, fa, b, t, h, dh, dtype, causal, bias,
                              single, seed=100 + i)
            for out, (err, detail) in case.items():
                kern = "K4" if single and kernel_of[out] == "K3" \
                    else kernel_of[out]
                key = f"flash_{name}/{dname}/{kern}/{out}"
                errs[key] = err
                if dh > 128:
                    details[key] = detail
                if not err <= FLASH_TOL[dname]:
                    raise AssertionError(f"{key}: error {err} > "
                                         f"{FLASH_TOL[dname]} ({detail})")
    emit({"phase": "kernel/flash_wide_detail", "detail": details})
    return errs


# -- serving helpers ---------------------------------------------------
def check_streams(torch, gen, pairs, tol):
    """Served vs offline streams; a divergence passes only as a near tie
    (teacher-forced logit margin <= tol at the first divergence)."""
    emb_p, blk_ps, head_p = gen._serving_params()
    ties = []
    for served, ref in pairs:
        if served.shape == ref.shape and (served == ref).all():
            continue
        n = min(len(served), len(ref))
        i = int(next(j for j in range(n) if served[j] != ref[j]))
        ctx = torch.as_tensor(served[None, :i].astype("int64"),
                              device=gen.device)
        logits = gen._prefill_rows(emb_p, blk_ps, head_p, ctx)[0][0]
        margin = float((logits[int(served[i])]
                        - logits[int(ref[i])]).abs())
        if margin > tol:
            raise AssertionError(
                f"served stream diverges from offline generate() at "
                f"{i} with logit margin {margin} > {tol}")
        ties.append({"index": i, "margin": margin})
    return ties


def serve(srv, reqs, timeout=900):
    """Submit (prompt, n_new, sampling) requests; returns outputs, TTFTs
    and wall seconds."""
    t0 = time.perf_counter()
    hs = [srv.submit_async(p, n, sampling=s) for p, n, s in reqs]
    outs = [h.result(timeout) for h in hs]
    return outs, [h.ttft for h in hs], time.perf_counter() - t0


def pangrams_requests(np):
    """Phase 3's request set: one prompt behind a 17-token prefix first,
    then a second behind the same prefix and four others."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 28, 17).astype(np.int32)
    first = np.concatenate([shared, [3, 5]]).astype(np.int32)
    others = [np.concatenate([shared, [9]]).astype(np.int32)] + [
        rng.integers(0, 28, int(t)).astype(np.int32)
        for t in rng.integers(4, 30, 4)]
    return first, others


def serve_after_first(srv, first, others, n_new):
    """Serve ``first`` until it decodes (its prefix is then cached), then
    the rest; returns every output in order."""
    h_first = srv.submit_async(first, n_new)
    deadline = time.monotonic() + 120
    while h_first.emitted == 0 and not h_first.done():
        if time.monotonic() > deadline:
            raise TimeoutError("first request never decoded")
        time.sleep(0.001)
    hs = [srv.submit_async(p, n_new) for p in others]
    return [h_first.result(300)] + [h.result(300) for h in hs]


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(math.ceil(q * len(xs))) - 1)]


# -- phase 3 -----------------------------------------------------------
def phase_pangrams(torch, np, root):
    from deeplearning4j_torch import telemetry
    from deeplearning4j_torch.models.generation import TransformerGenerator
    from deeplearning4j_torch.parallel import GenerationServer
    from deeplearning4j_torch.utils import restore_model

    net = restore_model(os.path.join(
        root, "deeplearning4j_tpu/zoo/weights/Gpt_pangrams-char.zip"),
        device="cuda")
    gen = TransformerGenerator(net, device="cuda")
    hits = telemetry.get_registry().counter("prefix_cache_hits_total")
    first, others = pangrams_requests(np)
    n_new = 24
    h0 = hits.value
    with GenerationServer(net, n_slots=4, block_size=8, tick_batch=8,
                          device="cuda") as srv:
        outs = serve_after_first(srv, first, others, n_new)
    prompts = [first] + others
    refs = [gen.generate(p[None], n_new)[0] for p in prompts]
    ties = check_streams(torch, gen, list(zip(outs, refs)), NEAR_TIE_F32)
    if hits.value - h0 < 1:
        raise AssertionError("pangrams: the shared prefix never hit")
    emit({"phase": "pangrams", "requests": len(prompts),
          "prefix_hits": hits.value - h0, "near_ties": ties})


# -- phase 4 -----------------------------------------------------------
def mixed_requests(np, vocab):
    """Phase 4(b)'s request set: 16 requests, prompts 64-768 tokens, 4 of
    them behind one 256-token system prompt, 64-128 new tokens, every
    other one sampled (temperature 0.8, top-k 40)."""
    rng = np.random.default_rng(2)
    system = rng.integers(0, vocab, 256).astype(np.int32)
    reqs = []
    for i in range(16):
        if i < 4:
            tail = rng.integers(0, vocab, int(rng.integers(16, 200)))
            prompt = np.concatenate([system, tail]).astype(np.int32)
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(64, 769))) \
                .astype(np.int32)
        samp = ({"temperature": 0.8, "top_k": 40, "seed": i}
                if i % 2 else None)
        reqs.append((prompt, int(rng.integers(64, 129)), samp))
    return system, reqs


def path_mid(np):
    """The timing phases' positions: the contexts phase 4(b)'s first 8
    requests decode at, halfway through their budgets."""
    _, reqs = mixed_requests(np, 32000)
    return [len(p) + n // 2 for p, n, _ in reqs[:8]]


def check_finished(reqs, outs, vocab):
    for (p, n, _), out in zip(reqs, outs):
        if out.shape != (len(p) + n,):
            raise AssertionError(f"request did not finish: {out.shape}")
        if not ((out >= 0) & (out < vocab)).all():
            raise AssertionError("token outside the vocabulary")


def phase_full(torch, np, pa):
    from deeplearning4j_torch import telemetry
    from deeplearning4j_torch.models.generation import TransformerGenerator
    from deeplearning4j_torch.parallel import GenerationServer
    from deeplearning4j_torch.zoo import Gpt

    reg = telemetry.get_registry()
    ticks = reg.counter("generation_server_ticks_total")
    hits = reg.counter("prefix_cache_hits_total")
    t_init = time.perf_counter()
    net = Gpt(seed=0).init_graph(device="cuda")
    torch.cuda.synchronize()
    n_layers = len(net.layers) - 2
    vocab = 32000
    kw = dict(n_slots=8, max_len=1024, block_size=16, tick_batch=8,
              device="cuda")
    emit({"phase": "full/init", "params": net.num_params(),
          "layers": n_layers, "seconds": time.perf_counter() - t_init})

    # (a) f32 greedy vs offline generate()
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, vocab, int(t)).astype(np.int32), 32, None)
            for t in rng.integers(64, 769, 8)]
    with GenerationServer(net, compute_dtype=None, **kw) as srv:
        k0, l0 = ticks.value, pa.paged_decode_attention.launches
        outs, _, wall = serve(srv, reqs)
        dt, dl = ticks.value - k0, pa.paged_decode_attention.launches - l0
    if dl < n_layers * dt:
        raise AssertionError(f"f32: {dl} kernel launches < {n_layers} "
                             f"layers x {dt} ticks")
    gen = TransformerGenerator(net, device="cuda")
    refs = [gen.generate(p[None], n)[0] for p, n, _ in reqs]
    ties = check_streams(torch, gen, list(zip(outs, refs)), NEAR_TIE_F32)
    emit({"phase": "full/f32", "requests": len(reqs), "ticks": dt,
          "launches": dl, "near_ties": ties, "seconds": wall})

    # (b) bf16 mixed greedy/sampled, shared system prompt — the main path
    system, reqs = mixed_requests(np, vocab)
    with GenerationServer(net, compute_dtype="bfloat16", **kw) as srv:
        # warm-up off the window; it also seeds the system prompt's
        # blocks into the prefix cache
        srv.submit(np.concatenate([system, [7, 7, 7]]).astype(np.int32), 8)
        torch.cuda.synchronize()
        k0, h0 = ticks.value, hits.value
        pa.paged_decode_attention.launches = 0
        outs, ttfts, wall = serve(srv, reqs)
        launches = pa.paged_decode_attention.launches
        dt, dh = ticks.value - k0, hits.value - h0
    check_finished(reqs, outs, vocab)
    if dh < 1:
        raise AssertionError("bf16: no prefix-cache hit")
    if launches < n_layers * dt:
        raise AssertionError(f"bf16: {launches} kernel launches < "
                             f"{n_layers} layers x {dt} ticks")
    new_tokens = sum(n for _, n, _ in reqs)
    emit({"phase": "full/bf16", "requests": len(reqs),
          "new_tokens": new_tokens, "seconds": wall,
          "new_tokens_per_s": new_tokens / wall,
          "ttft_p50_s": pct(ttfts, 0.50), "ttft_p99_s": pct(ttfts, 0.99),
          "ticks": dt, "ticks_per_s": dt / wall, "launches": launches,
          "prefix_hits": dh})
    return launches


# -- phase 5 -----------------------------------------------------------
def device_events(torch, fn):
    """``fn()`` under a CUDA-only ``torch.profiler`` trace; returns (its
    result, the number of device events — kernels and copies — it
    caused).  Every device event is one launch from the host."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return out, sum(1 for e in prof.events()
                    if getattr(e, "device_type", None) == cuda)


def phase_spec(torch, np, pa, root):
    """(a) pangrams, plain and speculative servers on one request set;
    (b) the full-width speculative main path."""
    from deeplearning4j_torch import telemetry
    from deeplearning4j_torch.models.generation import TransformerGenerator
    from deeplearning4j_torch.parallel import GenerationServer
    from deeplearning4j_torch.utils import restore_model
    from deeplearning4j_torch.zoo import Gpt

    reg = telemetry.get_registry()
    ticks = reg.counter("generation_server_ticks_total")
    hits = reg.counter("prefix_cache_hits_total")
    k1, k2 = pa.paged_decode_attention, pa.paged_verify_attention

    # (a) pangrams: streams vs offline, prefix hit, launches per token
    net = restore_model(os.path.join(
        root, "deeplearning4j_tpu/zoo/weights/Gpt_pangrams-char.zip"),
        device="cuda")
    gen = TransformerGenerator(net, device="cuda")
    n_layers = len(net.layers) - 2
    spec = {"k": 4, "draft_layers": max(1, n_layers // 2)}
    first, others = pangrams_requests(np)
    prompts, n_new = [first] + others, 24
    refs = [gen.generate(p[None], n_new)[0] for p in prompts]
    rows = {}
    for name, extra in (("plain", {}), ("spec", {"speculative": spec})):
        with GenerationServer(net, n_slots=4, block_size=8, tick_batch=8,
                              device="cuda", **extra) as srv:
            srv.submit(np.asarray([1, 2, 3], np.int32), 8)   # warm-up
            torch.cuda.synchronize()
            h0 = hits.value
            k1.launches = k2.launches = 0
            outs, events = device_events(torch, lambda: serve_after_first(
                srv, first, others, n_new))
            st = srv.stats()
            row = {"device_events": events, "k1_launches": k1.launches,
                   "k2_launches": k2.launches,
                   "prefix_hits": hits.value - h0}
        if row["prefix_hits"] < 1:
            raise AssertionError(f"pangrams/{name}: the prefix never hit")
        row["near_ties"] = check_streams(torch, gen, list(zip(outs, refs)),
                                         NEAR_TIE_F32)
        committed = sum(len(o) - len(p) for o, p in zip(outs, prompts))
        row.update(committed=committed,
                   events_per_token=events / committed,
                   k1_per_token=row["k1_launches"] / committed,
                   k2_per_token=row["k2_launches"] / committed,
                   acceptance_rate=st["spec_acceptance_rate"])
        rows[name] = row
    if rows["spec"]["k2_launches"] < 1:
        raise AssertionError("pangrams/spec: K2 never launched")
    emit({"phase": "spec/pangrams", "speculative": spec, **rows})

    # (b) full width, bf16, the 16 mixed requests — the speculative path
    net = Gpt(seed=0).init_graph(device="cuda")
    n_layers = len(net.layers) - 2
    vocab = 32000
    system, reqs = mixed_requests(np, vocab)
    with GenerationServer(net, compute_dtype="bfloat16", n_slots=8,
                          max_len=1024, block_size=16, tick_batch=8,
                          speculative=SPEC_FULL, device="cuda") as srv:
        srv.submit(np.concatenate([system, [7, 7, 7]]).astype(np.int32), 8)
        torch.cuda.synchronize()
        st0 = srv.stats()
        p0, h0 = ticks.value, hits.value
        k1.launches = k2.launches = 0
        outs, ttfts, wall = serve(srv, reqs)
        l1, l2 = k1.launches, k2.launches
        passes, dh = ticks.value - p0, hits.value - h0
        st = srv.stats()
    check_finished(reqs, outs, vocab)
    if not (l2 > 0 and l2 == n_layers * passes):
        raise AssertionError(f"spec: {l2} K2 launches != {n_layers} layers "
                             f"x {passes} verify passes (or none)")
    if l1 < 1:
        raise AssertionError("spec: K1 never launched on the draft steps")
    if dh < 1:
        raise AssertionError("spec: no prefix-cache hit")
    new_tokens = sum(n for _, n, _ in reqs)
    proposed = st["spec_proposed"] - st0["spec_proposed"]
    accepted = st["spec_accepted"] - st0["spec_accepted"]
    emit({"phase": "spec/full", "speculative": SPEC_FULL,
          "requests": len(reqs), "new_tokens": new_tokens, "seconds": wall,
          "new_tokens_per_s": new_tokens / wall,
          "ttft_p50_s": pct(ttfts, 0.50), "ttft_p99_s": pct(ttfts, 0.99),
          "verify_passes": passes, "verify_passes_per_s": passes / wall,
          "proposed": proposed, "accepted": accepted,
          "acceptance_rate": accepted / proposed if proposed else 0.0,
          # each active slot-round commits its anchor plus its accepted
          # proposals
          "committed_per_slot_round": new_tokens / (new_tokens - accepted),
          "k1_launches": l1, "k2_launches": l2,
          "k1_per_token": l1 / new_tokens, "k2_per_token": l2 / new_tokens,
          "prefix_hits": dh, "weights": "random (seeded)"})
    return l2


# -- phase 6: fleet ----------------------------------------------------
# bf16 near-tie rule of the fleet phase: a served greedy stream may leave
# offline generate() (also bf16) only where the offline logits of the two
# tokens lie within this of each other.  bf16 keeps 8 mantissa bits, so
# logits of magnitude 2-4 are spaced 1/64 apart; the served path rounds
# at other points than the offline stripe decode (batched paged kernel,
# chunked prefill on a prefix hit, block handoff, speculative verify), so
# a flip is a tie when the two logits are within 4 such steps.
NEAR_TIE_BF16 = 0.0625
FLEET_SPEC = {"k": 4, "rounds": 2, "draft_layers": 2}


def fleet_counts(reg):
    """The process-wide counters the fleet phase reads as deltas (every
    replica on the card adds to the same ones, so a part counts its own
    run, never a replica)."""
    return {
        "ticks": reg.counter("generation_server_ticks_total").value,
        "affinity": sum(
            c.value for v, c in reg.counter(
                "fleet_replica_dispatch_total",
                labelnames=("replica", "reason"))._items()
            if v[1] == "affinity"),
        "handoff_blocks": reg.counter("kv_handoff_blocks_total").value,
        "handoff_bytes": reg.counter("kv_handoff_bytes_total").value,
        "restarts": reg.counter("serve_watchdog_restarts_total").value,
        "migrated": sum(
            c.value for v, c in reg.counter(
                "fleet_requests_total",
                labelnames=("tenant", "outcome"))._items()
            if v[1] == "migrated"),
    }


def phase_split(reg):
    """{phase: (count, sum seconds)} of fleet_request_phase_seconds."""
    fam = reg.histogram("fleet_request_phase_seconds",
                        labelnames=("phase",))
    out = {}
    for v, c in fam._items():
        _, _, total, count = c.state()
        out[v[0]] = (count, total)
    return out


def fleet_serve(fleet, reqs, timeout=900, kill=None):
    """Submit the (prompt, n_new, sampling) requests across two tenants;
    with ``kill``, kill that replica once any request has emitted a
    token.  Returns outputs, TTFTs, wall seconds and the handles."""
    t0 = time.perf_counter()
    hs = [fleet.submit_async(p, n, tenant=("a", "b")[i % 2], sampling=s)
          for i, (p, n, s) in enumerate(reqs)]
    if kill is not None:
        deadline = time.monotonic() + timeout
        while not any(h.emitted > 0 for h in hs):
            if time.monotonic() > deadline:
                raise AssertionError("fleet: no request started decoding")
            time.sleep(0.001)
        fleet.kill(kill)
    outs = [h.result(timeout) for h in hs]
    return outs, [h.ttft for h in hs], time.perf_counter() - t0, hs


def greedy_pairs(reqs, outs, refs):
    return [(o, refs[i]) for i, ((_, _, s), o) in enumerate(zip(reqs, outs))
            if s is None]


def fleet_tier_roundtrip(np, GenerationServer, net, kw, prompts, n_new):
    """Two prompts through a pool that holds one working set: B's
    admission spills A's leading cached blocks to the host tier, A's
    second admission fetches them back.  Returns (A's exported blocks
    before the spill, after the fetch, A's two outputs, stats)."""
    pa_, pb_ = prompts
    one_request = -(-kw["max_len"] // kw["block_size"])
    with GenerationServer(net, **dict(kw, n_slots=2, kv_blocks=one_request,
                                      host_tier_blocks=4 * one_request)
                          ) as srv:
        out_a1 = srv.submit(pa_, n_new)
        before = srv.export_prefix(pa_)
        srv.submit(pb_, n_new)
        out_a2 = srv.submit(pa_, n_new)
        after = srv.export_prefix(pa_)
        st = srv.stats()
    return before, after, (out_a1, out_a2), st


def fleet_watchdog(GenerationServer, FaultInjector, net, kw, prompt,
                   n_new):
    """A stuck tick (a 6 s stall past a 1 s deadline) recovered by the
    watchdog while a submit with retries is in flight.  Returns (its
    output, stats)."""
    with GenerationServer(net, **dict(kw, n_slots=2, tick_batch=1,
                                      tick_timeout_s=1.0,
                                      submit_retries=4,
                                      retry_backoff_s=0.02)) as srv:
        srv.submit(prompt, 4)                       # warm-up
        with FaultInjector(["serve_tick_stall@0:6.0"]):
            out = srv.submit(prompt, n_new, timeout=900)
        st = srv.stats()
    return out, st


def phase_fleet(torch, np, pa):
    """ServingFleet on the card: default-width zoo.Gpt() in bf16, seeded
    weights, replicas of n_slots 8, max_len 1024, block 16, tick_batch 8.
    (a) two unified replicas serve phase 4(b)'s 16 mixed requests across
    two tenants (the shared system prompt routes by affinity; K1 counted
    from a reset); (b) the same requests with one replica killed
    mid-flight; (c) roles ("prefill", "decode") with prefill_threshold
    256, both replicas speculative (k 4, 2 rounds, a 2-layer self-draft):
    long prompts hand their blocks off, the decode replica verifies on K2
    (counted from a reset), the prefill replica claims no draft blocks;
    (d) a host-tier spill -> fetch round trip, byte for byte, and a stuck
    tick recovered by the watchdog under a submit with retries.  Greedy
    streams are held to offline generate() (bf16) by the near-tie rule."""
    from deeplearning4j_torch.zoo import Gpt

    net = Gpt(seed=0).init_graph(device="cuda")
    vocab = 32000
    kw = dict(compute_dtype="bfloat16", n_slots=8, max_len=1024,
              block_size=16, tick_batch=8, device="cuda")
    system, reqs = mixed_requests(np, vocab)
    return fleet_parts(torch, np, pa, net, kw, system, reqs, vocab,
                       card_line())


def fleet_parts(torch, np, pa, net, kw, system, reqs, vocab, card):
    """Parts (a)-(d) of :func:`phase_fleet` on a built net (replica
    config ``kw``), phase 4(b)'s requests and the system prompt.  Prompts
    of 16 blocks or more (256 tokens at block 16) stage through the
    prefill replica in (c); (d)'s prompts fill 60% of a slot."""
    prefill_threshold = 16 * kw["block_size"]
    tier_prompt = kw["max_len"] * 3 // 5
    from deeplearning4j_torch import telemetry
    from deeplearning4j_torch.models.generation import TransformerGenerator
    from deeplearning4j_torch.parallel import GenerationServer
    from deeplearning4j_torch.resilience import FaultInjector
    from deeplearning4j_torch.serving import ServingFleet

    reg = telemetry.get_registry()
    k1, k2 = pa.paged_decode_attention, pa.paged_verify_attention
    n_layers = len(net.layers) - 2
    gen = TransformerGenerator(net, compute_dtype=kw["compute_dtype"],
                               device=kw["device"])
    refs = {i: gen.generate(p[None], n)[0]
            for i, (p, n, s) in enumerate(reqs) if s is None}
    new_tokens = sum(n for _, n, _ in reqs)
    warm = np.concatenate([system, [7, 7, 7]]).astype(np.int32)

    # (a) two unified replicas
    with ServingFleet(net, n_replicas=2, **kw) as fleet:
        fleet.submit(warm, 8, timeout=900)        # seeds the system prompt
        c0, ph0 = fleet_counts(reg), phase_split(reg)
        k1.launches = 0
        outs, ttfts, wall, hs = fleet_serve(fleet, reqs)
        launches = k1.launches
        c1, ph1 = fleet_counts(reg), phase_split(reg)
        replicas = sorted({h.replica for h in hs})
    check_finished(reqs, outs, vocab)
    ties_a = check_streams(torch, gen, greedy_pairs(reqs, outs, refs),
                           NEAR_TIE_BF16)
    ticks = c1["ticks"] - c0["ticks"]
    if c1["affinity"] - c0["affinity"] < 1:
        raise AssertionError("fleet (a): no affinity dispatch")
    if launches < n_layers * ticks:
        raise AssertionError(f"fleet (a): {launches} K1 launches < "
                             f"{n_layers} layers x {ticks} ticks")
    split = {ph: {"count": ph1[ph][0] - ph0.get(ph, (0, 0))[0],
                  "mean_s": ((ph1[ph][1] - ph0.get(ph, (0, 0))[1])
                             / max(1, ph1[ph][0] - ph0.get(ph, (0, 0))[0]))}
             for ph in ph1}
    emit({"phase": "fleet/unified", "replicas": 2, "requests": len(reqs),
          "new_tokens": new_tokens, "seconds": wall,
          "new_tokens_per_s": new_tokens / wall,
          "ttft_p50_s": pct(ttfts, 0.50), "ttft_p99_s": pct(ttfts, 0.99),
          "request_phase_seconds": split, "ticks": ticks,
          "k1_launches": launches,
          "affinity_dispatches": c1["affinity"] - c0["affinity"],
          "replicas_used": replicas, "near_ties": ties_a, "card": card})

    # (b) kill one replica mid-flight
    with ServingFleet(net, n_replicas=2, **kw) as fleet:
        fleet.submit(warm, 8, timeout=900)
        c0 = fleet_counts(reg)
        outs, _, wall, hs = fleet_serve(fleet, reqs, kill=0)
        c1 = fleet_counts(reg)
        healthy = fleet.stats()["healthy_replicas"]
    check_finished(reqs, outs, vocab)
    ties_b = check_streams(torch, gen, greedy_pairs(reqs, outs, refs),
                           NEAR_TIE_BF16)
    if healthy != 1:
        raise AssertionError(f"fleet (b): {healthy} healthy replicas")
    emit({"phase": "fleet/kill", "seconds": wall,
          "migrated": c1["migrated"] - c0["migrated"],
          "migrations": sum(h.migrations for h in hs),
          "near_ties": ties_b, "card": card})

    # (c) disaggregated prefill/decode, speculative replicas
    with ServingFleet(net, n_replicas=2, roles=("prefill", "decode"),
                      prefill_threshold=prefill_threshold,
                      speculative=FLEET_SPEC,
                      **kw) as fleet:
        fleet.submit(warm, 8, timeout=900)
        c0 = fleet_counts(reg)
        k1.launches = k2.launches = 0
        outs, ttfts, wall, hs = fleet_serve(fleet, reqs)
        l1, l2 = k1.launches, k2.launches
        c1 = fleet_counts(reg)
        pre, dec = fleet.replica(0), fleet.replica(1)
        with pre._lock:
            pre_draft = len(pre._draft_cached) + len(pre._dprefix_map)
        st_pre, st_dec = pre.stats(), dec.stats()
        staged = [h for h in hs if h.prefill_replica == 0]
        # the handed-off blocks, as both replicas hold them now: the
        # decode replica's must be the prefill replica's bytes (blocks
        # either side evicted since are left out)
        same = 0
        for h in staged:
            a, b = pre.export_prefix(h.prompt), dec.export_prefix(h.prompt)
            for (ha, _, ka, va), (hb, _, kb, vb) in zip(a, b):
                if ha != hb or not (np.array_equal(ka, kb)
                                    and np.array_equal(va, vb)):
                    raise AssertionError("fleet (c): a handed-off block's "
                                         "bytes differ between replicas")
                same += 1
    check_finished(reqs, outs, vocab)
    ties_c = check_streams(torch, gen, greedy_pairs(reqs, outs, refs),
                           NEAR_TIE_BF16)
    passes = c1["ticks"] - c0["ticks"]
    handoff = c1["handoff_blocks"] - c0["handoff_blocks"]
    if handoff < 1 or not staged or same < 1 \
            or st_dec["tier_fetches"] < 1:
        raise AssertionError(f"fleet (c): no block handoff ({handoff} "
                             f"blocks, {len(staged)} staged requests, "
                             f"{same} compared)")
    if pre_draft or st_pre["spec_proposed"]:
        raise AssertionError("fleet (c): the prefill replica claimed draft "
                             "blocks or speculated")
    if not (l2 > 0 and l2 == n_layers * passes):
        raise AssertionError(f"fleet (c): {l2} K2 launches != {n_layers} "
                             f"layers x {passes} verify passes (or none)")
    emit({"phase": "fleet/disagg", "speculative": FLEET_SPEC,
          "prefill_threshold": prefill_threshold, "seconds": wall,
          "new_tokens_per_s": new_tokens / wall,
          "ttft_p50_s": pct(ttfts, 0.50), "ttft_p99_s": pct(ttfts, 0.99),
          "staged_requests": len(staged), "handoff_blocks": handoff,
          "handoff_blocks_byte_equal": same,
          "handoff_bytes": c1["handoff_bytes"] - c0["handoff_bytes"],
          "decode_tier_fetches": st_dec["tier_fetches"],
          "verify_passes": passes, "k1_launches": l1, "k2_launches": l2,
          "acceptance_rate": st_dec["spec_acceptance_rate"],
          "near_ties": ties_c, "card": card})

    # (d) host tier round trip and the watchdog
    rng = np.random.default_rng(7)
    pair = [rng.integers(0, vocab, tier_prompt).astype(np.int32)
            for _ in range(2)]
    n_new = max(2, kw["max_len"] // 32)
    before, after, (a1, a2), st = fleet_tier_roundtrip(
        np, GenerationServer, net, kw, pair, n_new)
    if not (st["tier_spills"] >= 1 and st["tier_fetches"] >= 1
            and len(before) == len(after)
            == (tier_prompt - 1) // kw["block_size"]):
        raise AssertionError(f"fleet (d): no spill/fetch round trip "
                             f"({st['tier_spills']}, {st['tier_fetches']}, "
                             f"{len(before)}, {len(after)})")
    for (h0, _, k0, v0), (h1, _, k1_, v1) in zip(before, after):
        if h0 != h1 or not (np.array_equal(k0, k1_)
                            and np.array_equal(v0, v1)):
            raise AssertionError("fleet (d): a fetched block's bytes "
                                 "differ from the spilled block's")
    ref_a = gen.generate(pair[0][None], n_new)[0]
    ties_t = check_streams(torch, gen, [(a1, ref_a), (a2, ref_a)],
                           NEAR_TIE_BF16)
    c0 = fleet_counts(reg)
    short = pair[0][:tier_prompt // 6]
    out, st_w = fleet_watchdog(GenerationServer, FaultInjector, net, kw,
                               short, n_new)
    restarts = fleet_counts(reg)["restarts"] - c0["restarts"]
    ref_w = gen.generate(short[None], n_new)[0]
    ties_d = check_streams(torch, gen, [(out, ref_w)], NEAR_TIE_BF16)
    if restarts < 1 or not st_w["healthy"]:
        raise AssertionError(f"fleet (d): the watchdog did not recover "
                             f"({restarts} restarts)")
    emit({"phase": "fleet/tier_watchdog",
          "tier_spills": st["tier_spills"],
          "tier_fetches": st["tier_fetches"],
          "blocks_byte_equal": len(before), "watchdog_restarts": restarts,
          "near_ties": ties_t + ties_d, "card": card})
    return {"k1": launches, "k2": l2}


# -- phase 7 -----------------------------------------------------------
FLASH_WRAPPERS = ("flash_fwd", "flash_fwd_single", "flash_bwd_dkdv",
                  "flash_bwd_dq")
TRAIN_STEPS = 5


def flash_module():
    import importlib
    return importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")


def train_batch(np, b, t, vocab, seed):
    """Seeded token ids and their next-token labels (the last wraps)."""
    x = np.random.default_rng(seed).integers(0, vocab, (b, t)) \
        .astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def train_window(torch, np, fa, net, b, t, seed, steps=TRAIN_STEPS):
    """One warm-up ``fit`` step, then ``steps`` more on the same batch with
    every flash launch count set to 0 just before and read just after
    (the main path).  Returns (losses, wall seconds, counts, peak bytes,
    the long-t fallback count of the window)."""
    from deeplearning4j_torch.data import DataSet
    ds = DataSet(*train_batch(np, b, t, 32000, seed))
    net.fit(ds)
    torch.cuda.synchronize()
    fallback0 = fa._ROUTE_XLA_LONG_T.value
    for name in FLASH_WRAPPERS:
        getattr(fa, name).launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [net.fit(ds) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: getattr(fa, name).launches for name in FLASH_WRAPPERS}
    return (losses, wall, counts, torch.cuda.max_memory_allocated(),
            fa._ROUTE_XLA_LONG_T.value - fallback0)


def step_profile(torch, np, net, b, t, seed):
    """One bf16 ``fit`` step under a CUDA-only ``torch.profiler`` trace:
    device time by kernel (top 12) and the device-busy total."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_torch.data import DataSet
    ds = DataSet(*train_batch(np, b, t, 32000, seed))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, busy_us, n = {}, 0.0, 0
    for evt in prof.events():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        busy_us += us
        n += 1
        kernels[evt.name[:80]] = kernels.get(evt.name[:80], 0.0) + us
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"profiled_wall_ms": wall * 1e3, "device_ms": busy_us / 1e3,
            "device_events": n,
            "top_device_ms": [{"name": k, "ms": v / 1e3} for k, v in top]}


def phase_train(torch, np):
    """(a) full-width Gpt() in f32, b 2, t 1024: one loss and gradient
    with use_flash=True against use_flash=False on the same params;
    (b) the main path: full-width Gpt() in bf16 (f32 master weights,
    Adam(3e-4)), b 8, t 2048, ``TRAIN_STEPS`` fit steps on one seeded
    batch — loss finite and falling, K3/K5/K6 launched 12 x steps, no
    long-t fallback — one profiled step, and the same steps from the same
    init with use_flash=False (loss curves within 1e-3, no flash launch);
    (c) the same at t 512, where the forward is K4.  Returns the launch
    counts of (b) and (c)."""
    from deeplearning4j_torch.data import DataSet
    from deeplearning4j_torch.utils.trees import iter_leaves
    from deeplearning4j_torch.zoo import Gpt
    fa = flash_module()

    # (a) f32 parity of the two attention paths inside the whole model
    t0 = time.perf_counter()
    nets = [Gpt(seed=0, seq_len=1024, compute_dtype=None,
                use_flash=f).init_graph(device="cuda") for f in (True, False)]
    nets[1].params_tree = nets[0].params_tree
    batch = DataSet(*train_batch(np, 2, 1024, 32000, 1))
    res = []
    for net in nets:
        net._build_solver()
        loss, _, grads = net._solver._loss_and_grads(
            net.params_tree, net.state_tree, net._batch_dict(batch), None)
        res.append((float(loss), dict(iter_leaves(grads))))
    torch.cuda.synchronize()
    loss_err = abs(res[0][0] - res[1][0]) / abs(res[1][0])
    grad_err = max(float((g - res[1][1][p]).abs().max())
                   / max(float(res[1][1][p].abs().max()), 1e-30)
                   for p, g in res[0][1].items())
    if not (loss_err <= 1e-3 and grad_err <= 1e-3):
        raise AssertionError(f"train/f32: flash vs plain loss error "
                             f"{loss_err}, gradient error {grad_err} > 1e-3")
    emit({"phase": "train/f32", "b": 2, "t": 1024, "loss_flash": res[0][0],
          "loss_plain": res[1][0], "loss_rel_err": loss_err,
          "grad_rel_err": grad_err,
          "grad_error": "max over leaves of max |flash - plain| / "
                        "max |plain|", "seconds": time.perf_counter() - t0})
    del nets, res, grads
    torch.cuda.empty_cache()

    # (b) the main path: bf16, b 8, t 2048
    counts = {}
    for t, name in ((2048, "train/bf16"), (512, "train/bf16_t512")):
        b = 8
        net = Gpt(seed=0, seq_len=t).init_graph(device="cuda")
        n_layers = len(net.layers) - 2
        losses, wall, cnt, peak, fallbacks = train_window(
            torch, np, fa, net, b, t, seed=2)
        fwd = "flash_fwd" if t == 2048 else "flash_fwd_single"
        want = {name_: (n_layers * TRAIN_STEPS
                        if name_ in (fwd, "flash_bwd_dkdv", "flash_bwd_dq")
                        else 0) for name_ in FLASH_WRAPPERS}
        if cnt != want:
            raise AssertionError(f"{name}: launches {cnt} != {want}")
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"{name}: losses {losses} not finite and "
                                 "falling")
        if fallbacks:
            raise AssertionError(f"{name}: {fallbacks} long-t fallbacks")
        row = {"phase": name, "b": b, "t": t, "steps": TRAIN_STEPS,
               "losses": losses, "seconds": wall,
               "step_ms": wall * 1e3 / TRAIN_STEPS,
               "tokens_per_s": TRAIN_STEPS * b * t / wall,
               "peak_allocated_bytes": peak, "launches": cnt,
               "flash_fallback_above_threshold": fallbacks,
               "weights": "random (seeded)", "card": card_line()}
        row["profile"] = step_profile(torch, np, net, b, t, seed=2)
        counts[t] = cnt
        del net
        torch.cuda.empty_cache()
        if t == 2048:
            # the same seeded init and batch on plain attention: the two
            # loss curves agree to bf16 rounding, and no flash kernel runs
            net = Gpt(seed=0, seq_len=t, use_flash=False).init_graph(
                device="cuda")
            p_losses, p_wall, p_cnt, p_peak, _ = train_window(
                torch, np, fa, net, b, t, seed=2)
            curve_err = max(abs(a - c) / abs(c)
                            for a, c in zip(losses, p_losses))
            if curve_err > 1e-3 or any(p_cnt.values()):
                raise AssertionError(f"{name}: plain-attention losses "
                                     f"{p_losses} vs flash {losses} (max "
                                     f"rel {curve_err}), launches {p_cnt}")
            row["plain_attention"] = {
                "losses": p_losses, "loss_curve_max_rel_diff": curve_err,
                "step_ms": p_wall * 1e3 / TRAIN_STEPS,
                "peak_allocated_bytes": p_peak}
            del net
            torch.cuda.empty_cache()
        emit(row)
    return counts


# -- phase 8 -----------------------------------------------------------
def time_ms(torch, fn, n_inner=24, reps=9, stream=None, spread=False):
    """Median device milliseconds per call of ``fn(i)``.  The calls are
    captured once in a CUDA graph and the graph is replayed between two
    events, so the time is the card's, not the Python launch rate (a
    plain loop of launches would measure the host: each wrapper call
    costs more host time than the kernel runs).  ``stream``: the side
    stream to warm up and capture on (default a new one); ``spread``:
    return (median, the sorted per-replay times)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm up off the capture
        for i in range(n_inner):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(n_inner):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n_inner)
    times.sort()
    median = times[len(times) // 2]
    return (median, times) if spread else median


def sdpa_bwd_ms(torch, F, sets, scale, n_sets):
    """SDPA's backward alone (dq, dk and dv together), timed as the
    kernels are, by CUDA-graph replay over the rotating input sets
    ``sets`` ((q, k, v, dO) in [b, h, t, dh]): the forwards are recorded
    beforehand on the capture stream, since autograd runs each backward
    op on its forward's stream, and ``torch.autograd.grad`` is captured.
    Returns (median, sorted per-replay times)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        grad_in = [tuple(x.detach().requires_grad_(True) for x in z[:3])
                   for z in sets]
        outs = [F.scaled_dot_product_attention(*z, is_causal=True,
                                               scale=scale)
                for z in grad_in]
    torch.cuda.current_stream().wait_stream(side)
    return time_ms(torch, lambda i: torch.autograd.grad(
        outs[i % n_sets], grad_in[i % n_sets], sets[i % n_sets][3],
        retain_graph=True), stream=side, spread=True)


def flash_bound(n_products, b, t, h, dh, n_tensors, n_stats, causal=True):
    """(bound ms, 'bytes' | 'operations', flops, bytes): the larger of
    the flops over the bf16 tensor-core peak and the bytes over HBM
    bandwidth.  Flops: 2 dh per (query, key) pair per product over the
    pairs the causal mask leaves; bytes: ``n_tensors`` [b, t, h, dh] bf16
    operands and ``n_stats`` [b*h, t] f32 stats, each read or written
    once."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 2 * dh * n_products * pairs * b * h
    n_bytes = n_tensors * b * t * h * dh * 2 + n_stats * b * h * t * 4
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, n_bytes)


def phase_timings_flash(torch, h=6, dh=128, phase="timings/flash"):
    """K3, K5 and K6 at the training path's shapes (bf16, b 8, t 2048,
    ``h`` heads of ``dh`` (6 of 128), causal, bthd views of a [b, t, 3d]
    projection) and K4 at t 512, against their plain versions; yardsticks: one
    ``F.scaled_dot_product_attention(is_causal=True)`` call (forward) and
    its backward through autograd alone (dq, dk and dv together, on a
    forward recorded beforehand).  The port never calls SDPA.  Kernels,
    plain versions and both SDPA yardsticks are timed by CUDA-graph replay
    over 4 input sets in rotation (~300 MB, beyond the 50 MB L2); SDPA's
    backward with the spread of its 9 replays."""
    import torch.nn.functional as F
    fa = flash_module()
    dev, dt, NB, b = "cuda", torch.bfloat16, 4, 8
    scale = dh ** -0.5
    g = torch.Generator(device=dev).manual_seed(9)
    bh = fa._to_bh
    rows = {}
    for t in (2048, 512):
        sets = []
        for _ in range(NB):
            qkv = torch.randn((b, t, 3 * h * dh), generator=g,
                              device=dev).to(dt)
            q, k, v = (z.reshape(b, t, h, dh)
                       for z in qkv.split(h * dh, dim=-1))
            do = torch.randn((b, t, h, dh), generator=g, device=dev).to(dt)
            sets.append((qkv, q, k, v, do))
        single = t == 512
        fwd = fa.flash_fwd_single if single else fa.flash_fwd
        outs = [fwd(q, k, v, None, causal=True, scale=scale)
                for _, q, k, v, _ in sets]
        deltas = [fa.row_delta(s[4], o) for s, (o, _) in zip(sets, outs)]
        plain_in = [tuple(bh(x) for x in s[1:]) for s in sets]
        sdpa_in = [tuple(x.transpose(1, 2).contiguous() for x in s[1:])
                   for s in sets]
        kern = {
            "fwd": lambda i: fwd(*sets[i % NB][1:4], None, causal=True,
                                 scale=scale),
            "dkdv": lambda i: fa.flash_bwd_dkdv(
                *sets[i % NB][1:4], None, sets[i % NB][4],
                outs[i % NB][1], deltas[i % NB], causal=True, scale=scale),
            "dq": lambda i: fa.flash_bwd_dq(
                *sets[i % NB][1:4], None, sets[i % NB][4], outs[i % NB][1],
                deltas[i % NB], causal=True, scale=scale)}
        plain = {
            "fwd": lambda i: fa.flash_fwd_reference(
                *plain_in[i % NB][:3], None, causal=True, scale=scale,
                single=single),
            "bwd": lambda i: fa.flash_bwd_reference(
                *plain_in[i % NB][:3], None, plain_in[i % NB][3],
                outs[i % NB][1], deltas[i % NB], causal=True, scale=scale)}
        # errors of this run at these shapes (absolute, bf16)
        ro, _ = plain["fwd"](0)
        rq, rk, rv, _ = plain["bwd"](0)
        dk, dv, _ = kern["dkdv"](0)
        errs = {"fwd": float((bh(outs[0][0]).float() - ro.float())
                             .abs().max()),
                "dkdv": max(float((bh(dk).float() - rk.float()).abs().max()),
                            float((bh(dv).float() - rv.float()).abs().max())),
                "dq": float((bh(kern["dq"](0)).float() - rq.float())
                            .abs().max())}
        del ro, rq, rk, rv, dk, dv
        ms = {f"kernel_{n}": time_ms(torch, fn) for n, fn in kern.items()}
        ms.update({f"plain_{n}": time_ms(torch, fn, n_inner=8, reps=5)
                   for n, fn in plain.items()})
        ms["kernel_fwd_again"] = time_ms(torch, kern["fwd"])
        lib_fwd = time_ms(torch, lambda i: F.scaled_dot_product_attention(
            *sdpa_in[i % NB][:3], is_causal=True, scale=scale))
        lib_bwd, lib_bwd_reps = sdpa_bwd_ms(torch, F, sdpa_in, scale, NB)
        names = ({"fwd": "flash_fwd_single"} if single else
                 {"fwd": "flash_fwd", "dkdv": "flash_bwd_dkdv",
                  "dq": "flash_bwd_dq"})
        # (products, [b, t, h, dh] operands, f32 stats): fwd q k v -> O,
        # LSE; dkdv q k v dO -> dK dV, reading LSE and delta; dq likewise
        # -> dQ
        spec = {"fwd": (2, 4, 1), "dkdv": (4, 6, 2), "dq": (3, 5, 2)}
        for part, name in names.items():
            bound, by, flops, n_bytes = flash_bound(
                spec[part][0], b, t, h, dh, *spec[part][1:])
            rows[name] = {
                "kernel_ms": ms[f"kernel_{part}"],
                "plain_ms": ms["plain_fwd" if part == "fwd" else
                               "plain_bwd"],
                "library_ms": lib_fwd if part == "fwd" else lib_bwd,
                # K5 and K6 are held against one plain call and one SDPA
                # backward that each compute every gradient at once
                "plain_scope": "kernel" if part == "fwd" else "bwd_all",
                "library_scope": "kernel" if part == "fwd" else "bwd_all",
                "bound_ms": bound, "bound_by": by, "flops": flops,
                "bytes": n_bytes, "max_abs_err": errs[part],
                "shapes": {"b": b, "t": t, "h": h, "dh": dh,
                           "dtype": "bfloat16", "causal": True}}
        rows[names["fwd"]]["kernel_ms_again"] = ms["kernel_fwd_again"]
        if not single:
            for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
                rows[name]["library_reps_ms"] = lib_bwd_reps
        del sets, outs, deltas, plain_in, sdpa_in
        torch.cuda.empty_cache()
    emit({"phase": phase, "kernels": rows,
          "plain_bwd_note": "flash_bwd_reference computes dq, dk, dv and "
                            "dbias at once; its time stands for K5 and K6",
          "library_bwd_note": "SDPA backward alone through autograd (dq, "
                              "dk, dv together) on forwards recorded "
                              "beforehand, by CUDA-graph replay over the "
                              "rotating sets; median of 9 replays, all 9 "
                              "in library_reps_ms",
          "card": card_line()})
    return rows


def phase_timings(torch, pa, positions, h=6, dh=128, phase="timings"):
    """Median per-call times at the path shapes (bf16, 8 slots, ``h``
    heads of ``dh`` (6 of 128), block 16, 64-entry tables).  Calls cycle
    over 12 layers' pools (~300 MB), as one decode tick does, so the
    50 MB L2 cannot hold the working set."""
    import torch.nn.functional as F
    dev, dtype = "cuda", torch.bfloat16
    B, bs, mb, NL = 8, 16, 64, 12
    g = torch.Generator(device=dev).manual_seed(5)
    nb = 1 + B * mb
    kp = torch.randn((NL, nb, h, bs, dh), generator=g, device=dev).to(dtype)
    vp = torch.randn((NL, nb, h, bs, dh), generator=g, device=dev).to(dtype)
    q = torch.randn((B, h, dh), generator=g, device=dev).to(dtype)
    table = (torch.randperm(nb - 1, generator=g, device=dev)[:B * mb]
             .reshape(B, mb) + 1).to(torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(dh)
    kern = lambda i: pa.paged_decode_attention(q, kp[i % NL], vp[i % NL],
                                               table, pos, scale)
    plain = lambda i: pa.paged_decode_attention_reference(
        q, kp[i % NL], vp[i % NL], table, pos, scale)
    # yardstick: one SDPA call over the ALREADY-GATHERED contiguous K/V
    # (the gather is excluded); the port never calls it
    kl = [pa.paged_gather(kp[i], table) for i in range(NL)]
    vl = [pa.paged_gather(vp[i], table) for i in range(NL)]
    mask = (torch.arange(mb * bs, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = lambda i: F.scaled_dot_product_attention(
        q4, kl[i % NL], vl[i % NL], attn_mask=mask, scale=scale)
    err = float((kern(0).float() - plain(0).float()).abs().max())
    ms = {name: time_ms(torch, fn) for name, fn in
          (("kernel", kern), ("plain", plain), ("library", lib),
           ("kernel_again", kern))}
    ctx = sum(p + 1 for p in positions)
    esz = 2
    n_bytes = (ctx * h * dh * 2 * esz              # K and V rows read
               + 2 * B * h * dh * esz              # q read, out written
               + sum(p // bs + 1 for p in positions) * 4 + B * 4)
    n_flops = 4 * ctx * h * dh
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_BF16_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    out = {"phase": phase, "shapes": {"B": B, "h": h, "dh": dh,
                                          "bs": bs, "max_blocks": mb,
                                          "dtype": "bfloat16",
                                          "pos": positions},
           "kernel_ms": ms["kernel"], "kernel_ms_again": ms["kernel_again"],
           "plain_ms": ms["plain"], "library_ms": ms["library"],
           "bound_ms": bound, "bound_by": ("bytes" if t_bytes >= t_ops
                                           else "operations"),
           "bytes": n_bytes, "flops": n_flops, "max_abs_err": err,
           "card": card_line()}
    emit(out)
    return out


def phase_timings_verify(torch, pa, positions, W=5, h=6, dh=128,
                         phase="timings/verify"):
    """K2 at the path shapes with W = 5 (k = 4): bf16, 8 slots, ``h``
    heads of ``dh`` (6 of 128), block 16, 64-entry tables, chunks
    starting at ``positions``; 12 layers' pools in rotation as for K1.
    The yardstick is one SDPA call over K/V gathered beforehand with a
    [B, 1, W, L] causal mask."""
    import torch.nn.functional as F
    dev, dtype = "cuda", torch.bfloat16
    B, bs, mb, NL = 8, 16, 64, 12
    L = mb * bs
    g = torch.Generator(device=dev).manual_seed(6)
    nb = 1 + B * mb
    kp = torch.randn((NL, nb, h, bs, dh), generator=g, device=dev).to(dtype)
    vp = torch.randn((NL, nb, h, bs, dh), generator=g, device=dev).to(dtype)
    q = torch.randn((B, W, h, dh), generator=g, device=dev).to(dtype)
    table = (torch.randperm(nb - 1, generator=g, device=dev)[:B * mb]
             .reshape(B, mb) + 1).to(torch.int32)
    pos0 = torch.tensor(positions, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(dh)
    kern = lambda i: pa.paged_verify_attention(q, kp[i % NL], vp[i % NL],
                                               table, pos0, scale)
    plain = lambda i: pa.paged_verify_attention_reference(
        q, kp[i % NL], vp[i % NL], table, pos0, scale)
    kl = [pa.paged_gather(kp[i], table) for i in range(NL)]
    vl = [pa.paged_gather(vp[i], table) for i in range(NL)]
    rows = pos0.long()[:, None] + torch.arange(W, device=dev)[None, :]
    mask = (torch.arange(L, device=dev)[None, None, :]
            <= rows[:, :, None])[:, None]                 # [B, 1, W, L]
    qh = q.transpose(1, 2).contiguous()                   # [B, h, W, dh]
    lib = lambda i: F.scaled_dot_product_attention(
        qh, kl[i % NL], vl[i % NL], attn_mask=mask, scale=scale)
    err = float((kern(0).float() - plain(0).float()).abs().max())
    ms = {name: time_ms(torch, fn) for name, fn in
          (("kernel", kern), ("plain", plain), ("library", lib),
           ("kernel_again", kern))}
    ctx = [min(p + W, L) for p in positions]     # K/V rows the call reads
    keys = sum(min(p + w + 1, L) for p in positions for w in range(W))
    esz = 2
    n_bytes = (sum(ctx) * h * dh * 2 * esz        # K and V rows read
               + 2 * B * W * h * dh * esz         # q read, out written
               + sum((c - 1) // bs + 1 for c in ctx) * 4 + B * 4)
    n_flops = 4 * keys * h * dh
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_BF16_FLOPS * 1e3
    out = {"phase": phase,
           "shapes": {"B": B, "W": W, "h": h, "dh": dh, "bs": bs,
                      "max_blocks": mb, "dtype": "bfloat16",
                      "pos0": positions},
           "kernel_ms": ms["kernel"], "kernel_ms_again": ms["kernel_again"],
           "plain_ms": ms["plain"], "library_ms": ms["library"],
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": n_bytes, "flops": n_flops, "max_abs_err": err,
           "card": card_line()}
    emit(out)
    return out


# -- extra phases: k2, k3, k4, k5, k6 ----------------------------------
# (kernel, shape name, b, t, h, dh, causal, bias kind): the training
# path's shapes, and K4 at BERT-base's attention too
SOLO_SHAPES = {
    "k3": [("flash_fwd", "path", 8, 2048, 6, 128, True, None)],
    "k4": [("flash_fwd_single", "path_k4", 8, 512, 6, 128, True, None),
           ("flash_fwd_single", "bert_k4", 4, 512, 12, 64, False, "pad")],
    "k5": [("flash_bwd_dkdv", "path", 8, 2048, 6, 128, True, None)],
    "k6": [("flash_bwd_dq", "path", 8, 2048, 6, 128, True, None)],
}
BWD_WRAPPERS = ("flash_bwd_dkdv", "flash_bwd_dq")


def phase_solo(torch, which):
    """One kernel alone (``which`` in SOLO_SHAPES), bf16 on bthd views of
    a [b, t, 3d] projection, timed as ``timings`` times it (graph replay
    over 4 input sets), three times — for quick comparisons of kernel
    versions in turns.  A forward also gets one SDPA call on the same
    inputs (its padding bias as a boolean key mask), K6 SDPA's backward
    alone (every gradient at once, no bias)."""
    import torch.nn.functional as F
    fa = flash_module()
    g = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for name, shape, b, t, h, dh, causal, bias_kind in SOLO_SHAPES[which]:
        sets = []
        for _ in range(4):
            qkv = torch.randn((b, t, 3 * h * dh), generator=g,
                              device="cuda").to(torch.bfloat16)
            q, k, v = (z.reshape(b, t, h, dh)
                       for z in qkv.split(h * dh, dim=-1))
            do = torch.randn((b, t, h, dh), generator=g,
                             device="cuda").to(torch.bfloat16)
            sets.append((q, k, v, do))
        bias = key_bias(torch, bias_kind, b, h, t, g)
        kw = dict(causal=causal, scale=dh ** -0.5)
        fwd = (fa.flash_fwd_single if name == "flash_fwd_single"
               else fa.flash_fwd)
        outs = [fwd(q, k, v, bias, **kw) for q, k, v, _ in sets]
        sdpa = [tuple(x.transpose(1, 2).contiguous() for x in z)
                for z in sets]
        if name == "flash_bwd_dkdv":
            deltas = [fa.row_delta(z[3], o) for z, (o, _) in zip(sets, outs)]
            fn = lambda i: fa.flash_bwd_dkdv(
                *sets[i % 4][:3], bias, sets[i % 4][3], outs[i % 4][1],
                deltas[i % 4], need_dbias=bias is not None, **kw)
        elif name == "flash_bwd_dq":
            deltas = [fa.row_delta(z[3], o) for z, (o, _) in zip(sets, outs)]
            fn = lambda i: fa.flash_bwd_dq(
                *sets[i % 4][:3], bias, sets[i % 4][3], outs[i % 4][1],
                deltas[i % 4], **kw)
        else:
            fn = lambda i: fwd(*sets[i % 4][:3], bias, **kw)
        row = {"kernel": name, "shape": shape, "b": b, "t": t, "h": h,
               "dh": dh, "causal": causal, "bias": bias_kind,
               "kernel_ms": [time_ms(torch, fn) for _ in range(3)]}
        if name == "flash_bwd_dq":
            row["sdpa_bwd_ms"] = sdpa_bwd_ms(torch, F, sdpa, kw["scale"],
                                             4)[0]
        elif name not in BWD_WRAPPERS:
            mask = (None if bias is None else
                    (bias.view(b, h, 1, t) > -1e8))
            row["sdpa_fwd_ms"] = time_ms(
                torch, lambda i: F.scaled_dot_product_attention(
                    *sdpa[i % 4][:3], attn_mask=mask, is_causal=causal,
                    scale=kw["scale"]))
        rows.append(row)
        del sets, outs, sdpa
        torch.cuda.empty_cache()
    emit({"phase": which, "rows": rows, "card": card_line()})


def phase_solo_verify(torch, pa, positions, W=5):
    """K2 alone at phase 7's verify shapes (bf16, 8 slots, W = 5, 6 heads
    of 128, block 16, 64-entry tables, chunks at ``positions``; 12 layers'
    pools in rotation): three graph-replay medians, and one SDPA call over
    K/V gathered beforehand, for comparisons of kernel versions in turns."""
    import torch.nn.functional as F
    dev, dtype = "cuda", torch.bfloat16
    B, h, dh, bs, mb, NL = 8, 6, 128, 16, 64, 12
    L = mb * bs
    g = torch.Generator(device=dev).manual_seed(6)
    nb = 1 + B * mb
    kp = torch.randn((NL, nb, h, bs, dh), generator=g, device=dev).to(dtype)
    vp = torch.randn((NL, nb, h, bs, dh), generator=g, device=dev).to(dtype)
    q = torch.randn((B, W, h, dh), generator=g, device=dev).to(dtype)
    table = (torch.randperm(nb - 1, generator=g, device=dev)[:B * mb]
             .reshape(B, mb) + 1).to(torch.int32)
    pos0 = torch.tensor(positions, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(dh)
    kern = lambda i: pa.paged_verify_attention(q, kp[i % NL], vp[i % NL],
                                               table, pos0, scale)
    kl = [pa.paged_gather(kp[i], table) for i in range(NL)]
    vl = [pa.paged_gather(vp[i], table) for i in range(NL)]
    rows = pos0.long()[:, None] + torch.arange(W, device=dev)[None, :]
    mask = (torch.arange(L, device=dev)[None, None, :]
            <= rows[:, :, None])[:, None]                 # [B, 1, W, L]
    qh = q.transpose(1, 2).contiguous()
    lib = lambda i: F.scaled_dot_product_attention(
        qh, kl[i % NL], vl[i % NL], attn_mask=mask, scale=scale)
    emit({"phase": "k2", "shapes": {"B": B, "W": W, "h": h, "dh": dh,
                                    "bs": bs, "max_blocks": mb,
                                    "pos0": positions},
          "kernel_ms": [time_ms(torch, kern) for _ in range(3)],
          "sdpa_ms": time_ms(torch, lib), "card": card_line()})


# -- extra phase: profile ---------------------------------------------
def phase_profile(torch, np):
    """A steady decode window of the full-width bf16 server (8 greedy
    requests, 256-token prompts, 504 new tokens each; admissions done
    before the windows).  Window A, unprofiled: wall per tick.  Window B,
    CUDA activity only (CUPTI; no CPU-op recording, which would slow the
    host many times over): device time per tick and what the tick
    launches.  Busy share = device time per tick / window A's wall."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_torch import telemetry
    from deeplearning4j_torch.parallel import GenerationServer
    from deeplearning4j_torch.zoo import Gpt

    ticks = telemetry.get_registry().counter("generation_server_ticks_total")
    net = Gpt(seed=0).init_graph(device="cuda")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 32000, 256).astype(np.int32)
               for _ in range(8)]
    with GenerationServer(net, n_slots=8, max_len=1024, block_size=16,
                          tick_batch=8, compute_dtype="bfloat16",
                          device="cuda") as srv:
        srv.submit(prompts[0], 8)                          # warm-up
        hs = [srv.submit_async(p, 504) for p in prompts]
        deadline = time.monotonic() + 300
        while min(h.emitted for h in hs) < 8:              # all admitted
            if time.monotonic() > deadline:
                raise TimeoutError("profile: requests never decoded")
            time.sleep(0.001)
        emitted0 = [h.emitted for h in hs]
        k0, t0 = ticks.value, time.perf_counter()
        time.sleep(1.0)
        wall_a, ticks_a = time.perf_counter() - t0, ticks.value - k0
        k0 = ticks.value
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            time.sleep(1.0)
            wall_b = time.perf_counter() - t0
        ticks_b = ticks.value - k0
        emitted1 = [h.emitted for h in hs]
        if min(h.emitted for h in hs) >= 504:
            raise AssertionError("profile: requests ended inside the "
                                 "windows")
        for h in hs:
            h.result(300)
    kernels, busy_us, n_kernels = {}, 0.0, 0
    for evt in prof.events():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        busy_us += us
        n_kernels += 1
        kernels[evt.name[:80]] = kernels.get(evt.name[:80], 0.0) + us
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    ms_tick_a = wall_a * 1e3 / ticks_a
    dev_ms_tick = busy_us / 1e3 / ticks_b
    emit({"phase": "profile", "unprofiled_wall_ms_per_tick": ms_tick_a,
          "unprofiled_ticks": ticks_a,
          "profiled_wall_ms_per_tick": wall_b * 1e3 / ticks_b,
          "profiled_ticks": ticks_b,
          "device_ms_per_tick": dev_ms_tick,
          "device_busy_share": dev_ms_tick / ms_tick_a,
          "device_events_per_tick": n_kernels / ticks_b,
          "top_device_us_per_tick": [{"name": k, "us": v / ticks_b}
                                     for k, v in top],
          # the slots' contexts (prompt + tokens so far) over both windows
          "contexts": [256 + min(emitted0), 256 + max(emitted1)],
          "card": card_line()})


def kernel_row(name, source, replaces, launches, err, timing):
    """One entry of the closing ``kernels`` line.  ``plain_scope`` and
    ``library_scope`` say what the plain and library times cover: this
    kernel's function ("kernel") or the whole attention backward, every
    gradient at once ("bwd_all", the rows of K5 and K6)."""
    return {"name": name, "route": "cuda",
            "source": f"deeplearning4j_torch/kernels/csrc/{source}",
            "replaces": f"deeplearning4j_tpu/kernels/{replaces}",
            "launches": launches, "max_abs_err": err,
            "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"],
            "plain_scope": timing.get("plain_scope", "kernel"),
            "library_scope": timing.get("library_scope", "kernel")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + EXTRA_PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke runs only on a CUDA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from deeplearning4j_torch.kernels import _build
        from deeplearning4j_torch.kernels import paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t = time.perf_counter()
        libs = _build.build_all(verbose=True)
        emit({"phase": "build", "libraries": sorted(libs),
              "seconds": time.perf_counter() - t,
              "torch": torch.__version__, "cuda": torch.version.cuda})
        launches, timing = None, None
        v_launches, v_timing, t_counts, f_timing = None, None, None, None
        if "kernel" in phases:
            phase_kernel(torch, pa)
        if "pangrams" in phases:
            phase_pangrams(torch, np, root)
        if "full" in phases:
            launches = phase_full(torch, np, pa)
        if "spec" in phases:
            v_launches = phase_spec(torch, np, pa, root)
        if "fleet" in phases:
            phase_fleet(torch, np, pa)
        if "train" in phases:
            t_counts = phase_train(torch, np)
        if "timings" in phases:
            mid = path_mid(np)
            timing = phase_timings(torch, pa, mid)
            v_timing = phase_timings_verify(torch, pa, mid)
            f_timing = phase_timings_flash(torch)
        if "profile" in phases:
            phase_profile(torch, np)
        for which in SOLO_SHAPES:
            if which in phases:
                phase_solo(torch, which)
        if "k2" in phases:
            phase_solo_verify(torch, pa, path_mid(np))
        if "wide" in phases:
            # the dh-256 builds at the width of the path (3 heads of 256)
            mid = path_mid(np)
            phase_timings(torch, pa, mid, h=3, dh=256,
                          phase="timings/dh256")
            phase_timings_verify(torch, pa, mid, h=3, dh=256,
                                 phase="timings/verify_dh256")
            phase_timings_flash(torch, h=3, dh=256,
                                phase="timings/flash_dh256")
        if None not in (launches, timing, v_launches, v_timing, t_counts,
                        f_timing):
            rows = [
                kernel_row("paged_decode_attention", "paged_decode.cu",
                           "paged_attention.py:110", launches,
                           timing["max_abs_err"], timing),
                kernel_row("paged_verify_attention", "paged_verify.cu",
                           "paged_attention.py:228", v_launches,
                           v_timing["max_abs_err"], v_timing)]
            # (wrapper, source, TPU kernel, main path it runs on)
            for name, src, tpu, t in (
                    ("flash_fwd", "flash_fwd.cu", "flash_attention.py:95",
                     2048),
                    ("flash_fwd_single", "flash_fwd.cu",
                     "flash_attention.py:164", 512),
                    ("flash_bwd_dkdv", "flash_bwd.cu",
                     "flash_attention.py:304", 2048),
                    ("flash_bwd_dq", "flash_bwd.cu",
                     "flash_attention.py:363", 2048)):
                ft = f_timing[name]
                rows.append(kernel_row(name, src, tpu, t_counts[t][name],
                                       ft["max_abs_err"], ft))
            emit({"kernels": rows})
        card = card_line()
    except Exception:
        traceback.print_exc()
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
