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
               padding bias, on K4; and at its training shape, b 32 with
               phase 8(b)'s padding, K5 without dBias), t 896 on K4
               (seven key tiles) and
               dh 32 (zero-padded to 64 by the wrappers) on K3-K6.
               Past the fast kernels' head dims: K1 and K2 at dh 12 (rows
               not 16-byte aligned) and 160 (the any-dh kernel), 192 and
               256 (the wide builds in bf16, the any-dh kernel in f32; K1
               also at block 8 and on its own split edges), K3-K6 at dh
               160 (padded to the 192 build) and 256.
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
  6b. slo    — the serving SLO control plane over ServingFleet, default-
               width zoo.Gpt() in bf16 (seeded weights), phase 6's
               replica config with every replica speculative (k 4, 2
               rounds, 2 draft layers, adaptive), tenants chat
               (interactive) and bulk (batch): (a) the process time-series
               store recording every 0.25 s, an AlertEngine (a ttft SLO,
               0.1 s at 99%, and chat's availability; burn windows (1.5 s,
               4 s) at 14.4, pending 0.5 s, clear 1 s), a DegradeLadder
               attached to the fleet and an Autoscaler (1..2 replicas,
               cooldown 20 s, reactive signals disarmed), every loop
               started; (b) phase 6(a)'s 16 requests as chat plus 16 bulk
               requests at once: the alert goes pending then firing, the
               ladder climbs to shed_batch and a bulk submit is rejected
               with its retry-after, exactly one scale-up (the alert's
               pre-warm) whose replica is built on the card and joins,
               every chat request finishes, greedy chat streams equal
               offline generate() at the budget each was shaped to, K1 and
               K2 counted from a reset; (c) recovery with no load: the
               alert resolves, the ladder walks back one rung per
               hold-down, exactly one scale-down, a fresh request equals
               offline; (d) the loops stopped, the ladder walked 0 -> 5 ->
               0 with injected clocks, one request at each rung (sampled
               from rung 2): n_new capped from rung 1, greedy from 2, W =
               2 at 3, K2 frozen while K1 runs at 4 and 5, bulk shed at 5,
               K2 again and the never-degraded stream back at 0; (e)
               /metrics, /query and /alerts on a loopback port and one
               flight-recorder bundle with history and SLO state; (f) the
               median ms per pass of tsdb.record, AlertEngine.evaluate,
               DegradeLadder.evaluate and Autoscaler.evaluate, and phase
               6(a)'s requests on one replica without the plane and with
               it at rung 0, in turns off, on, on, off.
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
  7b. resume — resumable training: default-width zoo.Gpt() with dropout
               0.1, bf16 on f32 masters, Adam(3e-4), b 8, t 2048, four
               seeded batches over two epochs: (a) the uninterrupted run,
               twice (are two runs equal bit for bit?); (b) the same with a
               CheckpointListener (every 2 iterations, keep 2) preempted
               after iteration 5 by the ``preempt`` fault site — the forced
               save lands; (c) a fresh Gpt(seed=1) resumes with
               fit(resume=True) and equals (a) bit for bit (or within
               twice (a)'s run-to-run spread, if the two runs differ) —
               the main path, K3, K5 and K6 each counted from 0, 12 per
               resumed step; (d) BadStepPolicy(max_consecutive=2) through
               two NaN steps: params unchanged across the first, the LR
               scale at 0.5, the rollback to the checkpoint on the card;
               (e) save ms (host copy, write), restore ms, bytes per step
               and a saving step's wall against a plain one's.
  7c. rnn    — the recurrent stack (no kernel of the port on its path):
               (a) card f32 against CPU f64 (``RNN_TOL``), the default-
               width zoo.TextGenerationLSTM() (2 x 256 GravesLSTM, vocab
               77) with seeded weights on one [32, 50, 77] chunk: output,
               loss and gradients, rnn_time_step step by step, a masked
               batch (lengths 10..50) streamed with its carry held; a
               Bidirectional(GravesLSTM) + SimpleRnn + LastTimeStep(GRU)
               net through output and one fit step; (b) the checked-in
               TextGenerationLSTM_pangrams.zip — sha256 against its
               manifest, score and sampled string equal to the CPU's, a
               pangram word in it; (c) the main path: TextGenerationLSTM()
               trained through fit (tBPTT 50, Adam 1e-3, clip 1.0) on
               CharacterIterator(seq_length 1000, batch 32) over five
               pre-port docs (~86k characters), 2 epochs of 2 batches = 80
               chunks, the loss falling, then 200 characters sampled; (d)
               the same preempted after chunk 39 and resumed by a fresh
               model, equal bit for bit; (e) ms per chunk, characters/s,
               ms per sampled character, peak memory, a profiled chunk
               (busy share, launches), the port's LSTM against
               torch.nn.LSTM at [32, 50, 256].
  8. bert    — BERT-base (zoo.Bert(): 12 x 768, 12 heads of 64, ff 3072,
               vocab 30522, seeded random weights) trained through
               MultiLayerNetwork.fit at t 512, a padding mask as the flash
               kernels' key bias (K4 forward, K5 without dBias, K6): (a)
               f32, b 2 (row 1 with 300 valid tokens), flash vs plain loss
               and gradients (rtol 1e-3), K4 = K5 = K6 = 12; (b) the main
               path: bf16 on f32 master weights, Adam(2e-5), b 32, each
               row's valid length seeded in 64..512, a warm-up step then
               five counted fit steps (K4 = K5 = K6 = 60, K3 = 0, loss
               finite and falling), tokens/s (b*t and valid), MFU, peak
               memory and a profiled step with the flash kernels' share of
               device time; (c) the data path: tiny_sentiment ->
               build_vocab -> WordPiece -> BertIterator at t 512, one
               epoch of fit, then evaluate on the held-out batches, its
               confusion matrix equal to output()'s argmax on the host.
  9. resnet  — ResNet-50 (zoo.ResNet50(): 224 x 224 x 3, 1000 classes,
               stages [3, 4, 6, 3], seeded random weights) trained
               through ComputationGraph; convolutions, batch norm and
               pooling are PyTorch's own ops (cuDNN) and no kernel of the
               port is on this path.  (a) b 2, the same f32-
               representable parameters on the card and the CPU, TF32
               off for the part: in f64 the output, loss, four gradients
               (stem conv, a strided 1x1 projection, a mid-stage gamma,
               the head) and every batch-norm state within 1e-7 of each
               element's size; in f32 the output, loss and states within
               1e-3, and the gradients on the main path's channels-last
               layout within 4x the CPU f32's own normwise distance from
               the CPU's f64 (ResNet-50's f32 gradients are
               ill-conditioned at random init, in the JAX package too);
               every distinct convolution and pooling alone, card f32
               channels-last against CPU f64, within 1e-4.  (b) The main
               path: bf16 on f32 master weights, AdaDelta, b 256 over
               four seeded input buffers (bench.py's bench_resnet50), a
               warm-up on buffer 0 then five counted compiled_train_step
               steps on buffers 0, 1, 2, 3, 0 and one fit step — losses
               finite, buffer 0's loss lower after one update (AdaDelta
               overshoots on fresh buffers, in the JAX package too),
               batch-norm statistics moved; images/s, step ms, MFU (conv and dense
               flops), peak memory, and two profiled steps: device ms,
               events and cuDNN layout transposes, and device ms by
               class (convolution, batch norm, pooling, elementwise,
               head and loss, updater, copies, layout transposes).
               (c) The checked-in LeNet_mnist.zip and SimpleCNN_cifar10-
               synthetic.zip on the card over the synthetic test splits
               (accuracy > 0.97 and > 0.9, evaluate's confusion equal to
               output()'s argmax on the host), then one epoch of a fresh
               LeNet on 2,048 synthetic training examples, its loss
               finite and falling.
 9b. infer   — batched inference and transfer learning, seeded weights
               and images: (a) VGG16 (224 x 224 x 3, 1000 classes) at b 2,
               the card's output, loss and gradients in f64 and f32
               against the CPU's f64 (f32 gradients along the card's own
               ReLU and pool decisions, the flipped ones counted), every
               layer alone; (b) dl4j-examples'
               EditLastLayerOthersFrozen: VGG16 frozen through fc2, the
               head replaced by 5 classes, Nesterovs, 10 fit steps at b
               16 — frozen params bit-identical, the head moved, the
               batch's score lower, the source unchanged; (c)
               ParallelInference over the fine-tuned model, 8 callers x
               16 single images, each held to the direct
               output() of its image, then a shed case; (d)
               QuantizedInference of it (weights dequantized to bf16,
               math in the model's f32) against f32 output(); (e)
               every other zoo CNN at its default input through one
               forward, one fit step of YOLO2, UNet and FaceNetNN4Small2,
               the LeNet zip through load_pretrained; (f) the flash route
               of SelfAttentionLayer at BERT-base's attention width (12 x
               64) in a sequence classifier, bf16 on f32 masters, b 32:
               t 512 with seeded padding (K4, K5, K6) and t 1024 unmasked
               (K3, K5, K6), counted from 0 and held to the plain
               versions on the steps' own operands.
 9c. samediff — graph import (BASELINE config 3): (a) the frozen BERT-base
               graph (tests/fixtures/bert_base_graph_only.pb: 12 x 768,
               12 heads of 64, ff 3072, vocab 30522, t 512; its weights
               emptied and seeded from the sidecar with numpy) imported
               through the port's wire codec and rewritten by
               optimize_for_tpu — the JAX package's counts on the same
               file, 12 fused attention sites — then its f32 forward at b
               2 against the port on the CPU in f64 (last hidden state and
               pooler, normwise <= 1e-4); (b) the main path: the SST-2
               classifier head, bf16 on f32 masters, Adam(2e-5), b 40,
               t 512 over the tiny-sentiment corpus through BertIterator,
               a warm-up step whose flash operands are replayed against
               the plain versions, then 10 counted steps on one batch (K4,
               K5 without dBias and K6 12 times a step each, counted from
               0): the loss finite and falling, step ms, padded and valid
               tokens/s, the interpreter's host ms per step, peak memory,
               a profiled step's busy share, the held-out accuracy over
               the 80 sentences; (c) the committed fixtures against
               TensorFlow's goldens (3e-5): bert_tiny unfused and fused,
               gpt_toy (t 512, causal) fused with its mask dropped on K4's
               causal route and a 3-step fine-tune on K4/K5/K6,
               bert_tiny_sentiment imported and run, a zip saved on the
               card loaded on the CPU; (d) an MLP, a CNN and an attention
               block written with onnx_serde, read back, card against CPU
               (1e-5), the attention block with no fused site; (e) a
               seeded CSV through CSVRecordReader -> TransformProcess
               (filter + one-hot) -> RecordReaderDataSetIterator ->
               MultiLayerNetwork.fit on the card: rows/s, accuracy up.
 9d. mesh    — multi-device on the card listed as every mesh device
               (BASELINE config 5): (a) a tp = 2 GenerationServer of
               full-width Gpt() against a tp = 1 one — f32 greedy and
               phase 4(b)'s bf16 mix (greedy by the near-tie rule, sampled
               draw for draw), a speculative run, K1 and K2 per shard on
               3 of 6 heads, each at that shape held to its plain
               version, tokens/s beside tp = 1's; (b) Gpt() at b 8, t 2048
               under data = 2, model = 2 and pipeline = 2 (and data = 2 at
               t 512), losses against the unsharded fit's, K3-K6 counted
               a step, one launch of each held to its plain version; (c)
               data-parallel ResNet-50, global b 256, sync-BN against one
               device; (d) ring attention over 4 sequence shards, t 4096;
               (e) one NCCL world: reductions, the gradient all-reduce,
               the scaling harness, an elastic pipeline resume and a
               coordinated preemption.
 9f. dist    — every mesh axis across OS processes: workers of this
               script (``--dist-worker``) on cuda:0 joined by gloo
               (``initialize(backend="gloo")``): (a) Gpt() b 8, t 2048,
               bf16 under model = 2 over 2 processes, 2 steps, and a
               control whose model sums drop a rank's share; (b)
               pipeline = 2 (n_micro 4) over 2; (c) data 2 x model 2 x
               pipeline 2 over 8 at depth 4; losses equal on every rank
               (1e-6) and within MESH_TOL of the one-process mesh and the
               unsharded step, K3/K5/K6 counted in every worker, one
               launch of each held to its plain version; (d) ring
               attention over a 2-process sequence axis, t 2048; (e) the
               data 2 x tp 2 server, its per-slot state on its rows; (f)
               a worker SIGKILLed mid-decode, its black box salvaged.
 10. timings — K1 and K2, their plain versions and one PyTorch SDPA call
               each at the path shapes (CUDA-graph replay, medians), beside
               the memory bound; K3-K6 at the training shapes beside their
               plain versions, SDPA's forward and its backward alone
               (graph replay, the backward with the spread of its 9
               replays), all on the same rotating input sets, and the
               bound; K4, K5 and K6 again at BERT-base's training shape
               (b 32, t 512, 12 x 64, phase 8(b)'s padding as the bias,
               SDPA with it as a float attn_mask).
 10b. wide   — the head dims past 128 (``WIDE_CFG``): (a) timings as in
               phase 10 of K1 and K2 in bf16 at 3 heads of 256, 4 of 192,
               3 of 160, 2 of 384 and 2 of 512 (the wide builds) and in
               f32 at 3 of 256 (the any-dh kernel), and of K3-K6 at
               b 8, t 2048 causal (K4 at t 512) at 3 heads of 256 and at
               4 heads of 192 — forward and backward on wgmma with
               64-row tiles — and at 2 heads of 384 and 2 of 512 (the
               64-row forward, the panel backward with 32-row streamed
               tiles); (b) the main path of those builds:
               default-width zoo.Gpt(n_heads=3) (12 x 768, 3 heads of
               256, vocab 32000, bf16, seeded weights), b 8: one output()
               at t 2048 (K3 = 12) and one at t 512 (K4 = 12), then 2 fit
               steps at t 2048 (K3 = K5 = K6 = 12 a step) — each window
               after a warm-up whose launches' operands are replayed
               through the kernels against their plain versions, counts
               from 0; output finite, the loss curve within 1e-3 of the
               same steps on plain attention, ms, tokens/s, peak memory
               and a profiled step; (c) Gpt(n_heads=4) (4 heads of 192)
               the same way: its output() at t 2048 (K3 = 12) and 2 fit
               steps (K3 = K5 = K6 = 12 a step), replayed, counted and
               held to plain attention's loss curve; (d) Gpt(n_heads=2)
               (2 heads of 384): output() at t 2048 (K3 = 12) and t 512
               (K4 = 12), each held to plain attention's output, and 2 fit
               steps at t 2048 (K3 = K5 = K6 = 12 a step) held to its
               loss curve; (e) Gpt(n_heads=3) served through
               GenerationServer in bf16 (8 slots, max_len 1024, block 16,
               tick_batch 8): phase 4(b)'s first 8 requests (K1 = 12 a
               tick on the wide decode build), then 4 greedy ones with
               speculative SPEC_FULL (K2 = 12 a verify pass, W 5) — each
               window after a warm-up whose K1/K2 operands are replayed
               against the plain versions, counts from 0, greedy streams
               held to offline generate() (bf16 near-tie rule), tokens/s;
               (f) Gpt(n_heads=2) (2 heads of 384) served the same way:
               phase 4(b)'s first 4 requests (K1 = 12 a tick), then its
               2 greedy ones speculative (K2 = 12 a verify pass, W 5),
               every launch on the wide builds (class 384 for K2).

``--phases`` runs a subset (e.g. ``--phases build,kernel``,
``--phases build,resume`` for resumable training alone,
``--phases build,rnn`` for the recurrent stack alone,
``--phases build,infer`` for batched inference and transfer learning
alone, ``--phases build,samediff`` for graph import alone,
``--phases build,mesh`` for the multi-device slice alone,
``--phases build,dist`` for the cross-process mesh alone,
``--phases build,resnet`` for the conv slice alone, or ``--phases
build,slo`` for the control plane alone).  The extra
phase ``profile`` (not run by default) traces a steady bf16 decode window
of the full-width server with ``torch.profiler``: device busy share,
kernel launches per tick and the top kernels by device time.  The extra
phases ``k3``, ``k4``, ``k5`` and ``k6`` time one flash kernel alone at
the training shapes (K4 also at BERT-base's, 12 heads of 64 with a
padding bias; K6 beside SDPA's backward), and ``k2`` the verify kernel
at phase 4(b)'s mid contexts with W = 5 beside one SDPA call, three
medians each, for quick comparisons of kernel versions in turns; ``kbert``
runs phase 10's BERT-shape timings alone, ``chunked`` times K3-K6 on
the chunked FMA build (f32 at 2 heads of 384, bf16 at 2 of 576) beside
SDPA and the bound, and ``bertops`` charges one BERT
main-path step's device time to the PyTorch ops that launched it.
``--phases build,wide`` runs phase 10b alone.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback

PHASES = ("build", "kernel", "pangrams", "full", "spec", "fleet", "slo",
          "train", "resume", "rnn", "bert", "resnet", "infer", "samediff",
          "mesh", "dist", "periphery", "timings", "wide")
EXTRA_PHASES = ("profile", "k2", "k3", "k4", "k5", "k6", "kbert",
                "bertops", "chunked")  # only when asked
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
# f32 <= 4e-6; at head dims 192 and 256, whose 64-key tiles move the
# running max twice as often, K3's O reads up to 2.1e-2 (b 8, t 2048,
# 4 heads of 192) and K4's 7.1e-3.  A K5 that skips its last query tile
# reads 1.27.
FLASH_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
SPEC_FULL = {"k": 4, "rounds": 2, "draft_layers": 2, "adaptive": True}
# (head dim, heads) of the K1/K2 cases the fast kernels do not take: the
# any-dh kernel at 12 and in f32 past 128 (its register widths 256 and
# 512); the wide builds in bf16 at 160 (the head dim read at run time),
# 192 (zoo.Gpt(n_heads=4)) and 256 (Gpt(n_heads=3)).  WIDER_DH: past 256
# and off the multiples of 16, after the first set (whose cases keep
# their seeds): the wide builds at 200 (half a 16-column k-step past the
# last whole one), 384 (Gpt(n_heads=2)) and 512; the any-dh kernel at
# 1032 (bf16 too; column slabs past 1024)
ANY_DH = ((12, 6), (160, 3), (192, 4), (256, 3))
WIDER_DH = ((200, 3), (384, 2), (512, 2), (1032, 1))
# the head dims of the wide builds (bf16) that phase wide (a) times, with
# their heads (at d 768 up to 384)
WIDE_DH = ((192, 4), (256, 3), (160, 3), (384, 2), (512, 2))
# (head dim, heads) at which phase wide (a) times K3 and K4 on the cluster
# kernel (bf16 past 512): part (g)'s one head of 768, the chunked phase's
# 2 of 576, and 4 of 1024
CLUSTER_DH = ((768, 1), (576, 2), (1024, 4))
# optimize_for_tpu's counts on tests/fixtures/bert_base_graph_only.pb: the
# JAX package's on the same file (held by tests/test_torch_rewrites.py)
BERT_BASE_REWRITES = {"parallel_matmuls": 12, "layer_norm": 25, "gelu": 12,
                      "attention": 12, "flatten_reshapes": 48}
ROOT_DIR = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12            # dense tensor-core bf16 peak
H100_F32_FLOPS = 67e12              # float32 outside the tensor cores


T0 = time.perf_counter()


def emit(obj):
    """Print ``obj`` as one JSON line; a phase's line gets ``t_s``, the
    seconds since this process started, so a run's lines show where its
    time budget goes."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
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


def verify_reference_f64(torch, pa, q, k_pool, v_pool, block_table, pos0,
                         scale):
    """K2's function in f64 throughout (scores, softmax and P V), rows as
    :func:`paged_verify_attention_reference` lays them out: the yardstick
    that tells summation-order noise of the f32 versions from a defect."""
    kl = pa.paged_gather(k_pool.double(), block_table)
    vl = pa.paged_gather(v_pool.double(), block_table)
    L, W = kl.shape[2], q.shape[1]
    s = torch.einsum("bwhd,bhkd->bwhk", q.double(), kl) * scale
    pos = (pos0.long()[:, None] + torch.arange(W, device=q.device))[:, :, None,
                                                                   None]
    s = torch.where(torch.arange(L, device=q.device) <= pos, s, -math.inf)
    return torch.einsum("bwhk,bhkd->bwhd", torch.softmax(s, dim=-1), vl)


def verify_case(torch, pa, B, h, dh, bs, mb, W, positions, dtype, seed,
                f64=False):
    """K2 vs the plain version on shuffled tables.  Each slot has a budget
    of 1..W valid rows (a slot near the table's end keeps all W: its
    deeper rows see the whole table); block 0, unneeded table entries and
    every row past a slot's last valid position are NaN in the kernel's
    pool.  Returns :func:`flash_err` over the valid rows; with ``f64`` its
    detail also holds the kernel's and the plain version's errors against
    :func:`verify_reference_f64` on the same inputs."""
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
    err, detail = flash_err(torch, got, want)
    if f64:
        r64 = verify_reference_f64(torch, pa, q, kp, vp, table, pos0,
                                   scale)[valid]
        detail["kernel_vs_f64"] = flash_err(torch, got.double(), r64)[0]
        detail["plain_vs_f64"] = flash_err(torch, want.double(), r64)[0]
    return err, detail


def phase_kernel(torch, pa):
    path_pos = [0, 15, 16, 17, 511, 1023, 700, 250]
    # K1 splits the context into chunks of C rows (C = 64 at these shapes):
    # positions on split edges and the table's last row; then slots whose
    # context fits the first split beside slots that fill every split
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    C = pa.decode_split_rows(8, 6, 64 * 16, sms)
    Cw = pa.decode_split_rows(8, 3, 64 * 16, sms)   # 3 heads of 256
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
        # head dims the fast kernel does not take: not a multiple of 8
        # (bf16 rows 24 bytes, not 16-byte aligned) on the any-dh kernel,
        # 160 to 256 on the wide builds in bf16 (the any-dh kernel in
        # f32)
        (f"dh{dh}", dict(B=8, h=h, dh=dh, bs=16, mb=64, positions=path_pos))
        for dh, h in ANY_DH] + [
        # the wide builds at block 8 and on their own split edges (their
        # chunk at 3 heads), slots filling one split beside slots filling
        # all
        ("dh256_bs8", dict(B=8, h=3, dh=256, bs=8, mb=128,
                           positions=[0, 7, 8, 9, 511, 1023, 300, 64])),
        ("dh256_split_edges", dict(
            B=8, h=3, dh=256, bs=16, mb=64,
            positions=[Cw - 1, Cw, Cw + 1, 1023, 0, 2 * Cw - 1, 1023,
                       Cw // 2]))]
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
        for (dh, h), W in zip(ANY_DH, (5, 17, 17, 5))]
    # past 256 (WIDER_DH), K1 then K2 (W 5 and 17), after the cases above
    # (each case's seed is its place in the order)
    wider = [(f"dh{dh}", "K1", dict(B=8, h=h, dh=dh, bs=16, mb=64,
                                    positions=path_pos))
             for dh, h in WIDER_DH] + [
        (f"verify_dh{dh}_w{W}", "K2",
         dict(B=8, h=h, dh=dh, bs=16, mb=64, W=W,
              positions=[0, 15, 16, 17, 511, 1024 - W + 1, 700, 250]))
        for (dh, h), W in zip(WIDER_DH, (5, 5, 17, 5))]
    errs, details = {}, {}
    for name, kern, kw in ([(n, "K1", kw) for n, kw in cases]
                           + [(n, "K2", kw) for n, kw in vcases] + wider):
        case = kernel_case if kern == "K1" else verify_case
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            err, detail = case(torch, pa, dtype=dtype, seed=len(errs), **kw)
            errs[f"{name}/{dname}"] = err
            details[f"{name}/{dname}"] = detail
            if not err <= PAGED_TOL[kern][dname]:
                raise AssertionError(f"{kern} {name}/{dname}: error {err} > "
                                     f"{PAGED_TOL[kern][dname]} ({detail})")
    errs.update(phase_flash_kernel(torch))
    emit({"phase": "kernel", "error": errs, "paged_tolerance": PAGED_TOL,
          "flash_tolerance": FLASH_TOL, "k1_split_rows": C,
          "paged_detail": details,
          "measure": "max |kernel - plain| / (|plain| + RMS(plain))"})
    return errs


def key_bias(torch, kind, b, h, t, g):
    """A [b*h, t] f32 key bias on the card: None, "random" (normal),
    "pad" (-1e9 on the last 20% of keys, as a padding mask folds) or
    "bert" (-1e9 past each row's valid length, the lengths of the BERT
    main path's batch: ``bert_lengths``)."""
    if kind is None:
        return None
    if kind == "bert":
        import numpy as np
        lens = torch.as_tensor(bert_lengths(np, b, t, BERT_SEED),
                               device="cuda")
        keep = torch.arange(t, device="cuda")[None, :] < lens[:, None]
        bias = torch.where(keep, 0.0, -1e9)
        return bias.repeat_interleave(h, dim=0).contiguous()   # b-major
    if kind == "pad":
        bias = torch.zeros((b * h, t), device="cuda")
        bias[:, int(t * 0.8):] = -1e9
        return bias
    return torch.randn((b * h, t), generator=g, device="cuda")


def flash_case(torch, fa, b, t, h, dh, dtype, causal, bias_kind, single,
               seed, f64=False):
    """K3 (or K4 with ``single``), K5 and K6 against their plain versions
    on bthd views of a [b, t + 8, 3 h dh] projection whose rows past t
    are NaN (as are dO's), so a finite, matching result proves no kernel
    reads a row at or past t.  Returns {output: (error, detail)}, the
    error as :func:`flash_err` takes it; with ``f64`` each detail also
    holds the kernel's and the plain version's errors against the plain
    versions run in f64 throughout on the same inputs (their own LSE and
    delta)."""
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
    # a padding mask's bias needs no gradient: K5 runs without dBias, as
    # on the BERT main path
    with_bias = bias is not None and bias_kind != "bert"
    scale = dh ** -0.5
    kw = dict(causal=causal, scale=scale)
    fwd = fa.flash_fwd_single if single else fa.flash_fwd
    o, lse = fwd(q, k, v, bias, **kw)
    bh = fa._to_bh
    delta = fa.row_delta(do, o)
    dk, dv, db = fa.flash_bwd_dkdv(q, k, v, bias, do, lse, delta,
                                   need_dbias=with_bias, **kw)
    if not with_bias and db is not None:
        raise AssertionError("flash_bwd_dkdv returned a dBias it was not "
                             "asked for")
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
    if f64:
        q6, k6, v6, do6 = (bh(x.double()) for x in (q, k, v, do))
        b6 = None if bias is None else bias.double()
        o6, l6 = fa.flash_fwd_reference(q6, k6, v6, b6, single=single, **kw)
        d6 = (do6 * o6).sum(-1)
        g6 = fa.flash_bwd_reference(q6, k6, v6, b6, do6, l6, d6, **kw)
        ref = {"o": o6, "lse": l6, "dq": g6[0], "dk": g6[1], "dv": g6[2],
               "dbias": g6[3]}
        for name, (_, detail) in errs.items():
            detail["kernel_vs_f64"] = flash_err(torch, got[name].double(),
                                                ref[name])[0]
            detail["plain_vs_f64"] = flash_err(torch, want[name].double(),
                                               ref[name])[0]
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
# padding bias: -1e9 on the last 20% of keys; and at the BERT main path's
# b 32 with its rows' valid lengths, K5 without dBias), the longest t that
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
    # BERT-base's training shape: the main path's b 32 and padding
    ("bert_train", 32, 512, 12, 64, False, "bert", True),
    ("k4_t896", 2, 896, 6, 128, True, None, True),
    ("ragged_causal_bias_dh32", 2, 777, 4, 32, True, "random", False),
    ("ragged_bias_dh32_k4", 2, 333, 4, 32, False, "random", True),
    # past dh 128: dh 160 (zero-padded to the 192 build) and 256, on the
    # 64-row wgmma tiles of the bf16 route (f32 on FMA tiles)
    ("ragged_causal_bias_dh160", 2, 777, 3, 160, True, "random", False),
    ("ragged_bias_dh160_k4", 2, 333, 3, 160, False, "random", True),
    ("causal_dh256", 2, 1000, 3, 256, True, None, False),
    ("causal_pad_dh256_k4", 2, 512, 3, 256, True, "pad", True),
    # past dh 256: the bf16 forward on 64-row wgmma tiles with the output
    # panels split across the warpgroups (64-key tiles at dh 320, 32 from
    # 384), the bf16 backward on the panel kernels (32-row streamed tiles,
    # the output panels split the same way; one ring stage at 448 and
    # 512), f32 on the chunked kernels
    ("ragged_causal_bias_dh320", 2, 777, 2, 320, True, "random", False),
    ("causal_pad_dh320_k4", 2, 512, 2, 320, True, "pad", True),
    ("ragged_bias_dh384", 2, 333, 2, 384, False, "random", False),
    ("causal_dh512", 2, 333, 2, 512, True, None, False),
    ("ragged_causal_bias_dh448", 2, 777, 2, 448, True, "random", False),
    # past dh 512: the bf16 forward on the cluster kernel (3 blocks of 3
    # panels at 576, 3 of 4 at 768, 4 at 1024, 8 at 2048: the partial
    # scores summed across the cluster), the bf16 backward and f32 on the
    # chunked kernels
    ("ragged_causal_bias_dh576", 2, 777, 1, 576, True, "random", False),
    ("causal_pad_dh768_k4", 2, 512, 1, 768, True, "pad", True),
    ("ragged_dh1024", 1, 333, 2, 1024, False, None, False),
    ("causal_dh2048", 1, 200, 1, 2048, True, None, False),
]
# cases that run in one dtype: the cluster kernel's 8-block case in bf16
# alone.  In f32 (the chunked kernels) at dh 2048 the kernels and the
# plain versions each lie 0.7e-5 to 1.4e-5 from the same function in f64
# (scripts/flash_case_f64.py on an H100; dK's plain version the furthest),
# so the two f32 summation orders differ by up to 2.1e-5 there, past
# FLASH_TOL's f32 bound, which the cases at 576 to 1024 meet (<= 3.9e-6)
FLASH_DTYPES = {"causal_dh2048": ("bfloat16",)}


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
            if dname not in FLASH_DTYPES.get(name, (dname,)):
                continue
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


# -- phase 6b: the serving SLO control plane ----------------------------
# The plane's clocks on the card: windows and hold times in seconds, every
# loop at 0.25 s.  One ttft objective (the burst's first tokens against a
# 0.1 s bar, 99% good) and one availability objective for ``chat``; a
# (1.5 s, 4 s) burn-window pair at the SRE page threshold 14.4, pending
# for 0.5 s before firing and clear for 1 s before resolving.  The
# reactive autoscaling signals are disarmed (a queue-wait target of 1e9
# s), so the phase's one scale-up is the alert's pre-warm.  The burst's
# first tokens come in waves (the requests queued behind the first slots
# start as those finish), so the alert can resolve in a gap between
# waves and fire again at the next.  A scale-down can come one
# autoscaler cooldown after the scale-up at the earliest, and a second
# scale-up one more after that: at 20 s each the burst (4-6 s on the
# card, 11-13 s with every serving dispatch 80 ms slower,
# scripts/slo_stress.py) is over long before.
SLO_CARD = {"ttft_s": 0.1, "windows": ((1.5, 4.0, 14.4, "page"),),
            "for_s": 0.5, "clear_for_s": 1.0, "interval_s": 0.25,
            "hold_down_s": 1.0, "cooldown_s": 20.0,
            "near_tie": NEAR_TIE_BF16, "deadline_s": 120.0}
SLO_TENANTS = {"chat": "interactive", "bulk": "batch"}


def slo_requests(np, vocab, max_len):
    """Phase 6(a)'s 16 mixed requests as ``chat`` (prompts and budgets
    scaled to ``max_len`` when it is below 1024) and 16 greedy ``bulk``
    requests of a quarter of max_len with 64 new tokens (scaled alike)."""
    _, chat = mixed_requests(np, vocab)
    scale = min(1.0, max_len / 1024)
    if scale < 1.0:
        chat = [(p[:max(2, int(len(p) * scale) // 2)],
                 max(2, int(n * scale) // 2), s) for p, n, s in chat]
    rng = np.random.default_rng(5)
    bulk = [(rng.integers(0, vocab, max(2, max_len // 4)).astype(np.int32),
             max(2, int(64 * scale)), None) for _ in range(16)]
    return chat, bulk


def wait_until(pred, timeout_s, what, state, clock=None):
    """Poll ``pred`` until true; fail with ``state()`` past the deadline.
    With a :class:`PlaneClock` the wait moves the plane's timeline
    instead: one loop interval a poll, ``timeout_s`` on that timeline
    (the phase's waits with no request in flight)."""
    if clock is not None:
        end = clock.monotonic() + timeout_s
        while not pred():
            if clock.monotonic() > end:
                raise AssertionError(f"slo: {what} not reached within "
                                     f"{timeout_s:g} s of the plane's "
                                     f"timeline; saw {state()}")
            clock.advance(clock.interval_s)
        return
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"slo: {what} not reached within "
                                 f"{timeout_s:g} s; saw {state()}")
        time.sleep(0.02)


class PlaneClock:
    """An injected timeline for the control plane, as the CPU rehearsal
    of this phase runs it (``cfg["clock"]``): ``monotonic()`` and
    ``time()`` start at the real clocks' readings and move only by
    :meth:`advance` — called by each serving dispatch during a burst
    and by the phase's own waits when nothing is in flight — and every
    ``interval_s`` of it one thread runs one pass of each registered
    loop (:meth:`add_pass`), in order, while the caller of ``advance``
    waits.  Handed to the plane's modules as their ``time``, it gives
    the plane the same timeline however fast the host runs: the
    recorder, the alert engine, the ladder and the autoscaler see the
    bursts' events the same number of dispatches apart.  Any other
    ``time`` attribute is the real module's."""

    def __init__(self, interval_s):
        self.interval_s = float(interval_s)
        self._mono0, self._wall0 = time.monotonic(), time.time()
        self._t = 0.0                 # the timeline, seconds from start
        self._target = 0.0            # where advance() has asked it to be
        self._next = self.interval_s  # the next pass
        self._passes = {}
        self._cond = threading.Condition()
        self._thread = None

    def monotonic(self):
        return self._mono0 + self._t

    def time(self):
        return self._wall0 + self._t

    def __getattr__(self, name):
        return getattr(time, name)

    def add_pass(self, key, fn):
        with self._cond:
            self._passes[key] = fn

    def remove_pass(self, key):
        with self._cond:
            self._passes.pop(key, None)

    def advance(self, dt, timeout_s=30.0):
        """Move the timeline ``dt`` seconds on; return once every pass
        due by then has run (at most ``timeout_s`` of real time)."""
        with self._cond:
            self._target += float(dt)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="slo-plane-clock")
                self._thread.start()
            self._cond.notify_all()
            target = self._target
            self._cond.wait_for(lambda: self._t >= target, timeout_s)

    def _run(self):
        passes = []
        while True:
            for fn in passes:
                try:
                    fn()
                except Exception:
                    traceback.print_exc()
            with self._cond:
                self._cond.notify_all()
                self._cond.wait_for(lambda: self._t < self._target)
                due = self._next <= self._target
                self._t = self._next if due else self._target
                passes = list(self._passes.values()) if due else []
                if due:
                    self._next += self.interval_s


class SloPlane:
    """The whole control plane over one fleet: the process store's
    recorder, an AlertEngine (its windows in the process store), a
    DegradeLadder attached to the fleet, and an Autoscaler driving the
    engine — every loop started, ``close()`` stops them all."""

    def __init__(self, fleet, cfg, max_replicas=2):
        from deeplearning4j_torch import telemetry
        self.clock = cfg.get("clock")
        from deeplearning4j_torch.serving import (AutoscalePolicy,
                                                  Autoscaler, DegradeLadder)
        from deeplearning4j_torch.telemetry.slo import AlertEngine, SLOSpec
        iv = cfg["interval_s"]
        self.tsdb = telemetry.get_tsdb()
        common = dict(target=0.99, window_s=60.0, windows=cfg["windows"],
                      for_s=cfg["for_s"], clear_for_s=cfg["clear_for_s"],
                      min_events=cfg.get("min_events", 1))
        self.engine = AlertEngine(
            [SLOSpec("chat-ttft", objective="ttft",
                     threshold_s=cfg["ttft_s"], **common),
             SLOSpec("chat-avail", objective="availability", tenant="chat",
                     **common)], history=self.tsdb, interval_s=iv)
        # a new plane reads only its own samples: the store is the
        # process's, and an earlier engine's specs of the same names
        # would otherwise sit inside this one's windows
        for spec in self.engine.specs:
            self.tsdb.clear(self.engine._series_key(spec))
        self.ladder = DegradeLadder(fleet, self.engine,
                                    hold_down_s=cfg["hold_down_s"],
                                    interval_s=iv)
        self.scaler = Autoscaler(
            fleet, AutoscalePolicy(min_replicas=1, max_replicas=max_replicas,
                                   queue_wait_p99_target_s=1e9,
                                   up_consecutive=2, down_consecutive=3,
                                   cooldown_s=cfg["cooldown_s"]),
            interval_s=iv, tenant_classes=SLO_TENANTS,
            remove_timeout_s=60.0, alert_engine=self.engine)
        self.fleet = fleet
        fleet.attach_slo(self.engine)
        fleet.attach_degrade(self.ladder)
        if self.clock is None:
            self.tsdb.start_recorder(interval_s=iv)
            self.engine.start()
            self.ladder.start()
            self.scaler.start()
        else:
            # the same loops, one pass each an interval of the clock's
            # timeline
            reg = telemetry.get_registry()
            self.clock.add_pass((id(self), "loops"), lambda: (
                self.tsdb.record(reg), self.engine.evaluate(),
                self.ladder.evaluate(), self.scaler.evaluate()))

    def now(self):
        """The plane's monotonic clock."""
        return (self.clock or time).monotonic()

    def wait(self, seconds):
        """Let ``seconds`` of the plane's timeline pass, no request in
        flight."""
        if self.clock is None:
            time.sleep(seconds)
        else:
            self.clock.advance(seconds)

    def stop_loops(self):
        """Stop every loop (the fleet stays attached)."""
        if self.clock is not None:
            self.clock.remove_pass((id(self), "loops"))
            return
        self.scaler.close()
        self.ladder.close()
        self.engine.close()
        self.tsdb.close()

    def close(self):
        self.stop_loops()
        self.fleet.attach_degrade(None)
        self.fleet.attach_slo(None)

    def alert(self, name="chat-ttft"):
        return next(a for a in self.engine.alerts() if a["slo"] == name)


class PlaneTimeline:
    """A daemon sampling the plane every 10 ms from the burst's start:
    ``seen[key]`` holds (seconds, value) at each change of the ladder's
    rung, the ttft alert's state, the healthy replica count and the
    number of first tokens observed (ladder steps are a hold-down apart,
    so none is missed).  On a plane with a :class:`PlaneClock` it samples
    after each of the clock's passes instead, in the clock's seconds."""

    def __init__(self, plane):
        self._clock = plane.clock
        from deeplearning4j_torch import telemetry
        reg = telemetry.get_registry()
        healthy = reg.gauge("fleet_replicas_healthy")
        ttft = reg.histogram("generation_server_ttft_seconds")
        self._probes = {"rung": plane.ladder.rung,
                        "alert": lambda: plane.alert()["state"],
                        "healthy": lambda: int(healthy.value),
                        "first_tokens": lambda: ttft.count}
        self.seen = {k: [] for k in self._probes}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="slo-plane-timeline")

    def _sample(self):
        t = round(self._now() - self._t0, 3)
        for k, probe in self._probes.items():
            v = probe()
            if not self.seen[k] or self.seen[k][-1][1] != v:
                self.seen[k].append((t, v))

    def _run(self):
        while not self._stop.wait(0.01):
            self._sample()

    def _now(self):
        return (self._clock.monotonic() if self._clock is not None
                else time.perf_counter())

    def start(self):
        self._t0 = self._now()
        if self._clock is not None:
            self._clock.add_pass((id(self), "timeline"), self._sample)
        else:
            self._thread.start()

    def stop(self):
        if self._clock is not None:
            self._clock.remove_pass((id(self), "timeline"))
        else:
            self._stop.set()
            self._thread.join(timeout=5)
        self._sample()

    def first(self, key, value):
        """Seconds at which ``key`` first read ``value`` (None: never)."""
        return next((t for t, v in self.seen[key] if v == value), None)


def scale_actions(reg):
    fam = reg.counter("fleet_autoscale_actions_total",
                      labelnames=("direction",))
    return {v[0]: c.value for v, c in fam._items()}


def live_replicas(fleet):
    return [i for i, r in enumerate(fleet.stats()["replicas"])
            if not r["dead"] and not r["removed"]]


def slo_burst(torch, np, fleet, plane, gen, k1, k2, chat, bulk, cfg):
    """Parts (b) and (c): the burst against the attached plane, then
    recovery with no load.  Returns the part's numbers."""
    from deeplearning4j_torch import telemetry
    from deeplearning4j_torch.resilience import CancelledError
    from deeplearning4j_torch.serving import AdmissionRejectedError

    reg = telemetry.get_registry()
    prewarms = reg.counter("fleet_autoscale_alert_prewarms_total")
    acts0, pw0 = scale_actions(reg), prewarms.value
    lad = plane.ladder
    tl = PlaneTimeline(plane)

    def state():
        return {"alert": plane.alert()["state"], "rung": lad.rung(),
                "live": live_replicas(fleet),
                "actions": scale_actions(reg),
                "healthy": fleet.stats()["healthy_replicas"],
                "rungs": tl.seen["rung"][-12:]}

    # the engine needs its long window's coverage before a burst can page
    long_s = max(w[1] for w in cfg["windows"])
    plane.wait(long_s + 2 * cfg["interval_s"])
    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    tl.start()
    hs = [(fleet.submit_async(p, n, tenant="chat", sampling=s), p, n, s)
          for p, n, s in chat]
    hb = [fleet.submit_async(p, n, tenant="bulk") for p, n, _ in bulk]
    wait_until(lambda: lad.rung() == 5, cfg["deadline_s"],
               "rung 5 (shed_batch)", state)
    t_top = time.perf_counter() - t0
    try:
        fleet.submit_async(bulk[0][0], bulk[0][1], tenant="bulk")
        raise AssertionError("slo (b): a bulk submit at shed_batch was "
                             "admitted")
    except AdmissionRejectedError as e:
        if e.retry_after_s != lad.shed_retry_after_s:
            raise AssertionError(f"slo (b): retry_after_s {e.retry_after_s}"
                                 f" != the ladder's "
                                 f"{lad.shed_retry_after_s}")
    wait_until(lambda: plane.alert()["transitions"].get("firing", 0) >= 1,
               cfg["deadline_s"], "the alert firing", state)
    wait_until(lambda: scale_actions(reg).get("up", 0) - acts0.get("up", 0)
               >= 1 and fleet.stats()["healthy_replicas"] >= 2,
               cfg["deadline_s"], "one scale-up joined", state)
    new_idx = max(live_replicas(fleet))
    new = fleet.replica(new_idx)
    new.attach_history(plane.tsdb)
    outs = []
    for h, p, n, s in hs:
        outs.append(h.result(timeout=900))
    wall = time.perf_counter() - t0
    bulk_done = bulk_shed = 0
    for h in hb:
        try:
            h.result(timeout=900)
            bulk_done += 1
        except CancelledError:
            bulk_shed += 1
    launches = {"k1": k1.launches, "k2": k2.launches}
    if not (launches["k1"] > 0 and launches["k2"] > 0):
        raise AssertionError(f"slo (b): a kernel of the path never launched "
                             f"({launches})")
    trans = plane.alert()["transitions"]
    if not (trans.get("pending", 0) >= 1 and trans.get("firing", 0) >= 1):
        raise AssertionError(f"slo (b): the alert never went pending then "
                             f"firing ({trans})")
    # greedy chat streams at the budget each was shaped to
    pairs, shaped = [], 0
    for (h, p, n, s), out in zip(hs, outs):
        n_out = len(out) - len(p)
        if not (1 <= n_out <= n and (out[:len(p)] == p).all()):
            raise AssertionError(f"slo (b): a chat request returned "
                                 f"{n_out} of {n} new tokens")
        shaped += n_out < n
        if s is None:
            pairs.append((out, gen.generate(p[None], n_out)[0]))
    ties = check_streams(torch, gen, pairs, cfg["near_tie"])
    up = scale_actions(reg).get("up", 0) - acts0.get("up", 0)
    if up != 1 or prewarms.value - pw0 != 1:
        raise AssertionError(f"slo (b): {up} scale-ups, "
                             f"{prewarms.value - pw0} alert pre-warms "
                             "(want exactly one of each)")
    if new.device.type != fleet.replica(0).device.type \
            or not new._kc.device == fleet.replica(0)._kc.device:
        raise AssertionError(f"slo (b): the added replica is on "
                             f"{new._kc.device}")
    burst = {"seconds": wall, "seconds_to_shed_batch": t_top,
             "chat_requests": len(hs), "chat_new_tokens":
             sum(len(o) - len(p) for (h, p, n, s), o in zip(hs, outs)),
             "chat_shaped": shaped, "bulk_finished": bulk_done,
             "bulk_shed": bulk_shed, "alert_transitions": trans,
             "scale_up_replica": new_idx,
             "added_replica_device": str(new._kc.device),
             "launches": launches, "near_ties": ties}

    # (c) recovery with no load (on the plane's own timeline when it has
    # a clock)
    t1 = plane.now()
    wait_until(lambda: plane.alert()["state"] == "resolved",
               cfg["deadline_s"], "the alert resolved", state, plane.clock)
    t_resolved = plane.now() - t1
    wait_until(lambda: lad.rung() == 0, cfg["deadline_s"], "rung 0", state,
               plane.clock)
    t_rung0 = plane.now() - t1
    wait_until(lambda: scale_actions(reg).get("down", 0)
               - acts0.get("down", 0) >= 1 and len(live_replicas(fleet)) == 1,
               cfg["deadline_s"], "one scale-down to 1 replica", state,
               plane.clock)
    t_down = plane.now() - t1
    tl.stop()
    rungs = tl.seen["rung"]
    exits = {k: v for k, v in lad.state()["transitions"].items()
             if k.startswith("exit:")}
    # descent is one rung per hold-down: every downward step is one
    # rung, a hold-down after the step before it
    downs = [(t, a, b) for (_s, a), (t, b) in zip(rungs, rungs[1:])
             if b < a]
    gaps = [t1 - t0 for (t0, _a, _b), (t1, _c, _d) in zip(downs, downs[1:])]
    if (max(r for _t, r in rungs) != 5 or rungs[-1][1] != 0
            or any(a - b != 1 for _t, a, b in downs)
            or any(g < 0.9 * cfg["hold_down_s"] for g in gaps)):
        raise AssertionError(f"slo (c): the ladder did not walk back one "
                             f"rung per hold-down: {rungs}")
    down = scale_actions(reg).get("down", 0) - acts0.get("down", 0)
    if down != 1:
        raise AssertionError(f"slo (c): {down} scale-downs")
    p, n, _ = next(r for r in chat if r[2] is None)
    out = fleet.submit(p, n, tenant="chat", timeout=900)
    ties_c = check_streams(torch, gen, [(out, gen.generate(p[None], n)[0])],
                           cfg["near_tie"])
    recovery = {"seconds_to_resolved": t_resolved,
                "seconds_to_rung0": t_rung0,
                "seconds_to_scale_down": t_down,
                "timeline": {"pending": tl.first("alert", "pending"),
                             "firing": tl.first("alert", "firing"),
                             "shed_batch": tl.first("rung", 5),
                             "healthy_2": tl.first("healthy", 2),
                             "last_first_token": tl.seen["first_tokens"][-1][0],
                             "resolved": tl.first("alert", "resolved"),
                             "rung_0": rungs[-1][0],
                             "healthy_1_again": next(
                                 (t for t, v in tl.seen["healthy"]
                                  if v == 1 and t > (tl.first("healthy", 2)
                                                     or 1e9)), None)},
                "rung_timeline": rungs,
                "ladder_exits": exits, "near_ties": ties_c}
    return burst, recovery


def slo_walk(torch, np, fleet, plane, gen, k1, k2, prompt, n_new, bulk,
             near_tie):
    """Part (d): the ladder walked 0 -> 5 -> 0 by ``evaluate(now=,
    burn=)`` with every real-time loop stopped; one request at each rung
    (sampled from rung 2 on), K1 and K2 counted from a reset at each."""
    from deeplearning4j_torch import telemetry
    from deeplearning4j_torch.serving import AdmissionRejectedError

    reg = telemetry.get_registry()
    scans = reg.counter("generation_server_scan_ticks_total",
                        labelnames=("k",))
    adaptive_k = reg.gauge("generation_server_spec_adaptive_k")
    lad = plane.ladder
    samp = {"temperature": 0.8, "top_k": 40, "seed": 3}
    t = [plane.now()]
    ref = gen.generate(prompt[None], n_new)[0]

    def to_rung(r):
        if r > lad.rung():
            lad.evaluate(now=t[0], burn=lad.thresholds[r - 1])
        while lad.rung() > r:
            t[0] += lad.hold_down_s
            lad.evaluate(now=t[0], burn=0.0)
        if lad.rung() != r:
            raise AssertionError(f"slo (d): ladder at {lad.rung()}, not {r}")

    rows, first = [], None
    for r in (0, 1, 2, 3, 4, 5, 4, 3, 2, 1, 0):
        to_rung(r)
        s0 = {v[0]: c.value for v, c in scans._items()}
        k1.launches = k2.launches = 0
        sampling = samp if r >= 2 else None
        out = fleet.submit(prompt, n_new, tenant="chat", sampling=sampling,
                           timeout=900)
        l1, l2 = k1.launches, k2.launches
        shapes = sorted(k for v, c in scans._items()
                        for k in [v[0]] if c.value - s0.get(k, 0.0) > 0)
        row = {"rung": r, "new_tokens": len(out) - len(prompt),
               "k1": l1, "k2": l2, "scans": shapes,
               "adaptive_k": adaptive_k.value}
        want_n = (max(lad.min_n_new, int(n_new * lad.n_new_factor))
                  if r >= 1 else n_new)
        if row["new_tokens"] != want_n:
            raise AssertionError(f"slo (d): rung {r} decoded "
                                 f"{row['new_tokens']} tokens, not {want_n}")
        row["near_ties"] = check_streams(torch, gen, [(out, ref[:len(out)])],
                                         near_tie)
        if l1 <= 0:
            raise AssertionError(f"slo (d): no K1 launch at rung {r}")
        if r == 3 and not (adaptive_k.value <= 1 and shapes
                           and all(k.endswith("x2") for k in shapes)):
            raise AssertionError(f"slo (d): shrink_draft_k ran {shapes} "
                                 f"at adaptive k {adaptive_k.value}")
        if r >= 4 and (l2 != 0 or any(k.startswith("spec")
                                      for k in shapes)):
            raise AssertionError(f"slo (d): K2 launched {l2} times at "
                                 f"rung {r}")
        if r < 4 and l2 <= 0:
            raise AssertionError(f"slo (d): no K2 launch at rung {r}")
        if r == 5:
            try:
                fleet.submit_async(bulk[0], bulk[1], tenant="bulk")
                raise AssertionError("slo (d): bulk admitted at rung 5")
            except AdmissionRejectedError:
                row["bulk_rejected"] = True
        if first is None:
            first = out
        elif len(rows) == 10:
            row["near_ties"] += check_streams(torch, gen, [(out, first)],
                                              near_tie)
        rows.append(row)
    return rows


def slo_exposition(plane, tmpdir):
    """Part (e): /metrics, /query and /alerts over the process registry
    served with the plane's store and engine, on a loopback port; and one
    flight-recorder bundle."""
    import urllib.request
    from deeplearning4j_torch import telemetry
    from deeplearning4j_torch.telemetry.exposition import MetricsServer

    class Scrape:
        """The process registry, served with the plane's store (/query)
        and engine (/alerts)."""

        def __init__(self, reg, tsdb, alerts):
            self._reg, self.tsdb, self.alerts = reg, tsdb, alerts

        def render_prometheus(self):
            return self._reg.render_prometheus()

        def get(self, name):
            return self._reg.get(name)

    reg = telemetry.get_registry()
    plane.tsdb.record(reg)

    def get(base, path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.status, r.read().decode()

    with MetricsServer(Scrape(reg, plane.tsdb, plane.engine),
                       port=0) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        code_m, body = get(base, "/metrics")
        families = {f: f in body for f in (
            "fleet_slo_burn_rate", "fleet_slo_alert_firing",
            "fleet_slo_error_budget_remaining", "fleet_degrade_rung",
            "fleet_autoscale_actions_total",
            "fleet_autoscale_replicas_target")}
        code_q, q = get(base, "/query?series=generation_server_ttft_seconds")
        q = json.loads(q)
        code_a, alerts = get(base, "/alerts")
        state = json.loads(json.dumps(plane.engine.state()))
    points = sum(len(r["points"]) for r in q["results"])
    if not (code_m == code_q == code_a == 200 and all(families.values())
            and q["matched"] >= 1 and points >= 1
            and json.loads(alerts) == state):
        raise AssertionError(f"slo (e): /metrics {code_m} {families}, "
                             f"/query {code_q} {q['matched']} series "
                             f"{points} points, /alerts {code_a} == "
                             f"state: {json.loads(alerts) == state}")
    rec = telemetry.get_flight_recorder()
    rec.install_dump(tmpdir, alerts=plane.engine)
    try:
        from deeplearning4j_torch.telemetry.flightrec import load_bundle
        doc = load_bundle(rec.request_dump("slo smoke"))
    finally:
        rec.uninstall_dump()
    if doc.get("history") is None or not doc["history"]["series"] \
            or doc.get("slo") is None:
        raise AssertionError("slo (e): the bundle's history or slo is null")
    return {"metrics_families": families, "query_series": q["matched"],
            "query_points": points, "alerts_equal_state": True,
            "bundle_history_series": len(doc["history"]["series"]),
            "bundle_slo_alerts": len(doc["slo"]["alerts"])}


def median_ms(fn, n=40):
    xs = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        xs.append((time.perf_counter() - t) * 1e3)
    return sorted(xs)[len(xs) // 2]


def slo_costs(plane, fleet):
    """Part (f), first half: median ms per cycle of each loop's pass at
    the series count the fleet really has, loops stopped.  The ladder's
    and the autoscaler's passes are timed on copies that cannot act (no
    fleet to actuate; one replica at most, no shedding) reading the same
    engine, store and fleet."""
    from deeplearning4j_torch import telemetry
    from deeplearning4j_torch.serving import (AutoscalePolicy, Autoscaler,
                                              DegradeLadder)
    reg = telemetry.get_registry()
    ladder = DegradeLadder(None, plane.engine)
    scaler = Autoscaler(fleet, AutoscalePolicy(
        min_replicas=1, max_replicas=1, queue_wait_p99_target_s=1e9,
        shed_batch=False), tenant_classes=SLO_TENANTS,
        alert_engine=plane.engine)
    return {"series": plane.tsdb.record(reg),
            "registry_series": reg.series_count(),
            "tsdb_record_ms": median_ms(lambda: plane.tsdb.record(reg)),
            "alert_evaluate_ms": median_ms(plane.engine.evaluate),
            "ladder_evaluate_ms": median_ms(ladder.evaluate),
            "autoscaler_evaluate_ms": median_ms(scaler.evaluate)}


def slo_turns(torch, np, net, kw, reqs, cfg):
    """Part (f), second half: phase 6(a)'s requests on one replica with
    no plane and with the whole plane attached at rung 0, in turns off,
    on, on, off.  Returns new tokens/s per turn.  The plane evaluates
    as in part (b) and never acts: one replica at most, and objectives
    that count only past 1e9 events in a window, so no alert can fire
    and the ladder's projection stays uncovered (0).  A high ttft bar
    cannot do that: the histogram's top bucket is 10 s, and a first
    token later than that is bad whatever the bar."""
    from deeplearning4j_torch.serving import ServingFleet
    new_tokens = sum(n for _, n, _ in reqs)
    turns = []
    quiet = dict(cfg, min_events=10 ** 9)
    with ServingFleet(net, n_replicas=1, **kw) as fleet:
        fleet.submit(reqs[0][0], 8, timeout=900)           # warm-up
        for mode in ("off", "on", "on", "off"):
            plane = SloPlane(fleet, quiet, max_replicas=1) \
                if mode == "on" else None
            try:
                t = time.perf_counter()
                hs = [fleet.submit_async(p, n, tenant="chat", sampling=s)
                      for p, n, s in reqs]
                for h in hs:
                    h.result(timeout=900)
                wall = time.perf_counter() - t
                if plane is not None and (plane.ladder.state()["transitions"]
                                          or plane.alert()["transitions"]):
                    raise AssertionError(
                        f"slo (f): the quiet plane acted: ladder "
                        f"{plane.ladder.state()}, alert {plane.alert()}")
            finally:
                if plane is not None:
                    plane.close()
            turns.append({"plane": mode, "seconds": wall,
                          "new_tokens_per_s": new_tokens / wall})
    return turns


def phase_slo(torch, np, pa):
    """The serving SLO control plane on the card, over default-width
    zoo.Gpt() in bf16 (seeded weights), speculative replicas of phase 6's
    config.  (a) the plane attached to a one-replica fleet; (b) a burst
    of 16 chat + 16 bulk requests; (c) recovery with no load; (d) a
    scripted rung walk 0 -> 5 -> 0; (e) exposition and a bundle; (f) the
    plane's per-cycle costs and tokens/s with it off and on, in turns."""
    from deeplearning4j_torch.zoo import Gpt

    net = Gpt(seed=0).init_graph(device="cuda")
    kw = dict(compute_dtype="bfloat16", n_slots=8, max_len=1024,
              block_size=16, tick_batch=8, device="cuda")
    return slo_parts(torch, np, net, kw, pa.paged_decode_attention,
                     pa.paged_verify_attention, 32000, card_line(),
                     SLO_CARD)


def slo_parts(torch, np, net, kw, k1, k2, vocab, card, cfg):
    """Parts (a)-(f) of :func:`phase_slo` on a built net (replica config
    ``kw`` without ``speculative``; the plane's clocks ``cfg``); ``k1``
    and ``k2`` are the kernel wrappers whose ``.launches`` are read."""
    import tempfile
    from deeplearning4j_torch.models.generation import TransformerGenerator
    from deeplearning4j_torch.serving import ServingFleet, TenantQuota

    t_phase = time.perf_counter()
    chat, bulk = slo_requests(np, vocab, kw["max_len"])
    gen = TransformerGenerator(net, compute_dtype=kw["compute_dtype"],
                               device=kw["device"])
    quotas = {t: TenantQuota(klass=c) for t, c in SLO_TENANTS.items()}
    with ServingFleet(net, n_replicas=1, quotas=quotas,
                      speculative=SPEC_FULL, **kw) as fleet:
        fleet.submit(chat[0][0], 8, tenant="chat", timeout=900)  # warm-up
        plane = SloPlane(fleet, cfg)
        try:
            fleet.replica(0).attach_history(plane.tsdb)
            burst, recovery = slo_burst(torch, np, fleet, plane, gen, k1, k2,
                                        chat, bulk, cfg)
            emit({"phase": "slo/burst", **burst, "card": card})
            emit({"phase": "slo/recovery", **recovery, "card": card})
            plane.stop_loops()
            walk_prompt, walk_n = chat[4][0], 32 if kw["max_len"] >= 256 \
                else 8
            walk = slo_walk(torch, np, fleet, plane, gen, k1, k2,
                            walk_prompt, walk_n, bulk[0][:2],
                            cfg["near_tie"])
            emit({"phase": "slo/walk", "rungs": walk, "card": card})
            with tempfile.TemporaryDirectory() as tmp:
                expo = slo_exposition(plane, tmp)
            emit({"phase": "slo/exposition", **expo})
            costs = slo_costs(plane, fleet)
        finally:
            plane.close()
    turns = slo_turns(torch, np, net, kw, chat, cfg)
    emit({"phase": "slo/costs", **costs, "turns": turns,
          "seconds": time.perf_counter() - t_phase, "card": card})
    return burst["launches"]


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


# cuDNN's layout transposes, by kernel name: none should run when every
# convolution's activations and kernels come channels-last
TRANSPOSE_KERNELS = ("nchwToNhwc", "nhwcToNchw")


def kernel_class(name):
    """The class of a device kernel by its name: one of the port's flash
    kernels (K3-K6), a matmul (cuBLAS/CUTLASS), a copy or cast, a
    reduction, another elementwise kernel, or other."""
    if "flash_fwd" in name:
        return "K4" if ", true>" in name else "K3"
    if "flash_bwd_dkdv" in name:
        return "K5"
    if "flash_bwd_dq" in name:
        return "K6"
    if "flash_bwd_plain" in name or "flash_bwd_chunked" in name:
        return "K5+K6 (FMA)"
    low = name.lower()
    if any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul"
    for cls, key in (("copy", "copy"), ("reduce", "reduce"),
                     ("elementwise", "elementwise")):
        if key in low:
            return cls
    return "other"


def step_profile(torch, step):
    """``step()`` (one training step that ends in a host read) under a
    CUDA-only ``torch.profiler`` trace: device time by kernel (top 12),
    by class (``kernel_class``), the device-busy total and cuDNN's
    layout transposes (``TRANSPOSE_KERNELS``) by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, classes, transposes, busy_us, n = {}, {}, {}, 0.0, 0
    for evt in prof.events():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        busy_us += us
        n += 1
        kernels[evt.name[:80]] = kernels.get(evt.name[:80], 0.0) + us
        cls = kernel_class(evt.name)
        classes[cls] = classes.get(cls, 0.0) + us
        if any(t in evt.name for t in TRANSPOSE_KERNELS):
            transposes[evt.name[:80]] = transposes.get(evt.name[:80], 0) + 1
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"profiled_wall_ms": wall * 1e3, "device_ms": busy_us / 1e3,
            "device_events": n,
            "device_busy_share": busy_us / 1e3 / (wall * 1e3),
            "device_ms_by_class": {k: v / 1e3 for k, v in
                                   sorted(classes.items())},
            "device_share_by_class": {k: v / max(busy_us, 1e-9) for k, v
                                      in sorted(classes.items())},
            "layout_transposes_per_step": sum(transposes.values()),
            "layout_transpose_kernels": transposes,
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
        ds = DataSet(*train_batch(np, b, t, 32000, 2))
        row["profile"] = step_profile(torch, lambda: net.fit(ds))
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


# -- phase 7b: resume ----------------------------------------------------
RESUME_B, RESUME_T = 8, 2048
RESUME_BATCHES, RESUME_EPOCHS = 4, 2      # 8 steps
RESUME_PREEMPT = 5                        # preempted after this iteration
RESUME_NAN = (6, 7)                       # part (d)'s bad steps


def resume_batches(np, b, t, vocab, masked=False):
    """``RESUME_BATCHES`` seeded batches of token ids and next-token
    labels; with ``masked`` a float labels mask of ones, the leaf the
    ``nan_loss`` fault site poisons (ids and labels are integers)."""
    from deeplearning4j_torch.data import DataSet
    out = []
    for i in range(RESUME_BATCHES):
        x, y = train_batch(np, b, t, vocab, 20 + i)
        out.append(DataSet(x, y, labels_mask=(
            np.ones((b, t), np.float32) if masked else None)))
    return out


def tree_digest(torch, trees):
    """A fingerprint of every leaf's bits (the int32 words of f32 leaves,
    summed per leaf, weighted by position), computed on the device."""
    from deeplearning4j_torch.utils.trees import iter_leaves
    total = 0
    for i, (_, leaf) in enumerate(iter_leaves(trees)):
        words = leaf.detach().contiguous().view(
            {2: torch.int16, 4: torch.int32, 8: torch.int64}[
                leaf.element_size()])
        total += (i + 1) * int(words.to(torch.int64).sum())
    return f"{total % (1 << 64):016x}"


def tree_diff(torch, got, want):
    """(True iff every leaf is equal bit for bit, the largest over leaves
    of max |got - want| / max |want|)."""
    from deeplearning4j_torch.utils.trees import iter_leaves
    want = dict(iter_leaves(want))
    equal, worst = True, 0.0
    for path, g in iter_leaves(got):
        w = want[path]
        if torch.equal(g, w):
            continue
        equal = False
        worst = max(worst, float((g.float() - w.float()).abs().max())
                    / max(float(w.float().abs().max()), 1e-30))
    return equal, worst


def resume_parts(torch, np, make_net, batches, masked, n_layers, sync, card,
                 root):
    """Parts (a)-(e) of :func:`phase_resume`: ``make_net(seed)`` builds
    the model, ``batches`` / ``masked`` are ``resume_batches``' two sets,
    ``sync`` waits for the device, ``root`` is the checkpoints' scratch
    directory.  Returns the flash launches of (c), the resumed run."""
    from deeplearning4j_torch import resilience, telemetry
    from deeplearning4j_torch.data import ListDataSetIterator
    from deeplearning4j_torch.optimize import CollectScoresListener
    from deeplearning4j_torch.optimize.listeners import TrainingListener
    from deeplearning4j_torch.parallel import CheckpointListener
    from deeplearning4j_torch.resilience import (BadStepPolicy,
                                                 FaultInjector,
                                                 TrainingPreempted)
    from deeplearning4j_torch.utils.trees import iter_leaves
    fa = flash_module()
    reg = telemetry.get_registry()
    n_steps = RESUME_BATCHES * RESUME_EPOCHS

    class StepClock(TrainingListener):
        """The wall clock at each iteration's end, the device drained
        (last among the listeners: a periodic save counts in its step)."""

        def __init__(self):
            self.at = {}

        def iteration_done(self, model, iteration, epoch, loss):
            sync()
            self.at[iteration] = time.perf_counter()

    def fit(net, listeners, data, scores=None, **kw):
        scores = CollectScoresListener() if scores is None else scores
        net.set_listeners(*listeners, scores)
        net.fit(ListDataSetIterator(data), n_epochs=kw.pop(
            "n_epochs", RESUME_EPOCHS), **kw)
        return scores.scores

    def state(net):
        return {"params": net.params_tree, "opt_state": net.opt_state}

    # (a) the uninterrupted window, twice: are two runs equal bit for bit?
    t_phase = time.perf_counter()
    runs = []
    for _ in range(2):
        net = make_net(0)
        runs.append((net, fit(net, [], batches)))
    (net_a, scores_a), (net_a2, scores_a2) = runs
    deterministic, spread = tree_diff(torch, state(net_a2), state(net_a))
    loss_spread = max(abs(x[1] - y[1]) for x, y in zip(scores_a, scores_a2))
    losses_a = [s for _, s in scores_a]
    if not all(math.isfinite(x) for x in losses_a):
        raise AssertionError(f"resume/a: losses {losses_a} not finite")
    row_a = {"losses": losses_a, "digest": tree_digest(torch, state(net_a)),
             "digest_second_run": tree_digest(torch, state(net_a2)),
             "runs_equal_bitwise": deterministic,
             "run_to_run_max_rel_diff": spread,
             "run_to_run_loss_diff": loss_spread}
    del net_a2, runs

    # (b) checkpoint every 2 iterations, keep 2; preempted after 5
    ck_dir = os.path.join(root, "ck")
    net_b = make_net(0)
    ck = CheckpointListener(ck_dir, save_every_n_iterations=2, keep_last=2)
    clock, scores_b = StepClock(), CollectScoresListener()
    p0 = reg.counter("train_preemptions_total").value
    try:
        with FaultInjector([f"preempt@{RESUME_PREEMPT}"]):
            fit(net_b, [ck, clock], batches, scores_b)
        raise AssertionError("resume/b: fit was not preempted")
    except TrainingPreempted as e:
        preempted_at = e.step
    finally:
        resilience.clear_preemption()
    steps_b = ck.ckpt.all_steps()
    forced = dict(ck.ckpt.last_save)
    if preempted_at != RESUME_PREEMPT or steps_b != [4, RESUME_PREEMPT] \
            or reg.counter("train_preemptions_total").value - p0 != 1:
        raise AssertionError(f"resume/b: preempted at {preempted_at}, "
                             f"steps {steps_b} (want 5 and [4, 5])")
    if deterministic and scores_b.scores != scores_a[:RESUME_PREEMPT + 1]:
        raise AssertionError(f"resume/b: losses {scores_b.scores} differ "
                             f"from the uninterrupted {scores_a}")
    walls = {i: clock.at[i] - clock.at[i - 1] for i in range(1, 6)}
    step_bytes = sum(f.stat().st_size for f in os.scandir(
        os.path.join(ck_dir, str(RESUME_PREEMPT))))
    del net_b

    # (c) a fresh model from another seed resumes — the main path: flash
    # launches counted from 0
    net_c = make_net(1)
    ck_c = CheckpointListener(ck_dir, save_every_n_iterations=2,
                              keep_last=2)
    restore = {}
    inner = ck_c.restore_into

    def timed_restore(model):
        t0 = time.perf_counter()
        step = inner(model)
        sync()
        restore["s"] = time.perf_counter() - t0
        return step

    ck_c.restore_into = timed_restore
    fallback0 = fa._ROUTE_XLA_LONG_T.value
    for name in FLASH_WRAPPERS:
        getattr(fa, name).launches = 0
    scores_c = fit(net_c, [ck_c], batches, resume=True)
    sync()
    counts = {name: getattr(fa, name).launches for name in FLASH_WRAPPERS}
    resumed = n_steps - RESUME_PREEMPT - 1
    want = {name: (n_layers * resumed
                   if name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
                   else 0) for name in FLASH_WRAPPERS}
    if counts != want or fa._ROUTE_XLA_LONG_T.value != fallback0:
        raise AssertionError(f"resume/c: launches {counts} != {want} or a "
                             "long-t fallback")
    equal_c, diff_c = tree_diff(torch, state(net_c), state(net_a))
    loss_diff_c = abs(scores_c[-1][1] - losses_a[-1])
    if net_c.iteration_count != n_steps or net_c.epoch_count != \
            RESUME_EPOCHS or [i for i, _ in scores_c] != list(
                range(RESUME_PREEMPT + 1, n_steps)):
        raise AssertionError(f"resume/c: counters {net_c.iteration_count}, "
                             f"{net_c.epoch_count}, scores {scores_c}")
    if deterministic and not (equal_c and loss_diff_c == 0.0):
        raise AssertionError(f"resume/c: the resumed run differs from the "
                             f"uninterrupted one (max rel {diff_c}, loss "
                             f"{loss_diff_c}) where two uninterrupted runs "
                             "are equal bit for bit")
    if not deterministic and (diff_c > 2 * spread
                              or loss_diff_c > 2 * loss_spread):
        raise AssertionError(f"resume/c: max rel {diff_c} / loss "
                             f"{loss_diff_c} past twice the run-to-run "
                             f"spread {spread} / {loss_spread}")
    row_c = {"iteration_count": net_c.iteration_count,
             "losses": [s for _, s in scores_c],
             "digest": tree_digest(torch, state(net_c)),
             "equal_bitwise": equal_c, "max_rel_diff": diff_c,
             "last_loss_diff": loss_diff_c, "launches": counts,
             "launches_per_step": {k: v / resumed for k, v in counts.items()}}
    del net_c, net_a

    # (d) two bad steps (NaN-poisoned labels mask): skip, back off, roll
    # back to the checkpoint of iteration 4, then train on
    class Snap(TrainingListener):
        def __init__(self):
            self.params, self.backoff = {}, {}

        def iteration_done(self, model, iteration, epoch, loss):
            if 4 <= iteration <= RESUME_NAN[1]:
                self.params[iteration] = [
                    t.clone() for _, t in iter_leaves(model.params_tree)]
                self.backoff[iteration] = getattr(model, "_lr_backoff", 1.0)

    net_d = make_net(0)
    ck_d = CheckpointListener(os.path.join(root, "ck_d"),
                              save_every_n_iterations=4, keep_last=2)
    snap = Snap()
    c0 = {c: reg.counter(c).value for c in (
        "bad_steps_skipped_total", "bad_steps_rolled_back_total")}
    with FaultInjector([f"nan_loss@{i}" for i in RESUME_NAN]):
        scores_d = fit(net_d, [ck_d, BadStepPolicy(max_consecutive=2,
                                                   checkpoint=ck_d), snap],
                       masked, n_epochs=RESUME_EPOCHS + 1)
    deltas = {c: reg.counter(c).value - v for c, v in c0.items()}
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    bad, after = RESUME_NAN
    checks = {
        "first_bad_step_params_unchanged": same(snap.params[bad],
                                                snap.params[bad - 1]),
        "backoff_after_first_bad_step": snap.backoff[bad],
        "rolled_back_to_checkpoint_4": same(snap.params[after],
                                            snap.params[4]),
        "moved_between_checkpoint_and_bad_steps": not same(
            snap.params[bad - 1], snap.params[4]),
        "params_on": str(next(iter_leaves(net_d.params_tree))[1].device),
        "losses": [s for _, s in scores_d], "counter_deltas": deltas}
    if not (checks["first_bad_step_params_unchanged"]
            and checks["backoff_after_first_bad_step"] == 0.5
            and checks["rolled_back_to_checkpoint_4"]
            and checks["moved_between_checkpoint_and_bad_steps"]
            and deltas == {"bad_steps_skipped_total": 2,
                           "bad_steps_rolled_back_total": 1}
            and all(math.isfinite(s) == (i not in RESUME_NAN)
                    for i, s in scores_d)):
        raise AssertionError(f"resume/d: {checks}")
    del net_d, snap

    # (e) what a checkpoint costs
    save_walls = [walls[i] for i in (2, 4)]
    plain_walls = [walls[i] for i in (1, 3, 5)]
    emit({"phase": "resume", "steps": n_steps,
          "preempted_at": preempted_at, "checkpoint_steps": steps_b,
          "a_uninterrupted": row_a, "c_resumed": row_c, "d_bad_steps": checks,
          "forced_save_host_copy_ms": forced["host_copy_s"] * 1e3,
          "forced_save_write_ms": forced["write_s"] * 1e3,
          "restore_ms": restore["s"] * 1e3,
          "bytes_per_step": step_bytes,
          "step_ms_with_save": [w * 1e3 for w in save_walls],
          "step_ms_without_save": [w * 1e3 for w in plain_walls],
          "save_step_extra_ms": (sum(save_walls) / len(save_walls)
                                 - sum(plain_walls) / len(plain_walls))
          * 1e3,
          "seconds": time.perf_counter() - t_phase, "card": card})
    return counts


def phase_resume(torch, np):
    """Resumable training on the card: default-width zoo.Gpt() with
    dropout 0.1, bf16 on f32 masters, Adam(3e-4), b 8, t 2048, four
    seeded batches over two epochs (8 steps).  (a) the uninterrupted run,
    twice; (b) with a CheckpointListener (every 2 iterations, keep 2)
    preempted after iteration 5 by the ``preempt`` fault site; (c) a fresh
    Gpt(seed=1) resumes with fit(resume=True) — the main path, K3, K5 and
    K6 counted from 0 — and must equal (a) bit for bit when (a)'s two
    runs are, else within twice their spread; (d) the BadStepPolicy
    through two NaN steps and a rollback; (e) the save, restore and step
    costs.  Returns (c)'s launch counts."""
    import shutil
    import tempfile
    from deeplearning4j_torch.zoo import Gpt
    b, t = RESUME_B, RESUME_T
    root = tempfile.mkdtemp(prefix="dl4j-resume-")
    try:
        return resume_parts(
            torch, np,
            lambda seed: Gpt(seed=seed, dropout=0.1).init_graph(
                device="cuda"),
            resume_batches(np, b, t, 32000),
            resume_batches(np, b, t, 32000, masked=True), 12,
            torch.cuda.synchronize, card_line(), root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# -- phase 7c ----------------------------------------------------------
# the char-RNN main path: dl4j-examples LSTMCharModellingExample's shape
# (minibatch 32, example length 1000, tBPTT 50) at zoo.TextGenerationLSTM's
# full width (2 x 256 GravesLSTM, vocab 77)
RNN_CFG = {"hidden": 256, "n_layers": 2, "seq_length": 1000, "batch": 32,
           "tbptt": 50, "vocab": 77}
RNN_EPOCHS = 2
# pre-port files this round never edits (~86k characters): the corpus,
# for the example's Shakespeare (not in the repo, and no network)
RNN_CORPUS = ("SURVEY.md", "VERDICT.md", "ROOFLINE.md", "SNIPPETS.md",
              "PAPER.md")
# card f32 against CPU f64, each element held to its own size
# (``flash_err``; TF32 off): outputs and the carry after 50 recurrent
# steps, and the loss, within RNN_TOL["fwd"]; one chunk's gradients
# (summed over 32 x 50 positions) and the Adam moments after one fit
# step within RNN_TOL["grad"]; the params after that step as max
# |p_card - p_cpu| / lr within RNN_TOL["adam"]: the first Adam update is
# lr x g / (|g| + 1e-8), whose slope in g peaks at |g| ~ 1e-8, where a
# 1e-9 gradient error moves it by 2.5% of lr (a wrong gradient moves it
# by up to 2).  The CPU's own f32 against its f64 reads 2.5e-7 (fwd),
# 4.9e-6 (grad) and 1.1e-2 (adam) at this width.  The port's LSTM layer
# against torch.nn.LSTM (f32 both, other summation orders, 50 steps)
# within RNN_TOL["yardstick"]: the CPU reads 2.2e-6; a wrong gate order
# reads O(1).
RNN_TOL = {"fwd": 1e-5, "grad": 1e-4, "adam": 5e-2, "yardstick": 1e-4}
PANGRAM_WORDS = ("the", "fox", "dog", "box", "quick", "jugs", "lazy")


def rnn_corpus(root, n_chars=None):
    """(the concatenated ``RNN_CORPUS`` text, its ``RNN_CFG["vocab"]``
    most frequent characters, sorted); ``n_chars`` cuts the text."""
    import collections
    text = "".join(open(os.path.join(root, f), encoding="utf-8").read()
                   for f in RNN_CORPUS)
    top = collections.Counter(text).most_common(RNN_CFG["vocab"])
    return text[:n_chars], sorted(c for c, _ in top)


def rnn_numpy_params(np, net, seed):
    """``net``'s seeded parameters as a numpy tree, with the GravesLSTM
    peepholes and biases drawn non-zero (they start at zero) so that the
    comparisons reach them."""
    from deeplearning4j_torch.utils.trees import iter_leaves, set_path
    rng = np.random.default_rng(seed)
    tree = {}
    for path, leaf in iter_leaves(net.params_tree):
        a = leaf.detach().cpu().numpy()
        if path[-1] in ("P", "b"):
            a = a + rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        set_path(tree, path, a)
    return tree


def rnn_pair(torch, np, conf_fn, params_np, device):
    """(a net on ``device`` in f32, the same net on the CPU in f64), both
    from ``conf_fn()`` with the f32-representable ``params_np``."""
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.utils import load_numpy_params
    from deeplearning4j_torch.utils.trees import map_leaves
    card = load_numpy_params(MultiLayerNetwork(conf_fn()), params_np,
                             device=device)
    conf = conf_fn()
    conf.global_conf.dtype = conf.global_conf.compute_dtype = "float64"
    cpu = load_numpy_params(MultiLayerNetwork(conf), map_leaves(
        lambda a: a.astype(np.float64), params_np), device="cpu")
    return card, cpu


def rnn_err(torch, got, want):
    """``flash_err`` of a card tensor against a CPU f64 one."""
    return flash_err(torch, got.detach().double().cpu(), want)[0]


def rnn_tree_err(torch, got, want):
    """The largest ``rnn_err`` over the leaves of two trees."""
    from deeplearning4j_torch.utils.trees import iter_leaves
    want = dict(iter_leaves(want))
    return max(rnn_err(torch, g, want[p]) for p, g in iter_leaves(got))


def rnn_card_vs_cpu(torch, np, device, cfg):
    """Part (a): the TextGenerationLSTM of ``cfg`` with seeded weights,
    f32 on ``device`` against f64 on the CPU, on one seeded [b, tbptt,
    vocab] one-hot chunk: the output, one chunk's loss and gradients,
    rnn_time_step fed the steps one at a time, a masked batch (lengths
    t/5..t) streamed in two halves with the carry held through the
    padding, and a Bidirectional(GravesLSTM) + SimpleRnn +
    LastTimeStep(GRU) net through output and one fit step."""
    from deeplearning4j_torch.data import DataSet
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf import (Bidirectional, GravesLSTM,
                                              GRU, InputType, LastTimeStep,
                                              NeuralNetConfiguration,
                                              OutputLayer, SimpleRnn)
    from deeplearning4j_torch.optimize.updaters import Adam
    from deeplearning4j_torch.utils.trees import iter_leaves
    from deeplearning4j_torch.zoo import TextGenerationLSTM
    b, t, v, h = cfg["batch"], cfg["tbptt"], cfg["vocab"], cfg["hidden"]
    rng = np.random.default_rng(12)
    eye = np.eye(v, dtype=np.float32)
    ids = rng.integers(0, v, (b, t + 1))
    x, y = eye[ids[:, :-1]], eye[ids[:, 1:]]
    x64, y64 = torch.from_numpy(x).double(), torch.from_numpy(y).double()
    zoo = TextGenerationLSTM(vocab_size=v, hidden=h,
                             n_layers=cfg["n_layers"], tbptt_length=t)
    params = rnn_numpy_params(np, zoo.init_graph(device="cpu"), 5)
    card, cpu = rnn_pair(torch, np, zoo.conf, params, device)
    err = {"output": rnn_err(torch, card.output(x), cpu.output(x64))}
    for net in (card, cpu):
        net._build_solver()
    loss, _, grads = card._solver._loss_and_grads(
        card.params_tree, card.state_tree, card._batch_dict(DataSet(x, y)),
        None)
    loss64, _, grads64 = cpu._solver._loss_and_grads(
        cpu.params_tree, cpu.state_tree,
        {"features": x64, "labels": y64}, None)
    err["loss"] = abs(float(loss) - float(loss64)) / abs(float(loss64))
    err["gradients"] = rnn_tree_err(torch, grads, grads64)
    card.rnn_clear_previous_state()
    stream = torch.stack([card.rnn_time_step(x[:, s]) for s in range(t)], 1)
    err["rnn_time_step"] = rnn_err(torch, stream, cpu.output(x64))

    lengths = rng.integers(max(1, t // 5), t + 1, b)     # 10..50 at t 50
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    m64 = torch.from_numpy(mask).double()
    card.rnn_clear_previous_state()
    half = t // 2
    stream = torch.cat([card.rnn_time_step(x[:, sl], mask[:, sl])
                        for sl in (slice(0, half), slice(half, t))], 1)
    full, state64 = cpu._forward_layers(cpu.params_tree, cpu.state_tree, x64,
                                        False, None, mask=m64)
    err["masked_stream"] = rnn_err(torch, stream, full)
    err["held_carry"] = rnn_tree_err(torch, card._rnn_state_map, {
        k: {n: c for n, c in s.items() if n.startswith("rnn_")}
        for k, s in state64.items()})

    def bidir():
        return (NeuralNetConfiguration.builder().seed(9)
                .updater(Adam(learning_rate=1e-3)).list()
                .layer(Bidirectional(layer=GravesLSTM(n_out=h),
                                     mode="concat"))
                .layer(SimpleRnn(n_out=h))
                .layer(LastTimeStep(layer=GRU(n_out=h)))
                .layer(OutputLayer(n_out=v, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.recurrent(v)).build())

    params = rnn_numpy_params(
        np, MultiLayerNetwork(bidir()).init(device="cpu"), 6)
    card, cpu = rnn_pair(torch, np, bidir, params, device)
    label = eye[ids[:, -1]]
    err["bidirectional_output"] = rnn_err(
        torch, card.output(x, features_mask=mask),
        cpu.output(x64, features_mask=m64))
    fit = card.fit(DataSet(x, label, features_mask=mask))
    fit64 = cpu.fit(DataSet(x64, torch.from_numpy(label).double(),
                            features_mask=m64))
    err["bidirectional_fit_loss"] = abs(fit - fit64) / abs(fit64)
    err["bidirectional_fit_adam_moments"] = rnn_tree_err(
        torch, card.opt_state, cpu.opt_state)
    want = dict(iter_leaves(cpu.params_tree))
    err["bidirectional_fit_params_over_lr"] = max(
        float((p.double().cpu() - want[k]).abs().max()) / 1e-3
        for k, p in iter_leaves(card.params_tree))
    bounds = {"output": "fwd", "loss": "fwd", "gradients": "grad",
              "rnn_time_step": "fwd", "masked_stream": "fwd",
              "held_carry": "fwd", "bidirectional_output": "fwd",
              "bidirectional_fit_loss": "fwd",
              "bidirectional_fit_adam_moments": "grad",
              "bidirectional_fit_params_over_lr": "adam"}
    bad = {k: v for k, v in err.items() if not v <= RNN_TOL[bounds[k]]}
    if bad:
        raise AssertionError(f"rnn/a: card against CPU f64 past "
                             f"{RNN_TOL}: {bad} (all: {err})")
    return {"errors": err, "bounds": {k: RNN_TOL[v]
                                      for k, v in bounds.items()},
            "masked_lengths": [int(n) for n in lengths]}


def rnn_pangrams(torch, np, root, device):
    """Part (b): the checked-in TextGenerationLSTM_pangrams.zip (sha256
    against its manifest) on ``device`` against the CPU: its score on a
    pangram batch, and the sampled string, equal, with a pangram word."""
    import hashlib
    from deeplearning4j_torch.data import CharacterIterator, sample_characters
    from deeplearning4j_torch.utils import restore_model
    path = os.path.join(root, "deeplearning4j_tpu", "zoo", "weights",
                        "TextGenerationLSTM_pangrams.zip")
    with open(path + ".json") as f:
        manifest = json.load(f)
    with open(path, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    if sha != manifest["sha256"]:
        raise AssertionError(f"rnn/b: sha256 {sha} != the manifest's")
    vocab = manifest["vocab"]
    it = CharacterIterator("".join(vocab), seq_length=10, batch=1,
                           valid_chars=vocab)
    ds = next(iter(CharacterIterator(
        "the quick brown fox jumps over the lazy dog. " * 8, seq_length=40,
        batch=4, valid_chars=vocab, seed=0)))
    out = {}
    for name, where in (("card", device), ("cpu", "cpu")):
        net = restore_model(path, device=where)
        t0 = time.perf_counter()
        text = sample_characters(net, it, init="the ", n_chars=40,
                                 temperature=0.3, seed=0)
        out[name] = {"score": net.score(ds), "sample": text,
                     "sample_s": time.perf_counter() - t0}
    card, cpu = out["card"], out["cpu"]
    score_diff = abs(card["score"] - cpu["score"]) / abs(cpu["score"])
    if card["sample"] != cpu["sample"] or score_diff > RNN_TOL["fwd"] \
            or len(card["sample"]) != 44 \
            or not any(w in card["sample"] for w in PANGRAM_WORDS):
        raise AssertionError(f"rnn/b: card {card} against CPU {cpu}")
    return {"sha256": sha, "score": card["score"],
            "score_rel_diff_vs_cpu": score_diff, "sample": card["sample"],
            "sample_equal_to_cpu": True, "sample_s": card["sample_s"]}


def rnn_train(torch, np, device, cfg, text, chars, sync, root):
    """Parts (c) and (d): the TextGenerationLSTM of ``cfg`` trained
    through fit on CharacterIterator(seq_length, batch, seed=1) over
    ``text`` for ``RNN_EPOCHS`` epochs — the main path; then the same run
    with a CheckpointListener every chunks-per-batch iterations, preempted
    after the last chunk of the second epoch's first batch, resumed by a
    fresh model over a fresh iterator (which must draw the second
    epoch's order, not the first's): its params, Adam state and losses
    equal to the first run's bit for bit.
    Returns (the part rows, the first run's net, one chunk)."""
    from deeplearning4j_torch import resilience
    from deeplearning4j_torch.data import CharacterIterator, sample_characters
    from deeplearning4j_torch.optimize import CollectScoresListener
    from deeplearning4j_torch.optimize.listeners import TrainingListener
    from deeplearning4j_torch.parallel import CheckpointListener
    from deeplearning4j_torch.resilience import (FaultInjector,
                                                 TrainingPreempted)
    from deeplearning4j_torch.zoo import TextGenerationLSTM
    chunks = cfg["seq_length"] // cfg["tbptt"]
    zoo = TextGenerationLSTM(vocab_size=len(chars), hidden=cfg["hidden"],
                             n_layers=cfg["n_layers"],
                             tbptt_length=cfg["tbptt"])

    def data():
        return CharacterIterator(text, seq_length=cfg["seq_length"],
                                 batch=cfg["batch"], valid_chars=chars,
                                 seed=1)

    class Probe(TrainingListener):
        """batch_in_epoch and the carry at every iteration; the clock,
        the device drained, after each batch's last chunk."""

        def __init__(self):
            self.batch_in_epoch, self.carry, self.at = [], [], {}

        def iteration_done(self, model, iteration, epoch, loss):
            self.batch_in_epoch.append(model.batch_in_epoch)
            self.carry.append("rnn_h" in model.state_tree["layer_0"])
            if iteration % chunks == chunks - 1:
                sync()
                self.at[iteration] = time.perf_counter()

    def counted_clears(net):
        """Wrap the net's rnn_clear_previous_state to log the iteration
        count at each call."""
        calls, inner = [], net.rnn_clear_previous_state

        def clear():
            calls.append(net.iteration_count)
            inner()
        net.rnn_clear_previous_state = clear
        return calls

    # (c) the main path
    it = data()
    n_batches = ((len(it.data) - 1) // cfg["seq_length"]) // cfg["batch"]
    n_iter = RNN_EPOCHS * n_batches * chunks
    net = zoo.init_graph(device=device)
    probe, scores = Probe(), CollectScoresListener()
    net.set_listeners(probe, scores)
    clears = counted_clears(net)
    if device == "cuda":
        # the peak above what is allocated now: earlier phases' tensors
        # may still be alive
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    sync()
    t0 = time.perf_counter()
    net.fit(it, n_epochs=RNN_EPOCHS)
    sync()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base if device == "cuda"
            else None)
    losses = [s for _, s in scores.scores]
    k = min(10, len(losses) // 2)
    want_bie = [(i % (n_batches * chunks)) // chunks
                + (i % chunks == chunks - 1) for i in range(n_iter)]
    checks = {"iteration_count": net.iteration_count,
              "epoch_count": net.epoch_count,
              "batch_in_epoch_right": probe.batch_in_epoch == want_bie,
              "carry_in_state_every_chunk": all(probe.carry),
              "cleared_at_iterations": list(clears),
              "carry_after_fit": any(n.startswith("rnn_") for s in
                                     net.state_tree.values() for n in s)}
    if not (net.iteration_count == n_iter and len(losses) == n_iter
            and net.epoch_count == RNN_EPOCHS
            and checks["batch_in_epoch_right"]
            and checks["carry_in_state_every_chunk"]
            and clears == [chunks * (i + 1)
                           for i in range(RNN_EPOCHS * n_batches)]
            and not checks["carry_after_fit"]
            and all(math.isfinite(v) for v in losses)
            and sum(losses[-k:]) < sum(losses[:k])):
        raise AssertionError(f"rnn/c: {checks}, losses {losses}")
    first, last = chunks - 1, n_iter - 1
    chunk_s = (probe.at[last] - probe.at[first]) / (last - first)
    t0 = time.perf_counter()
    sample = sample_characters(net, it, init="the ", n_chars=200,
                               temperature=0.8, seed=0)
    sample_s = time.perf_counter() - t0
    if len(sample) != 204 or any(c not in it.char_to_idx for c in sample):
        raise AssertionError(f"rnn/c: sample {sample!r}")
    row_c = {"iterations": n_iter, "batches_per_epoch": n_batches,
             "chunks_per_batch": chunks, "examples_per_batch": cfg["batch"],
             "characters_in_corpus": len(it.data),
             "losses_first": losses[:k], "losses_last": losses[-k:],
             "checks": checks, "fit_wall_s": wall,
             "chunk_ms": chunk_s * 1e3,
             "characters_per_s": cfg["batch"] * cfg["tbptt"] / chunk_s,
             "sample": sample,
             "sample_ms_per_character_b1": sample_s / 200 * 1e3,
             "peak_allocated_bytes_above_start": peak}

    # (d) preempted in the second epoch, resumed by a fresh model
    preempt = (n_batches + 1) * chunks - 1
    ck_dir = os.path.join(root, "ck")
    net_d = zoo.init_graph(device=device)
    pre_scores = CollectScoresListener()
    net_d.set_listeners(CheckpointListener(
        ck_dir, save_every_n_iterations=chunks), pre_scores)
    try:
        with FaultInjector([f"preempt@{preempt}"]):
            net_d.fit(data(), n_epochs=RNN_EPOCHS)
        raise AssertionError("rnn/d: fit was not preempted")
    except TrainingPreempted as e:
        preempted_at = e.step
    finally:
        resilience.clear_preemption()
    del net_d
    net_r = TextGenerationLSTM(
        vocab_size=len(chars), hidden=cfg["hidden"],
        n_layers=cfg["n_layers"], tbptt_length=cfg["tbptt"],
        seed=7).init_graph(device=device)
    ck = CheckpointListener(ck_dir, save_every_n_iterations=chunks)
    res_scores = CollectScoresListener()
    net_r.set_listeners(ck, res_scores)
    net_r.fit(data(), n_epochs=RNN_EPOCHS, resume=True)
    state = lambda n: {"params": n.params_tree, "opt_state": n.opt_state}
    equal, diff = tree_diff(torch, state(net_r), state(net))
    row_d = {"preempted_at": preempted_at,
             "checkpoint_steps": ck.ckpt.all_steps(),
             "losses_before_preemption_equal":
                 pre_scores.scores == scores.scores[:preempt + 1],
             "resumed_losses_equal":
                 res_scores.scores == scores.scores[preempt + 1:],
             "params_and_adam_equal_bitwise": equal, "max_rel_diff": diff,
             "iteration_count": net_r.iteration_count,
             "digest": tree_digest(torch, state(net_r))}
    if not (preempted_at == preempt and equal
            and row_d["losses_before_preemption_equal"]
            and row_d["resumed_losses_equal"]
            and net_r.iteration_count == n_iter):
        raise AssertionError(f"rnn/d: {row_d}")
    del net_r
    # the first chunk of the first batch, for (e)'s profiled step
    chunk = net._batch_dict(net._tbptt_chunks(next(iter(data())),
                                              cfg["tbptt"])[0])
    return row_c, row_d, net, chunk


def rnn_yardstick(torch, device, b, t, h, sync, reps=10):
    """The port's LSTM layer (no peepholes) against ``torch.nn.LSTM`` at
    [b, t, h] -> h, fwd + bwd: the weights carried over (weight_ih = W.T,
    weight_hh = R.T, bias_ih = b, bias_hh = 0; both order the gates i, f,
    g, o), the outputs compared, then each timed over ``reps`` calls
    (host clock, the device drained: the port's loop is host-bound)."""
    from deeplearning4j_torch.nn.conf import LSTM
    ly = LSTM(n_in=h, n_out=h, weight_init="xavier")
    gen = torch.Generator(device=device).manual_seed(3)
    params = {k: v.requires_grad_(True)
              for k, v in ly.init(gen, device=device).items()}
    lib = torch.nn.LSTM(h, h, batch_first=True).to(device)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(params["W"].T)
        lib.weight_hh_l0.copy_(params["R"].T)
        lib.bias_ih_l0.copy_(params["b"])
        lib.bias_hh_l0.zero_()
    x = torch.randn(b, t, h, generator=gen, device=device)
    port = lambda: ly.apply(params, {}, x, compute_dtype=torch.float32)[0]
    library = lambda: lib(x)[0]
    with torch.no_grad():
        err = flash_err(torch, port().double(), library().double())[0]
    if not err <= RNN_TOL["yardstick"]:
        raise AssertionError(f"rnn/e: port LSTM against torch.nn.LSTM "
                             f"{err} > {RNN_TOL['yardstick']}")

    def ms(fn):
        for _ in range(2):
            fn().sum().backward()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn().sum().backward()
        sync()
        return (time.perf_counter() - t0) / reps * 1e3

    port_ms, lib_ms = ms(port), ms(library)
    return {"shape": [b, t, h], "max_err_vs_torch_lstm": err,
            "port_fwd_bwd_ms": port_ms, "torch_lstm_fwd_bwd_ms": lib_ms,
            "port_over_torch_lstm": port_ms / lib_ms}


def rnn_parts(torch, np, device, cfg, text, chars, sync, card, root):
    """Parts (a)-(e) of :func:`phase_rnn` on ``device`` at ``cfg``'s
    widths (``sync`` waits for the device, ``root`` is the checkout, and
    the checkpoints go under a temporary directory).  The device-only
    readings of (e) — a profiled chunk and the peak memory — are taken on
    a card only."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    row = {"phase": "rnn", "config": dict(cfg, vocab=len(chars)),
           "a_card_vs_cpu": rnn_card_vs_cpu(torch, np, device, cfg),
           "b_pangrams": rnn_pangrams(torch, np, root, device)}
    tmp = tempfile.mkdtemp(prefix="dl4j-rnn-")
    try:
        row["c_main_path"], row["d_resume"], net, chunk = rnn_train(
            torch, np, device, cfg, text, chars, sync, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    timings = {"yardstick": rnn_yardstick(torch, device, cfg["batch"],
                                          cfg["tbptt"], cfg["hidden"], sync)}
    if device == "cuda":
        step = lambda: float(net._solver.step(
            net.params_tree, net.opt_state, net.state_tree,
            net.iteration_count, chunk, None)[3])
        step()
        timings["profiled_chunk"] = step_profile(torch, step)
    row["e_timings"] = timings
    row["reduced"] = [
        f"{RNN_EPOCHS} epochs of the corpus (the example trains for many)",
        "corpus: " + ", ".join(RNN_CORPUS) + " (~86k characters) for the "
        "example's Shakespeare, which is not in the repo"]
    row.update(card=card, seconds=time.perf_counter() - t_phase)
    emit(row)
    return row


def phase_rnn(torch, np, root):
    """The recurrent stack on the card (phase 7c).  (a) Card f32 against
    CPU f64 (``RNN_TOL``): the default-width TextGenerationLSTM() with
    seeded weights on one [32, 50, 77] chunk — output, loss and
    gradients, rnn_time_step step by step, a masked batch (lengths 10..50)
    streamed with its carry held — and a Bidirectional(GravesLSTM) +
    SimpleRnn + LastTimeStep(GRU) net through output and one fit step.
    (b) The checked-in TextGenerationLSTM_pangrams.zip: sha256, score and
    sample equal to the CPU's, a pangram word in it.  (c) The main path:
    TextGenerationLSTM() (2 x 256 GravesLSTM, vocab 77, tBPTT 50, Adam
    1e-3, clip 1.0) trained through fit on CharacterIterator(seq_length
    1000, batch 32, seed 1) over ``RNN_CORPUS`` for 2 epochs of 2
    batches (80 chunks), loss falling, the counters and the carry
    clearing checked, then 200 sampled characters.  (d) The same run with
    a CheckpointListener every 20 iterations (after a batch's first
    chunk), preempted after iteration 59 (the last chunk of the second
    epoch's first batch) and resumed by a fresh TextGenerationLSTM(seed=7)
    over a fresh CharacterIterator: params, Adam state and losses equal
    to (c)'s bit for bit.  (e) ms per chunk, characters/s, ms per
    sampled character at b 1, peak memory, a profiled chunk (device busy
    share, launches), and the port's LSTM against torch.nn.LSTM at
    [32, 50, 256] (a yardstick only).  No kernel of the port is on this
    path."""
    text, chars = rnn_corpus(root)
    try:
        return rnn_parts(torch, np, "cuda", RNN_CFG, text, chars,
                         torch.cuda.synchronize, card_line(), root)
    finally:
        torch.cuda.empty_cache()


# -- phase 8 -----------------------------------------------------------
BERT_B, BERT_T, BERT_SEED = 32, 512, 3


def bert_lengths(np, b, t, seed):
    """Each row's valid length, uniform in 64..t from ``seed``: the
    padding of the BERT main path's batch (and of its kernel cases)."""
    return np.random.default_rng(seed).integers(64, t + 1, b)


def bert_batch(np, b, t, vocab, seed):
    """(DataSet, lengths): seeded ids, one-hot labels over 2 classes and
    a [b, t] features mask, 1 on each row's first ``lengths`` tokens."""
    from deeplearning4j_torch.data import DataSet
    rng = np.random.default_rng(seed + 1)
    lens = bert_lengths(np, b, t, seed)
    x = rng.integers(0, vocab, (b, t)).astype(np.int32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    return DataSet(x, y, features_mask=mask), lens


def bert_counts(fa):
    return {name: getattr(fa, name).launches for name in FLASH_WRAPPERS}


def phase_bert(torch, np):
    """BERT-base (zoo.Bert(): 12 x 768, 12 heads of 64, ff 3072, vocab
    30522) trained through MultiLayerNetwork.fit at t 512, where every
    block's attention takes the flash route with the features mask as
    its key bias: the forward K4, the backward K5 then K6 (no dBias: a
    mask's bias needs no gradient).  (a) f32, b 2, row 1 with 300 valid
    tokens: one loss and gradient with use_flash on and off on the same
    params (rtol 1e-3), K4 = K5 = K6 = 12 launches; (b) the main path:
    bf16 compute on f32 master weights, Adam(2e-5), b 32, each row's
    valid length drawn from the seed in 64..512 — a warm-up step, then
    ``TRAIN_STEPS`` counted fit steps (K4 = K5 = K6 = 12 x steps, K3 =
    0, no long-t fallback, the loss finite and falling), tokens/s, MFU,
    peak memory and a profiled step; (c) the data path: tiny_sentiment
    -> build_vocab -> WordPiece -> BertIterator at t 512 (batches of 34
    over the 238 training sentences, 40 over the 80 held out), one epoch
    of fit on Bert(vocab_size=len(vocab)) in bf16, then evaluate on the
    held-out batches, whose confusion matrix must equal the argmax of
    output() counted on the host.  Returns (b)'s launch counts."""
    from deeplearning4j_torch.data import (BertIterator, DataSet,
                                           ListDataSetIterator)
    from deeplearning4j_torch.data import tiny_sentiment as ts
    from deeplearning4j_torch.utils.trees import iter_leaves
    from deeplearning4j_torch.zoo import Bert
    fa = flash_module()
    per_step = {"flash_fwd": 0, "flash_fwd_single": 1, "flash_bwd_dkdv": 1,
                "flash_bwd_dq": 1}

    # (a) f32 parity of the two attention paths inside BERT-base
    t0 = time.perf_counter()
    nets = [Bert(seed=0, seq_len=BERT_T, compute_dtype=None,
                 use_flash=f).init_graph(device="cuda") for f in (True, False)]
    nets[1].params_tree = nets[0].params_tree
    n_layers = len(nets[0].layers) - 3
    batch, _ = bert_batch(np, 2, BERT_T, 30522, 1)
    batch.features_mask[0] = 1.0
    batch.features_mask[1] = (np.arange(BERT_T) < 300).astype(np.float32)
    res, counts = [], []
    fallback0 = fa._ROUTE_XLA_LONG_T.value
    for net in nets:
        net._build_solver()
        for name in FLASH_WRAPPERS:
            getattr(fa, name).launches = 0
        loss, _, grads = net._solver._loss_and_grads(
            net.params_tree, net.state_tree, net._batch_dict(batch), None)
        torch.cuda.synchronize()
        counts.append(bert_counts(fa))
        res.append((float(loss), dict(iter_leaves(grads))))
    want = {k: v * n_layers for k, v in per_step.items()}
    if counts != [want, {k: 0 for k in want}]:
        raise AssertionError(f"bert/f32: launches {counts}, want {want} "
                             "(flash) and none (plain)")
    if fa._ROUTE_XLA_LONG_T.value != fallback0:
        raise AssertionError("bert/f32: long-t fallback")
    loss_err = abs(res[0][0] - res[1][0]) / abs(res[1][0])
    grad_err = max(float((g - res[1][1][p]).abs().max())
                   / max(float(res[1][1][p].abs().max()), 1e-30)
                   for p, g in res[0][1].items())
    if not (loss_err <= 1e-3 and grad_err <= 1e-3):
        raise AssertionError(f"bert/f32: flash vs plain loss error "
                             f"{loss_err}, gradient error {grad_err} > 1e-3")
    emit({"phase": "bert/f32", "b": 2, "t": BERT_T, "valid": [BERT_T, 300],
          "loss_flash": res[0][0], "loss_plain": res[1][0],
          "loss_rel_err": loss_err, "grad_rel_err": grad_err,
          "grad_error": "max over leaves of max |flash - plain| / "
                        "max |plain|", "launches": counts[0],
          "seconds": time.perf_counter() - t0})
    del nets, res, grads
    torch.cuda.empty_cache()

    # (b) the main path: bf16, b 32, t 512, padded rows
    b, t = BERT_B, BERT_T
    model = Bert(seed=0, seq_len=t)
    net = model.init_graph(device="cuda")
    ds, lens = bert_batch(np, b, t, 30522, BERT_SEED)
    net.fit(ds)                                         # warm-up
    torch.cuda.synchronize()
    fallback0 = fa._ROUTE_XLA_LONG_T.value
    for name in FLASH_WRAPPERS:
        getattr(fa, name).launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [net.fit(ds) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cnt = bert_counts(fa)
    peak = torch.cuda.max_memory_allocated()
    fallbacks = fa._ROUTE_XLA_LONG_T.value - fallback0
    want = {k: v * n_layers * TRAIN_STEPS for k, v in per_step.items()}
    if cnt != want:
        raise AssertionError(f"bert/bf16: launches {cnt} != {want}")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"bert/bf16: losses {losses} not finite and "
                             "falling")
    if fallbacks:
        raise AssertionError(f"bert/bf16: {fallbacks} long-t fallbacks")
    tok_s = TRAIN_STEPS * b * t / wall
    row = {"phase": "bert/bf16", "b": b, "t": t, "steps": TRAIN_STEPS,
           "valid_tokens": int(lens.sum()), "valid_lengths": lens.tolist(),
           "losses": losses, "seconds": wall,
           "step_ms": wall * 1e3 / TRAIN_STEPS, "tokens_per_s": tok_s,
           "valid_tokens_per_s": TRAIN_STEPS * int(lens.sum()) / wall,
           "flops_per_token_train": model.flops_per_token_train(),
           "mfu": model.flops_per_token_train() * tok_s / H100_BF16_FLOPS,
           "mfu_basis": "flops_per_token_train() x b*t tokens/s over the "
                        "989 TFLOP/s dense bf16 peak",
           "peak_allocated_bytes": peak, "launches": cnt,
           "flash_fallback_above_threshold": fallbacks,
           "weights": "random (seeded)", "card": card_line()}
    prof = step_profile(torch, lambda: net.fit(ds))
    share = {k: v for k, v in prof["device_share_by_class"].items()
             if k in ("K4", "K5", "K6")}
    prof["flash_share_of_device"] = share
    row["profile"] = prof
    emit(row)
    del net, ds
    torch.cuda.empty_cache()

    # (c) the data path: corpus -> vocab -> WordPiece -> BertIterator
    t0 = time.perf_counter()
    tok = ts.make_tokenizer()
    train, test = ts.train_test_split()
    np.random.default_rng(7).shuffle(train)

    def batches(rows, size):
        out = []
        for mds in BertIterator(tok, rows, size, t):
            ids, mask, _ = mds.features
            out.append(DataSet(ids, np.eye(2, dtype=np.float32)[
                mds.labels[0]], features_mask=mask))
        return out
    train_ds, test_ds = batches(train, 34), batches(test, 40)
    net = Bert(seed=0, seq_len=t, vocab_size=len(tok.vocab)).init_graph(
        device="cuda")
    for name in FLASH_WRAPPERS:
        getattr(fa, name).launches = 0
    loss = net.fit(ListDataSetIterator(train_ds), n_epochs=1)
    ev = net.evaluate(ListDataSetIterator(test_ds))
    torch.cuda.synchronize()
    data_cnt = bert_counts(fa)
    host = np.zeros((2, 2), np.int64)
    for d in test_ds:
        pred = net.output(d.features, features_mask=d.features_mask) \
            .float().cpu().numpy().argmax(-1)
        np.add.at(host, (d.labels.argmax(-1), pred), 1)
    if not np.array_equal(ev.confusion, host) or host.sum() != len(test):
        raise AssertionError(f"bert/data: evaluate's confusion "
                             f"{ev.confusion.tolist()} != output()'s argmax "
                             f"{host.tolist()}")
    if not math.isfinite(loss):
        raise AssertionError(f"bert/data: loss {loss}")
    if data_cnt["flash_fwd_single"] < n_layers * len(train_ds):
        raise AssertionError(f"bert/data: launches {data_cnt}")
    emit({"phase": "bert/data", "vocab": len(tok.vocab), "t": t,
          "train_batches": [len(train_ds), 34],
          "test_batches": [len(test_ds), 40], "last_loss": loss,
          "held_out_accuracy": ev.accuracy(),
          "accuracy_note": "one epoch from random weights: not gated",
          "confusion": ev.confusion.tolist(), "launches": data_cnt,
          "seconds": time.perf_counter() - t0})
    del net
    torch.cuda.empty_cache()
    return cnt


def phase_bert_ops(torch, np):
    """Extra phase ``bertops``: one step of phase 8(b)'s main path (after
    a warm-up step) under a profile of CPU ops AND device kernels, so
    device time is charged to the PyTorch op that launched it: the top
    ops by self device time, with their call counts.  The CPU recording
    slows the host, so only the device times are meaningful."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_torch.zoo import Bert
    net = Bert(seed=0, seq_len=BERT_T).init_graph(device="cuda")
    ds, _ = bert_batch(np, BERT_B, BERT_T, 30522, BERT_SEED)
    net.fit(ds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        net.fit(ds)
        torch.cuda.synchronize()
    # the op rows (CPU side) own their kernels' device time; the kernel
    # rows repeat it
    cpu = torch.autograd.DeviceType.CPU
    ops = [(a.key, a.count, a.self_device_time_total)
           for a in prof.key_averages()
           if a.device_type == cpu and a.self_device_time_total > 0]
    ops.sort(key=lambda o: -o[2])
    emit({"phase": "bertops", "b": BERT_B, "t": BERT_T,
          "self_device_ms_total": sum(o[2] for o in ops) / 1e3,
          "top_ops_by_self_device_ms": [
              {"op": k, "calls": n, "self_device_ms": us / 1e3}
              for k, n, us in ops[:20]],
          "card": card_line()})
    del net
    torch.cuda.empty_cache()


# -- phase 9: resnet ---------------------------------------------------
# the main path's shape: bench.py's bench_resnet50 (b 256, 224 x 224 x 3,
# 1000 classes, four input buffers), five counted steps after a warm-up
RESNET_B, RESNET_HW, RESNET_STEPS, RESNET_BUFFERS = 256, 224, 5, 4
# part (a), card vs CPU on the same f32-representable parameters.  f64:
# the output, the loss, RESNET_GRADS and the batch-norm state, every
# element within 1e-7 of flash_err's measure, |card - cpu| / (|cpu| +
# RMS(cpu)).  f32 with TF32 off: the output, the loss and the batch-norm
# state within 1e-3.  The f32 gradients are ill-conditioned at random
# init in the JAX package itself (its f32 reads ~5e-2 normwise from its
# own f64 below the head: tests/test_torch_zoo_cnn.py), so they are held
# to the CPU's f64: the card's normwise error at most
# RESNET_F32_GRAD_RATIO x the CPU f32's own (floor 1e-4).  cuDNN runs f64
# convolutions in contiguous NCHW, so the main path's channels-last
# layout is also held alone: every distinct convolution and pooling of
# the network, at its input's shape on seeded normal data, card f32 (TF32
# off) against CPU f64 within RESNET_LAYER_TOL of each tensor's largest
# element (output, input and parameter gradients).
RESNET_F32_TOL, RESNET_F64_TOL, RESNET_LAYER_TOL = 1e-3, 1e-7, 1e-4
RESNET_F32_GRAD_RATIO = 4.0
# the stem, a strided 1x1 projection, a batch-norm gamma mid-network, the
# head
RESNET_GRADS = (("conv1", "W"), ("s3b0_sc", "W"), ("s4b2_b_bn", "gamma"),
                ("output", "W"))
# the reference's accuracy gates on the synthetic test splits
# (tests/test_pretrained_weights.py)
LENET_GATE, SIMPLE_CNN_GATE = 0.97, 0.9
# a profiled step's device time is charged to these classes: the layer
# (or updater) whose forward, or whose backward node, launched a kernel;
# copies and cuDNN's layout transposes by the op or kernel name
SCOPED_LAYERS = {"ConvolutionLayer": "convolution",
                 "BatchNormalization": "batch_norm",
                 "SubsamplingLayer": "pooling",
                 "GlobalPoolingLayer": "pooling",
                 "ActivationLayer": "elementwise",
                 "ZeroPaddingLayer": "elementwise",
                 "OutputLayer": "head_and_loss"}
COPY_OPS = ("aten::copy_", "aten::_to_copy", "aten::clone",
            "aten::contiguous")
def op_kernels(evt):
    """[(kernel name, device us)] a profiled CPU op launched itself."""
    return [(k.name, k.duration) for k in getattr(evt, "kernels", [])]


def charge_device_time(torch, events):
    """{class: device us} of a CPU + CUDA profile whose step ran under
    the ``smoke/`` scopes of :func:`scoped_step`: each kernel goes to
    the innermost scope above the op that launched it; a backward op
    goes, through its autograd node's sequence number, to the scope of
    the forward op that made the node; ops in the step outside the
    forward and backward are the updater's."""
    cpu = torch.autograd.DeviceType.CPU
    fwd_by_seq = {}
    for e in events:
        if e.device_type == cpu and getattr(e, "sequence_nr", -1) >= 0 \
                and not e.name.startswith("autograd::"):
            fwd_by_seq.setdefault((e.sequence_nr, e.thread), e)

    def scope(e, depth=0):
        while e is not None:
            if e.name.startswith("smoke/"):
                return {"smoke/fwd_bwd": "head_and_loss",
                        "smoke/step": "updater"}.get(e.name, e.name[6:])
            if e.name.startswith("autograd::engine::evaluate_function") \
                    and e.sequence_nr >= 0 and depth < 4:
                fwd = fwd_by_seq.get((e.sequence_nr, e.fwd_thread))
                return scope(fwd, depth + 1) if fwd is not None \
                    else "backward_unattributed"
            e = e.cpu_parent
        return "other"

    out = {}
    for e in events:
        if e.device_type != cpu:
            continue
        ks = op_kernels(e)
        if not ks:
            continue
        cls = "copies" if e.name in COPY_OPS else scope(e)
        for name, us in ks:
            c = ("layout_transposes"
                 if any(t in name for t in TRANSPOSE_KERNELS) else cls)
            out[c] = out.get(c, 0.0) + us
    return out


def scoped_step(torch, fn):
    """``fn()`` with every layer's forward under a ``smoke/<class>``
    record_function scope (``SCOPED_LAYERS``, ElementWiseVertex as
    elementwise), the solver's forward + backward under
    ``smoke/fwd_bwd`` and its step under ``smoke/step``; the methods
    are restored after."""
    from torch.profiler import record_function

    from deeplearning4j_torch.nn.conf import graph_vertices, layers_conv
    from deeplearning4j_torch.nn.conf import layers_core
    from deeplearning4j_torch.optimize.solver import Solver
    targets = [(getattr(layers_conv, n, None) or getattr(layers_core, n),
                "apply", "smoke/" + c) for n, c in SCOPED_LAYERS.items()]
    targets += [(layers_core.OutputLayer, "pre_output",
                 "smoke/head_and_loss"),
                (graph_vertices.ElementWiseVertex, "apply",
                 "smoke/elementwise"),
                (Solver, "_loss_and_grads", "smoke/fwd_bwd"),
                (Solver, "step", "smoke/step")]
    saved = [(cls, attr, cls.__dict__[attr]) for cls, attr, _ in targets
             if attr in cls.__dict__]

    def wrap(f, label):
        def scoped(*a, **k):
            with record_function(label):
                return f(*a, **k)
        return scoped
    for cls, attr, label in targets:
        setattr(cls, attr, wrap(getattr(cls, attr), label))
    try:
        return fn()
    finally:
        for cls, attr, _ in targets:
            if attr in cls.__dict__:
                delattr(cls, attr)
        for cls, attr, f in saved:
            setattr(cls, attr, f)


def resnet_profiles(torch, step, st, x, y):
    """Two profiled compiled steps: ``step_profile``'s CUDA-only one and
    a CPU + CUDA one whose device time ``charge_device_time`` splits by
    class in place of ``kernel_class``'s (the CPU recording slows the
    host; only its device times are read)."""
    from torch.profiler import ProfilerActivity, profile

    box = [st]

    def one():
        box[0], loss = step(box[0], x, y)
        return float(loss)
    prof = step_profile(torch, one)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof2:
        scoped_step(torch, one)
    by_class = charge_device_time(torch, prof2.events())
    charged = sum(by_class.values())
    prof["device_ms_by_class"] = {k: v / 1e3 for k, v in
                                  sorted(by_class.items())}
    prof["device_share_by_class"] = {k: v / max(charged, 1e-9) for k, v in
                                     sorted(by_class.items())}
    prof["by_class_basis"] = ("a second step under a CPU + CUDA profile: "
                              "each kernel charged to the layer (forward, "
                              "or the backward node's forward op) or the "
                              "updater that launched it")
    return box[0], prof


def bn_moved(torch, state):
    """True iff every batch-norm's running mean and variance moved from
    their initial zeros and ones."""
    bns = [s for s in state.values() if "mean" in s]
    return bool(bns) and all(
        bool(s["mean"].abs().sum() > 0) and bool((s["var"] - 1).abs().sum()
                                                  > 0) for s in bns)


def cnn_eval(torch, np, net, batches, n_classes=10):
    """(evaluate's accuracy, its confusion, the confusion of output()'s
    argmax counted on the host) over ``batches``."""
    from deeplearning4j_torch.data import ListDataSetIterator
    ev = net.evaluate(ListDataSetIterator(batches))
    host = np.zeros((n_classes, n_classes), np.int64)
    for d in batches:
        pred = net.output(d.features).float().cpu().numpy().argmax(-1)
        np.add.at(host, (d.labels.argmax(-1), pred), 1)
    return ev.accuracy(), ev.confusion, host


def resnet_pass(torch, params, x, y, hw, dtype, device):
    """Full-width ResNet-50 with the numpy ``params`` cast to ``dtype``
    on ``device``: {"output": the inference output, "loss",
    "grad/<vertex>/<leaf>": ``RESNET_GRADS``, "state/<vertex>/<k>":
    every batch-norm's state} of one training forward and backward on
    (x, y), each on the CPU."""
    from deeplearning4j_torch.data import DataSet
    from deeplearning4j_torch.models.computation_graph import ComputationGraph
    from deeplearning4j_torch.utils.convert import load_numpy_params
    from deeplearning4j_torch.utils.trees import map_leaves
    from deeplearning4j_torch.zoo import ResNet50
    conf = ResNet50(input_shape=(hw, hw, 3), compute_dtype=dtype).conf()
    conf.global_conf.dtype = dtype
    net = load_numpy_params(ComputationGraph(conf), map_leaves(
        lambda a: a.astype(dtype), params), device=device)
    net._build_solver()
    loss, state, grads = net._solver._loss_and_grads(
        net.params_tree, net.state_tree, net._batch_dict(DataSet(x, y)),
        None)
    out = {"output": net.output(x).cpu(), "loss": loss.detach().cpu()
           .reshape(1)}
    out.update({f"grad/{v}/{k}": grads[v][k].detach().cpu()
                for v, k in RESNET_GRADS})
    out.update({f"state/{v}/{k}": t.cpu() for v, st in state.items()
                if "mean" in st for k, t in st.items()})
    return out


class contiguous_convs:
    """A context in which the port's convolutions and poolings take
    contiguous NCHW activations and OIHW kernels on the card too (as on
    the CPU), in place of the main path's channels-last ones."""

    def __enter__(self):
        from deeplearning4j_torch.nn.conf import layers_conv as lc
        self.saved = lc._nchw, lc._oihw
        lc._nchw = lambda x: x.permute(0, 3, 1, 2).contiguous()
        lc._oihw = lambda w, dtype: (w.to(dtype).permute(3, 2, 0, 1)
                                     .contiguous())

    def __exit__(self, *exc):
        from deeplearning4j_torch.nn.conf import layers_conv as lc
        lc._nchw, lc._oihw = self.saved


class pinned_decisions:
    """A context in which the port's ReLUs and max poolings record each
    call's decision in call order (the ReLU's z > 0, the pool's argmax
    per window), or, given ``replay`` (another instance after its run),
    take that run's decisions in place of their own.  Replayed, a
    network computes the same piecewise-linear branch as the recorded
    run, so the two differ by their arithmetic alone.  Max pooling
    without padding only."""

    def __init__(self, replay=None):
        self.replay = replay
        self.record = []

    def _decide(self, kind, make):
        if self.replay is None:
            d = make()
        else:
            k, d = self.replay.record[len(self.record)]
            if k != kind:
                raise AssertionError(f"pinned_decisions: {kind} where the "
                                     f"recorded run had {k}")
        self.record.append((kind, d))
        return d

    def flips(self, other):
        """{kind: [decisions that differ from ``other``'s, decisions]}."""
        out = {}
        for (kind, a), (_, b) in zip(self.record, other.record):
            n = out.setdefault(kind, [0, 0])
            n[0] += int((a.cpu() != b.cpu()).sum())
            n[1] += a.numel()
        return out

    def __enter__(self):
        import torch.nn.functional as F

        from deeplearning4j_torch.nn.conf import layers_conv as lc
        from deeplearning4j_torch.nn.conf import layers_core
        self.saved = lc.get_activation, lc.pool2d
        act, pool = self.saved

        def get_activation(name):
            f = act(name)
            if name != "relu":
                return f

            def relu(z):
                m = self._decide("relu", lambda: (z > 0).detach())
                return f(z) if self.replay is None else z * m.to(
                    z.device, z.dtype)
            return relu

        def pool2d(x, pooling_type, window, strides, pad, dilation=(1,) * 4,
                   pnorm=2):
            if str(pooling_type).lower() != "max":
                return pool(x, pooling_type, window, strides, pad, dilation,
                            pnorm)
            kernel, stride, dil = ((int(v[1]), int(v[2]))
                                   for v in (window, strides, dilation))
            xn = lc._nchw(x)
            idx = self._decide("max_pool", lambda: F.max_pool2d(
                xn.detach(), kernel, stride, 0, dil, return_indices=True)[1])
            if self.replay is None:
                y = pool(x, pooling_type, window, strides, pad, dilation,
                         pnorm)
                if tuple(y.shape[1:3]) != tuple(idx.shape[2:]):
                    raise AssertionError("pinned_decisions: a padded max "
                                         "pooling")
                return y
            idx = idx.to(x.device)
            return xn.flatten(2).gather(2, idx.flatten(2)).view(
                idx.shape).permute(0, 2, 3, 1)
        lc.get_activation = layers_core.get_activation = get_activation
        lc.pool2d = pool2d
        return self

    def __exit__(self, *exc):
        from deeplearning4j_torch.nn.conf import layers_conv as lc
        from deeplearning4j_torch.nn.conf import layers_core
        lc.get_activation = layers_core.get_activation = self.saved[0]
        lc.pool2d = self.saved[1]


def layer_cases(net, x, classes):
    """{key: (layer, its params)} of every distinct layer whose type is
    one of ``classes`` (kind, configuration and input shape) in ``net``'s
    inference forward of ``x``, each with the input shape it met as
    ``key[-1]``."""
    import dataclasses
    cases, saved = {}, {}
    for cls in classes:
        saved[cls] = cls.__dict__["apply"]

        def seen(ly, p, xin, *a, _f=saved[cls], **k):
            if type(ly) in classes:
                fields = tuple((f.name, repr(getattr(ly, f.name)))
                               for f in dataclasses.fields(ly)
                               if f.name != "name")
                cases.setdefault(
                    (type(ly).__name__, fields, tuple(xin.shape)), (ly, p))
            return _f(ly, p, xin, *a, **k)
        cls.apply = seen
    try:
        net.output(x)
    finally:
        for cls, f in saved.items():
            cls.apply = f
    return cases


def resnet_layer_cases(torch, params, x, hw, device):
    """``layer_cases`` of every convolution and pooling in ResNet-50's
    f32 inference forward of ``x`` on ``device``."""
    from deeplearning4j_torch.nn.conf import layers_conv as lc
    from deeplearning4j_torch.models.computation_graph import ComputationGraph
    from deeplearning4j_torch.utils.convert import load_numpy_params
    from deeplearning4j_torch.utils.trees import map_leaves
    from deeplearning4j_torch.zoo import ResNet50
    conf = ResNet50(input_shape=(hw, hw, 3), compute_dtype="float32").conf()
    net = load_numpy_params(ComputationGraph(conf), map_leaves(
        lambda a: a.astype("float32"), params), device=device)
    return layer_cases(net, x, (lc.ConvolutionLayer, lc.SubsamplingLayer))


def layer_errors(torch, cases, device, linear=False):
    """{"<kind> <kernel>/<stride> <input shape>": error} of every case of
    ``cases`` (``layer_cases``), alone on seeded normal data at its
    input's shape: on ``device`` in f32, in the main path's layout,
    against the CPU in f64 — the largest of max |card - cpu| / max |cpu|
    over the output and the gradients of the input and every parameter
    under one seeded output gradient.  ``linear``: each layer with its
    activation replaced by the identity, so the check reads the
    arithmetic alone (no ReLU decision at a near-zero input)."""
    import dataclasses
    errs = {}
    for i, ((kind, fields, shape), (ly, p)) in enumerate(cases.items()):
        if linear and getattr(ly, "activation", None):
            ly = dataclasses.replace(ly, activation="identity")
        g = torch.Generator().manual_seed(i)
        x0 = torch.randn(shape, generator=g, dtype=torch.float64)
        dy = None
        res = []
        for dev, dt in ((device, torch.float32), ("cpu", torch.float64)):
            xi = x0.to(dev, dt).requires_grad_()
            pi = {k: v.detach().to(dev, dt).requires_grad_()
                  for k, v in p.items()}
            yi = ly.apply(pi, xi)
            if dy is None:
                dy = torch.randn(yi.shape, generator=g, dtype=torch.float64)
            res.append([yi] + list(torch.autograd.grad(
                yi, [xi] + list(pi.values()), dy.to(dev, dt))))
        f = dict(fields)
        name = (f"{kind} {f.get('kernel_size', '-')}/{f.get('stride', '-')} "
                f"{'x'.join(map(str, shape))}")
        errs[name] = max(float((a.double().cpu() - r).abs().max())
                         / max(float(r.abs().max()), 1e-300)
                         for a, r in zip(*(map(torch.Tensor.detach, t)
                                           for t in res)))
    return errs


def resnet_card_vs_cpu(torch, np, hw, device):
    """Part (a) of the resnet phase at ``hw`` x ``hw``, b 2: (its row,
    {check: error} of the checks over their limits).  Seeded
    f32-representable parameters run through ``resnet_pass`` on the card
    and on the CPU in f64 and f32, and on the card in f32 once more under
    ``contiguous_convs``; then ``layer_errors``.  TF32 is off for
    its duration and restored after."""
    from deeplearning4j_torch.models.computation_graph import ComputationGraph
    from deeplearning4j_torch.utils.trees import map_leaves
    from deeplearning4j_torch.zoo import ResNet50
    t0 = time.perf_counter()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        conf = ResNet50(input_shape=(hw, hw, 3),
                        compute_dtype="float32").conf()
        params = map_leaves(lambda t: t.numpy(), ComputationGraph(conf)
                            .init(device="cpu").params_tree)
        rng = np.random.default_rng(1)
        x = rng.normal(size=(2, hw, hw, 3)).astype(np.float32)
        y = np.eye(1000, dtype=np.float32)[[17, 503]]
        runs = {(dev, dt): resnet_pass(torch, params, x, y, hw, dt, d)
                for dev, d in (("card", device), ("cpu", "cpu"))
                for dt in ("float64", "float32")}
        with contiguous_convs():
            runs["card_nchw", "float32"] = resnet_pass(
                torch, params, x, y, hw, "float32", device)
        layers = layer_errors(torch, resnet_layer_cases(
            torch, params, x, hw, device), device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    ref = runs["cpu", "float64"]

    def errs(run, base, keys):
        # flash_err per tensor, the batch-norm states folded into one max
        out = {}
        for k in keys:
            name = "bn_state" if k.startswith("state/") else k
            out[name] = max(out.get(name, 0.0),
                            flash_err(torch, run[k], base[k])[0])
        return out
    f64 = errs(runs["card", "float64"], ref, ref)
    f32 = errs(runs["card", "float32"], runs["cpu", "float32"],
               [k for k in ref if not k.startswith("grad/")])
    grads = {k: {who: float((runs[who, "float32"][k].double() - ref[k])
                            .norm() / ref[k].norm())
                 for who in ("card", "card_nchw", "cpu")}
             for k in ref if k.startswith("grad/")}
    bad = {f"float64/{k}": e for k, e in f64.items()
           if not (math.isfinite(e) and e <= RESNET_F64_TOL)}
    bad.update({f"float32/{k}": e for k, e in f32.items()
                if not (math.isfinite(e) and e <= RESNET_F32_TOL)})
    bad.update({f"float32/{k}": e for k, e in grads.items()
                if not (math.isfinite(e["card"]) and e["card"] <=
                        RESNET_F32_GRAD_RATIO * max(e["cpu"], 1e-4))})
    bad.update({f"layer/{k}": e for k, e in layers.items()
                if not (math.isfinite(e) and e <= RESNET_LAYER_TOL)})
    row = {"phase": "resnet/card_vs_cpu", "b": 2, "hw": hw, "classes": 1000,
           "float64": {"err": f64, "tol": RESNET_F64_TOL,
                       "measure": "flash_err: max |card - cpu| / (|cpu| + "
                                  "RMS(cpu)), card and CPU in f64"},
           "float32": {"err": f32, "tol": RESNET_F32_TOL,
                       "measure": "flash_err, card f32 vs CPU f32"},
           "float32_grads": {
               "err": grads, "ratio_limit": RESNET_F32_GRAD_RATIO,
               "measure": "||g32 - g64_cpu|| / ||g64_cpu||: card "
                          "(channels-last), card_nchw (contiguous NCHW) "
                          "and cpu in f32; gate card <= ratio_limit x "
                          "max(cpu, 1e-4)"},
           "layers": {"err": layers, "tol": RESNET_LAYER_TOL,
                      "measure": "card f32 (channels-last) vs CPU f64, "
                                 "max |d| / max |cpu| over output, input "
                                 "and parameter gradients"},
           "tf32": "off for this part (cudnn.allow_tf32 and "
                   "matmul.allow_tf32 False), restored after",
           "seconds": time.perf_counter() - t0}
    return row, bad


def phase_resnet(torch, np, root, device="cuda"):
    """ResNet-50 (zoo.ResNet50(): 224 x 224 x 3, 1000 classes, bottleneck
    stages [3, 4, 6, 3], 25,583,592 parameters + 53,120 batch-norm
    statistics, seeded random weights) trained through ComputationGraph
    on the card.  (a) b 2, the same f32-representable parameters on the
    card and on the CPU (``resnet_pass``): in f64 the output, the loss,
    ``RESNET_GRADS`` and every batch-norm's state after one training
    forward within ``RESNET_F64_TOL``; in f32 with TF32 off the output,
    the loss and the state within ``RESNET_F32_TOL``, and the gradients,
    on the main path's channels-last layout and on contiguous NCHW,
    against the CPU's f64 (within ``RESNET_F32_GRAD_RATIO`` x the CPU
    f32's own distance); and every distinct convolution and pooling alone
    in f32 channels-last against the CPU in f64 (``RESNET_LAYER_TOL``);
    (b) the main path: bf16 compute on f32 master weights, AdaDelta,
    b 256 over four seeded input buffers, a warm-up then
    ``RESNET_STEPS`` counted ``compiled_train_step`` steps on buffers 0,
    1, 2, 3, 0, then one ``fit`` step on buffer 0 — losses finite, the
    first counted step's loss (buffer 0 after one update) below the
    warm-up's, batch-norm statistics moved; images/s, step ms, MFU, peak
    memory and two profiled steps; (c) the data path: the checked-in
    LeNet and SimpleCNN restored on the card and evaluated on the
    synthetic test splits (> 0.97, > 0.9; confusion == host argmax of
    output()), then one epoch of a fresh LeNet's fit on 2,048 synthetic
    training examples with a finite, falling loss.  ``device`` is the
    card; the CPU only in a rehearsal at a small size."""
    from deeplearning4j_torch.data import (Cifar10DataSetIterator, DataSet,
                                           ListDataSetIterator,
                                           MnistDataSetIterator)
    from deeplearning4j_torch.optimize.listeners import CollectScoresListener
    from deeplearning4j_torch.utils.model_serializer import restore_model
    from deeplearning4j_torch.zoo import LeNet, ResNet50
    hw = RESNET_HW

    # (a) the card against the CPU, f64 and f32 (TF32 off), whole
    # network and layer by layer
    row, bad = resnet_card_vs_cpu(torch, np, hw, device)
    emit(row)
    if bad:
        raise AssertionError(f"resnet/card_vs_cpu: over the limits: {bad}")
    torch.cuda.empty_cache()

    # (b) the main path: bf16, b 256, compiled_train_step then fit
    model = ResNet50(input_shape=(hw, hw, 3))
    net = model.init_graph(device=device)
    step = net.compiled_train_step()
    b, cut = RESNET_B, None
    while True:
        gen = torch.Generator(device=device).manual_seed(0)
        xs = [torch.randn((b, hw, hw, 3), generator=gen, device=device,
                          dtype=torch.float32).to(torch.bfloat16)
              for _ in range(RESNET_BUFFERS)]
        y = np.eye(1000, dtype=np.float32)[
            np.random.default_rng(0).integers(0, 1000, b)]
        st = step.init()
        torch.cuda.reset_peak_memory_stats()
        try:
            st, loss = step(st, xs[0], y)              # warm-up
            warm = float(loss)
            break
        except torch.cuda.OutOfMemoryError:
            if b <= RESNET_B // 8:
                raise
        # out of memory: say so, halve the batch and start again
        del xs, st
        torch.cuda.empty_cache()
        cut = {"from": RESNET_B, "to": b // 2,
               "why": "out of device memory at b " + str(b)}
        emit({"phase": "resnet/bf16", "batch_cut": cut})
        b //= 2
    losses = []
    t0 = time.perf_counter()
    for i in range(RESNET_STEPS):
        # buffers 0, 1, 2, 3, 0: the first counted step reads the warm-up's
        # buffer after one update
        st, loss = step(st, xs[i % RESNET_BUFFERS], y)
        losses.append(float(loss))                     # a host read
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    # AdaDelta at its defaults moves every weight by up to ~4.5e-3 at its
    # first update: the loss on the updated buffer falls, and on fresh
    # buffers it overshoots, in the JAX package as here
    # (test_resnet50_adadelta_trajectory_matches_jax_in_f64), so the
    # gate is the first update's fall on its own buffer
    if not (all(math.isfinite(v) for v in [warm] + losses)
            and losses[0] < warm):
        raise AssertionError(f"resnet/bf16: losses {[warm] + losses} not "
                             "finite, or one update did not lower the "
                             "loss on its own buffer")
    if not bn_moved(torch, st.model_state):
        raise AssertionError("resnet/bf16: batch-norm statistics did not "
                             "move")
    fit_loss = net.fit(DataSet(xs[0], y))
    torch.cuda.synchronize()
    if not (math.isfinite(fit_loss) and bn_moved(torch, net.state_tree)):
        raise AssertionError(f"resnet/bf16: fit loss {fit_loss} or its "
                             "batch-norm statistics")
    img_s = RESNET_STEPS * b / wall
    flops = model.flops_per_image_train()
    row = {"phase": "resnet/bf16", "b": b, "hw": hw, "classes": 1000,
           "batch_cut": cut, "steps": RESNET_STEPS,
           "input_buffers": RESNET_BUFFERS, "updater": "AdaDelta",
           "warmup_loss": warm, "losses": losses, "fit_loss": fit_loss,
           "gate": "finite, and the first counted step (the warm-up's "
                   "buffer after one update) below the warm-up's loss",
           "buffers": [0] + [i % RESNET_BUFFERS for i in
                             range(RESNET_STEPS)],
           "last_below_first": losses[-1] < losses[0],
           "seconds": wall, "step_ms": wall * 1e3 / RESNET_STEPS,
           "images_per_s": img_s, "flops_per_image_train": flops,
           "mfu": flops * img_s / H100_BF16_FLOPS,
           "mfu_basis": "conv + dense multiply-adds x 2 flops x 3 (a "
                        "training step) per image, x images/s, over the "
                        "989 TFLOP/s dense bf16 peak",
           "peak_allocated_bytes": peak, "weights": "random (seeded)",
           "card": card_line()}
    st, row["profile"] = resnet_profiles(torch, step, st, xs[1], y)
    emit(row)
    del net, st, step, xs
    torch.cuda.empty_cache()

    # (c) the data path on the checked-in weights, then a LeNet epoch
    t0 = time.perf_counter()
    wdir = os.path.join(root, "deeplearning4j_tpu", "zoo", "weights")
    out = {"phase": "resnet/data"}
    for name, zipname, gate, it in (
            ("lenet", "LeNet_mnist.zip", LENET_GATE,
             MnistDataSetIterator(256, n_examples=2000, train=False)),
            ("simple_cnn", "SimpleCNN_cifar10-synthetic.zip",
             SIMPLE_CNN_GATE,
             Cifar10DataSetIterator(256, train=False, n_examples=1000,
                                    seed=11))):
        if not it.is_synthetic:
            raise AssertionError(f"resnet/data: {name} did not read the "
                                 "synthetic set")
        net = restore_model(os.path.join(wdir, zipname), device=device)
        shape = tuple(net.conf.input_type.shape)
        batches = [DataSet(d.features.reshape((-1,) + shape), d.labels)
                   for d in it]
        acc, conf, host = cnn_eval(torch, np, net, batches)
        if not np.array_equal(conf, host):
            raise AssertionError(f"resnet/data: {name} evaluate's "
                                 f"confusion != output()'s argmax")
        if not acc > gate:
            raise AssertionError(f"resnet/data: {name} accuracy {acc} <= "
                                 f"{gate}")
        out[name] = {"accuracy": acc, "gate": gate,
                     "examples": int(host.sum()),
                     "confusion_equals_output_argmax": True}
    net = LeNet().init_graph(device=device)
    scores = CollectScoresListener()
    net.set_listeners(scores)
    it = MnistDataSetIterator(256, n_examples=2048, train=True)
    net.fit(ListDataSetIterator([
        DataSet(d.features.reshape(-1, 28, 28, 1), d.labels) for d in it]))
    fit = [s for _, s in scores.scores]
    if not (len(fit) == 8 and all(math.isfinite(v) for v in fit)
            and fit[-1] < fit[0]):
        raise AssertionError(f"resnet/data: LeNet epoch losses {fit}")
    out["lenet_epoch"] = {"examples": 2048, "batches": len(fit),
                          "losses": fit, "updater": "AdaDelta"}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    del net
    torch.cuda.empty_cache()
    return row


# -- phase 9b (infer) --------------------------------------------------
# The infer phase's sizes (the CPU rehearsal passes smaller ones): VGG16
# at its published 224 x 224 x 3 / 1000 classes; the fine-tune of
# dl4j-examples' EditLastLayerOthersFrozen (b 16, 10 steps, 5 classes);
# ParallelInference with 8 callers x 16 single images; QuantizedInference
# on 64 images; every other zoo CNN at its default input ({} kwargs); and
# a sequence classifier at BERT-base's attention width (12 x 64) on the
# flash route, b 32 at t 512 (masked, K4) and t 1024 (unmasked, K3).
INFER_CFG = {"vgg_b": 2, "tl_b": 16, "tl_steps": 10, "tl_classes": 5,
             "pi_threads": 8, "pi_requests": 16, "pi_batch_limit": 32,
             "pi_queue_limit": 64, "q_images": 64, "zoo_b": 2,
             "zoo_kwargs": {}, "attn_b": 32, "attn_t": 512,
             "attn_t_long": 1024, "attn_heads": 12, "attn_head": 64,
             "attn_steps": 5, "attn_long_steps": 2,
             # (g): past head dim 256: K3 and K4 on the 64-row wgmma
             # kernel, K5 and K6 on the panel kernels
             "wide_b": 16, "wide_heads": 2, "wide_head": 320,
             "wide_steps": 2, "wide_long_steps": 2}
# (a) the card against the CPU in f64 on the same f32-representable
# params: output, loss and every gradient within INFER_F64_TOL (each
# element to its own size for output and loss, normwise for gradients).
# The card in f32 (TF32 off): the output against the CPU's f64 (each
# element to its own size, flash_err); the loss (flash_err) and every
# gradient normwise (||g - g64|| / ||g64||) against the CPU's f64 run
# along the card's own ReLU and max-pool decisions (pinned_decisions).
# Rounding flips a handful of the ~30 M decisions (on an H100: 5 ReLUs
# and 6 pool argmaxes; the CPU's f32 3 and 2), and each flip moves the
# gradients of the layers below it by up to 8.4e-3 normwise on the card
# and 3.3e-3 on the CPU, so the free f32 gradients are read, not gated;
# along the card's decisions they read <= 6.0e-6.  The share of flipped
# decisions is gated (INFER_TOL["flips"]; reads 3.6e-7), and every
# convolution, pooling and dense layer alone, its activation off, within
# INFER_TOL["layer"] of the tensor's largest element (reads <= 3.9e-5).
INFER_F64_TOL = 1e-7
INFER_TOL = {"output": 1e-4, "loss": 1e-5, "grad": 1e-4, "layer": 1e-4,
             "flips": 1e-5,
             # (c) a served row against the direct b-1 output() of its
             # image: batched and b-1 cuDNN algorithms sum in other
             # orders (f32 softmax outputs)
             "served": 1e-4,
             # (c), (d): a top-1 disagreement is allowed only where the
             # reference's top-2 probabilities lie within this much
             "near_tie": 1e-4, "near_tie_int8": 0.05}
ZOO_INFER = ("AlexNet", "VGG19", "Darknet19", "TinyYOLO", "YOLO2",
             "SqueezeNet", "UNet", "Xception", "InceptionResNetV1",
             "FaceNetNN4Small2", "NASNet")


def zoo_out_shape(name, model, b):
    """The output shape the reference's configuration gives ``name``
    at ``model``'s input (the detection heads' grid is the input / 8;
    UNet is per pixel)."""
    h, w, _ = model.input_shape
    if name in ("TinyYOLO", "YOLO2"):
        return (b, h // 8, w // 8, 5 + model.n_classes)
    if name == "UNet":
        return (b, h, w, model.n_classes)
    return (b, model.n_classes)


def infer_vgg_pass(torch, vgg, params, x, y, dtype, device,
                   decisions=None):
    """VGG ``vgg`` with the numpy ``params`` cast to ``dtype`` on
    ``device``: (inference output, loss, {leaf: gradient}) of one
    training forward and backward (no dropout: no key), all on the
    CPU.  ``decisions``: a ``pinned_decisions`` the training pass runs
    under."""
    import contextlib

    from deeplearning4j_torch.data import DataSet
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.utils.convert import load_numpy_params
    from deeplearning4j_torch.utils.trees import iter_leaves, map_leaves
    conf = vgg.conf()
    conf.global_conf.dtype = conf.global_conf.compute_dtype = dtype
    net = load_numpy_params(MultiLayerNetwork(conf), map_leaves(
        lambda a: a.astype(dtype), params), device=device)
    net._build_solver()
    with decisions or contextlib.nullcontext():
        loss, _, grads = net._solver._loss_and_grads(
            net.params_tree, net.state_tree,
            net._batch_dict(DataSet(x, y)), None)
    return (net.output(x).cpu(), loss.detach().cpu().reshape(1),
            {"/".join(p): g.detach().cpu() for p, g in iter_leaves(grads)})


def infer_vgg_layer_cases(torch, vgg, params, x, device):
    """``layer_cases`` of every convolution, pooling and dense layer in
    the VGG's f32 inference forward of ``x`` on ``device``."""
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf import layers_conv as lc
    from deeplearning4j_torch.nn.conf import layers_core
    from deeplearning4j_torch.utils.convert import load_numpy_params
    net = load_numpy_params(MultiLayerNetwork(vgg.conf()), params,
                            device=device)
    return layer_cases(net, x, (lc.ConvolutionLayer, lc.SubsamplingLayer,
                                layers_core.DenseLayer))


def infer_vgg_card_vs_cpu(torch, np, vgg, cfg, device):
    """Part (a): the same seeded f32-representable VGG params on
    ``device`` in f64 and in f32 (TF32 off), against the CPU in f64.
    The card's f32 gradients are held to the CPU's f64 along the card's
    own ReLU and max-pool decisions (``pinned_decisions``); the free f64
    gradients, the CPU's f32 and the card's in contiguous NCHW are read
    beside them, with the decisions each f32 run flips; every
    convolution, pooling and dense layer alone with its activation off
    (``layer_errors``)."""
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.utils.trees import map_leaves
    t0 = time.perf_counter()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = map_leaves(lambda t: t.numpy(), MultiLayerNetwork(
            vgg.conf()).init(device="cpu").params_tree)
        r = np.random.default_rng(21)
        b = cfg["vgg_b"]
        x = r.random((b,) + tuple(vgg.input_shape)).astype(np.float32)
        y = np.eye(vgg.n_classes, dtype=np.float32)[
            r.integers(0, vgg.n_classes, b)]
        dec = {k: pinned_decisions() for k in ("card", "card_nchw", "cpu",
                                               "ref")}
        run = lambda dt, d, k=None: infer_vgg_pass(
            torch, vgg, params, x, y, dt, d, dec.get(k))
        card = run("float32", device, "card")
        with contiguous_convs():
            card_nchw = run("float32", device, "card_nchw")
        card64 = run("float64", device)
        cpu32 = run("float32", "cpu", "cpu")
        ref = run("float64", "cpu", "ref")
        dec["pinned"] = pinned_decisions(replay=dec["card"])
        pinned = run("float64", "cpu", "pinned")
        layers = layer_errors(torch, infer_vgg_layer_cases(
            torch, vgg, params, x, device), device, linear=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    norm = lambda g, w: float((g.double() - w).norm()
                              / w.norm().clamp_min(1e-300))
    by_leaf = lambda a, base: {k: norm(g, base[2][k])
                               for k, g in a[2].items()}
    e64 = {"output": flash_err(torch, card64[0].double(), ref[0])[0],
           "loss": flash_err(torch, card64[1].double(), ref[1])[0],
           "grad": max(by_leaf(card64, ref).values())}
    e32 = {"output": flash_err(torch, card[0].double(), ref[0])[0],
           "loss": flash_err(torch, card[1].double(), pinned[1])[0],
           "grad": max(by_leaf(card, pinned).values())}
    free = {who: by_leaf(a, ref) for who, a in (
        ("card", card), ("card_nchw", card_nchw), ("cpu", cpu32))}
    free["card_pinned"] = by_leaf(card, pinned)
    flips = {who: dec[who].flips(dec["ref"])
             for who in ("card", "card_nchw", "cpu")}
    share = {who: sum(n for n, _ in f.values())
             / max(sum(t for _, t in f.values()), 1)
             for who, f in flips.items()}
    bad = {f"float32/{k}": e for k, e in e32.items()
           if not (math.isfinite(e) and e <= INFER_TOL[k])}
    bad.update({f"float64/{k}": e for k, e in e64.items()
                if not (math.isfinite(e) and e <= INFER_F64_TOL)})
    bad.update({f"layer/{k}": e for k, e in layers.items()
                if not (math.isfinite(e) and e <= INFER_TOL["layer"])})
    bad.update({f"flips/{k}": e for k, e in share.items()
                if not e <= INFER_TOL["flips"]})
    if bad:
        raise AssertionError(f"infer/a: card vs CPU f64 {bad} over "
                             f"{INFER_TOL} (f32) / {INFER_F64_TOL} (f64); "
                             f"f32 gradients by leaf {free}; flipped "
                             f"decisions {flips}")
    return {"b": b, "input": list(vgg.input_shape),
            "classes": vgg.n_classes, "float64": e64,
            "float64_tol": INFER_F64_TOL, "float32": e32,
            "float32_tol": {k: INFER_TOL[k] for k in e32},
            "float32_grad_by_leaf": free, "flipped_decisions": flips,
            "flipped_share": share, "flips_tol": INFER_TOL["flips"],
            "layers": layers, "layer_tol": INFER_TOL["layer"],
            "output_shape": list(card[0].shape),
            "measure": "output: flash_err (card f32 vs CPU f64); loss: "
                       "flash_err, grad: max over leaves of ||g - g64|| / "
                       "||g64||, both against the CPU's f64 along the "
                       "card's ReLU and max-pool decisions; "
                       "float32_grad_by_leaf: card (channels-last), "
                       "card_nchw and cpu f32 against the free f64, and "
                       "card against the pinned f64; flipped_decisions: "
                       "[ReLU masks or pool argmaxes that differ from the "
                       "free f64's, all decisions]; layers: max |d| / "
                       "max |cpu| of each layer alone, activation off",
            "tf32": "off for this part, restored after",
            "seconds": time.perf_counter() - t0}


def infer_batch(np, vgg, b, n_classes, seed):
    r = np.random.default_rng(seed)
    x = r.random((b,) + tuple(vgg.input_shape)).astype(np.float32)
    return x, np.eye(n_classes, dtype=np.float32)[
        r.integers(0, n_classes, b)]


def infer_transfer(torch, np, vgg, cfg, device, sync):
    """Part (b): EditLastLayerOthersFrozen's fine-tune of the VGG: the
    layers through fc2 frozen, the head replaced by ``tl_classes``
    outputs, Nesterovs; ``tl_steps`` fit steps on one seeded batch.
    Returns (row, the fine-tuned model)."""
    from deeplearning4j_torch.data import DataSet
    from deeplearning4j_torch.models.transfer_learning import (
        TransferLearning, frozen_layer_indices)
    from deeplearning4j_torch.optimize.updaters import Nesterovs
    from deeplearning4j_torch.utils.trees import map_leaves
    src = vgg.init_graph(device=device)
    n = len(src.layers)
    fc2, head = n - 2, n - 1
    src_copy = map_leaves(torch.clone, src.params_tree)
    ft = (TransferLearning.Builder(src)
          .fine_tune_configuration(updater=Nesterovs(learning_rate=1e-3,
                                                     momentum=0.9),
                                   seed=11)
          .set_feature_extractor(fc2)
          .n_out_replace(head, cfg["tl_classes"])
          .build())
    if frozen_layer_indices(ft) != list(range(fc2 + 1)):
        raise AssertionError(f"infer/b: frozen {frozen_layer_indices(ft)}")
    frozen = {k: v for k, v in ft.params_tree.items()
              if int(k.split("_")[1]) <= fc2}
    frozen_copy = map_leaves(torch.clone, frozen)
    head_before = ft.params_tree[f"layer_{head}"]["W"].clone()
    ds = DataSet(*infer_batch(np, vgg, cfg["tl_b"], cfg["tl_classes"], 12))
    # fit's losses carry the frozen fc layers' dropout: the gate reads
    # the batch's score without it, before and after
    score0 = ft.score(ds)
    ft.fit(ds)                                           # warm-up
    sync()
    t0 = time.perf_counter()
    losses = [float(ft.fit(ds)) for _ in range(cfg["tl_steps"] - 1)]
    sync()
    wall = time.perf_counter() - t0
    if not tree_diff(torch, frozen, frozen_copy)[0]:
        raise AssertionError("infer/b: a frozen parameter moved")
    if not tree_diff(torch, src.params_tree, src_copy)[0]:
        raise AssertionError("infer/b: the source model changed")
    del src, src_copy, frozen_copy
    moved = float((ft.params_tree[f"layer_{head}"]["W"] - head_before)
                  .abs().max())
    if not moved > 0:
        raise AssertionError("infer/b: the head did not move")
    score1 = ft.score(ds)
    if not (all(math.isfinite(v) for v in losses) and score1 < score0):
        raise AssertionError(f"infer/b: losses {losses} not finite, or "
                             f"the score {score0} -> {score1} not falling")
    steps = cfg["tl_steps"] - 1
    return {"b": cfg["tl_b"], "classes": cfg["tl_classes"],
            "frozen_through": fc2, "frozen_bit_identical": True,
            "source_unchanged": True, "head_max_move": moved,
            "updater": "Nesterovs(1e-3, 0.9)", "losses": losses,
            "score_before_after": [score0, score1],
            "step_ms": wall * 1e3 / steps,
            "images_per_s": steps * cfg["tl_b"] / wall,
            "timed": f"{steps} fit steps after a warm-up step"}, ft


def infer_series(reg):
    """The ParallelInference series this part reads: counter values,
    and (count, sum) of the two ratio histograms."""
    out = {n: reg.get(n).value for n in (
        "inference_requests_total", "inference_batches_total",
        "inference_shed_total", "inference_errors_total")}
    for n in ("inference_batch_occupancy", "inference_padding_waste",
              "inference_latency_seconds"):
        h = reg.get(n)
        out[n] = (h.count, h.sum)
    return out


def infer_parallel(torch, np, model, cfg):
    """Part (c): ``ParallelInference`` over the fine-tuned model, its
    callers' threads each sending single images; every result held to
    the model's direct b-1 ``output()``; then a shed case."""
    import threading
    from deeplearning4j_torch import telemetry
    from deeplearning4j_torch.parallel import ParallelInference
    reg = telemetry.get_registry()
    n_thr, n_req = cfg["pi_threads"], cfg["pi_requests"]
    r = np.random.default_rng(13)
    imgs = r.random((n_thr * n_req,) + tuple(model.conf.input_type.shape)
                    ).astype(np.float32)
    direct = np.stack([model.output(imgs[i:i + 1]).float().cpu().numpy()[0]
                       for i in range(len(imgs))])
    results, lat = [None] * len(imgs), [0.0] * len(imgs)
    errors = []
    s0 = infer_series(reg)
    with ParallelInference(model, batch_limit=cfg["pi_batch_limit"],
                           queue_limit=cfg["pi_queue_limit"]) as pi:
        pi.output(imgs[:1])                               # warm-up
        s0 = infer_series(reg)

        def caller(k):
            try:
                for j in range(n_req):
                    i = k * n_req + j
                    t = time.perf_counter()
                    # a [1, h, w, c] batch: ParallelInference reads a
                    # request of more than one dim as rows, as upstream
                    results[i] = pi.output(imgs[i:i + 1])[0]
                    lat[i] = time.perf_counter() - t
            except Exception as e:  # reported after the join
                errors.append(e)
        threads = [threading.Thread(target=caller, args=(k,))
                   for k in range(n_thr)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"infer/c: a caller failed: {errors[0]!r}")
    s1 = infer_series(reg)
    got = np.stack(results)
    diff = float(np.abs(got - direct).max())
    top2 = np.sort(direct, -1)[:, -2:]
    flips = int(((got.argmax(-1) != direct.argmax(-1))
                 & (top2[:, 1] - top2[:, 0] > INFER_TOL["near_tie"])).sum())
    if not (np.isfinite(got).all() and diff <= INFER_TOL["served"]
            and flips == 0):
        raise AssertionError(f"infer/c: served vs direct max |d| {diff}, "
                             f"{flips} argmax flips off a near tie")
    d = lambda k: s1[k] - s0[k]
    hist = lambda k: ((s1[k][1] - s0[k][1]) / max(s1[k][0] - s0[k][0], 1))
    row = {"threads": n_thr, "requests_per_thread": n_req,
           "batch_limit": cfg["pi_batch_limit"],
           "queue_limit": cfg["pi_queue_limit"],
           "max_abs_vs_direct": diff, "tol": INFER_TOL["served"],
           "argmax_flips_off_near_tie": flips,
           "images_per_s": len(imgs) / wall, "wall_s": wall,
           "latency_ms": {"p50": pct(lat, 0.5) * 1e3,
                          "p99": pct(lat, 0.99) * 1e3},
           "requests": d("inference_requests_total"),
           "batches": d("inference_batches_total"),
           "mean_occupancy": hist("inference_batch_occupancy"),
           "mean_padding_waste": hist("inference_padding_waste"),
           "series_latency_ms_mean": hist("inference_latency_seconds") * 1e3}
    # the shed case: a one-slot queue behind a held worker
    gate = threading.Event()
    fwd = model._forward_infer

    def held(p, s, x):
        gate.wait(30)
        return fwd(p, s, x)
    model._forward_infer = held
    shed0 = reg.get("inference_shed_total").value
    try:
        with ParallelInference(model, batch_limit=1, queue_limit=1,
                               shed_on_full=True) as pi:
            first = threading.Thread(target=pi.output, args=(imgs[:1],))
            first.start()
            deadline = time.time() + 10
            while pi._queue.qsize() and time.time() < deadline:
                time.sleep(0.005)
            second = threading.Thread(target=pi.output,
                                      args=(imgs[1:2],))
            second.start()
            while not pi._queue.qsize() and time.time() < deadline:
                time.sleep(0.005)
            try:
                pi.output(imgs[2:3])
            except RuntimeError as e:
                shed_msg = str(e)
            else:
                raise AssertionError("infer/c: a full queue did not shed")
            gate.set()
            first.join(30)
            second.join(30)
    finally:
        model._forward_infer = fwd
        gate.set()
    if reg.get("inference_shed_total").value != shed0 + 1:
        raise AssertionError("infer/c: inference_shed_total did not count "
                             "the shed request")
    row["shed"] = {"raised": shed_msg[:80], "counted": 1}
    return row


def infer_quantized(torch, np, model, cfg, sync):
    """Part (d): ``QuantizedInference`` of the fine-tuned model (int8
    weights dequantized to bf16, math in the model's f32 compute dtype):
    compression, the largest weight error, top-1 against the f32 model
    on seeded images (disagreements only at near ties), images/s of
    both, timed in turns."""
    from deeplearning4j_torch.runtime import QuantizedInference
    qi = QuantizedInference(model, compute_dtype="bfloat16")
    r = np.random.default_rng(14)
    x = r.random((cfg["q_images"],) + tuple(model.conf.input_type.shape)
                 ).astype(np.float32)
    xt = torch.as_tensor(x, device=model.device)
    f32 = model.output(xt).float().cpu().numpy()
    q = qi.output(xt).float().cpu().numpy()
    agree = float((f32.argmax(-1) == q.argmax(-1)).mean())
    top2 = np.sort(f32, -1)[:, -2:]
    flips = int(((f32.argmax(-1) != q.argmax(-1))
                 & (top2[:, 1] - top2[:, 0] > INFER_TOL["near_tie_int8"]))
                .sum())
    if not (np.isfinite(q).all() and flips == 0):
        raise AssertionError(f"infer/d: {flips} top-1 flips off a near tie")
    turns = {"f32": [], "int8": []}
    for who in ("f32", "int8", "int8", "f32"):
        fn = model.output if who == "f32" else qi.output
        fn(xt)
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            fn(xt)
        sync()
        turns[who].append(3 * len(x) / (time.perf_counter() - t0))
    return {"compression_ratio": qi.compression_ratio(),
            "max_abs_weight_error": qi.max_abs_weight_error(),
            "images": len(x), "top1_agreement": agree,
            "top1_flips_off_near_tie": flips,
            "near_tie": INFER_TOL["near_tie_int8"],
            "max_abs_prob_diff": float(np.abs(q - f32).max()),
            "images_per_s": turns,
            "turns": "f32, int8, int8, f32; 3 calls each after one"}


def infer_zoo(torch, np, cfg, device):
    """Part (e): every other zoo CNN built on the device at its input
    (``zoo_kwargs``) through one forward; one fit step of YOLO2 (seeded
    boxes), UNet and FaceNetNN4Small2 (the center term non-zero); the
    checked-in LeNet through ``load_pretrained``, sha256 checked."""
    from deeplearning4j_torch import zoo
    from deeplearning4j_torch.data import DataSet
    from deeplearning4j_torch.zoo.pretrained import (load_pretrained,
                                                     package_weights_dir,
                                                     sha256_of)
    b = cfg["zoo_b"]
    r = np.random.default_rng(15)
    out, fits = {}, {}
    for name in ZOO_INFER:
        t0 = time.perf_counter()
        model = getattr(zoo, name)(**cfg["zoo_kwargs"].get(name, {}))
        net = model.init_graph(device=device)
        x = r.normal(size=(b,) + tuple(model.input_shape)).astype(
            np.float32)
        y = net.output(x)
        y = (y[0] if isinstance(y, list) else y).float().cpu().numpy()
        want = zoo_out_shape(name, model, b)
        if y.shape != want or not np.isfinite(y).all():
            raise AssertionError(f"infer/e: {name} output {y.shape} (want "
                                 f"{want}) or not finite")
        out[name] = {"input": list(model.input_shape),
                     "output": list(y.shape), "params": net.num_params(),
                     "seconds": time.perf_counter() - t0}
        if name in ("YOLO2", "UNet", "FaceNetNN4Small2"):
            if name == "YOLO2":
                lab = np.zeros(want, np.float32)
                for i in range(b):
                    gi, gj = r.integers(0, want[1]), r.integers(0, want[2])
                    lab[i, gi, gj, :5] = [1.0, *r.random(2),
                                          *(r.random(2) + 0.5)]
                    lab[i, gi, gj, 5 + r.integers(0, model.n_classes)] = 1.0
            elif name == "UNet":
                lab = np.stack([x[..., 0] <= 0, x[..., 0] > 0], -1).astype(
                    np.float32)
            else:
                lab = np.eye(model.n_classes, dtype=np.float32)[
                    r.integers(0, model.n_classes, b)]
            loss = float(net.fit(DataSet(x, lab)))
            fit = {"loss": loss}
            if name == "FaceNetNN4Small2":
                head = net.conf.vertices["output"].layer
                emb = net.feed_forward(x)["l2"]
                center = float(head.center_score(
                    net.params_tree["output"], emb.float(),
                    torch.as_tensor(lab, device=emb.device)).mean())
                fit["center_term"] = center
                fit["centers_moved"] = float(
                    net.params_tree["output"]["centers"].abs().max())
                if not (center > 0 and fit["centers_moved"] > 0):
                    raise AssertionError(f"infer/e: FaceNet center term "
                                         f"{fit}")
            if not math.isfinite(loss):
                raise AssertionError(f"infer/e: {name} fit loss {loss}")
            fits[name] = fit
        del net
    wdir = package_weights_dir()
    with open(os.path.join(wdir, "LeNet_mnist.zip.json")) as f:
        manifest = json.load(f)
    sha = sha256_of(os.path.join(wdir, "LeNet_mnist.zip"))
    if sha != manifest["sha256"]:
        raise AssertionError("infer/e: LeNet_mnist.zip sha256 != manifest")
    lenet = load_pretrained("LeNet", "mnist", device=device)
    x = r.random((4, 28, 28, 1)).astype(np.float32)
    cpu = load_pretrained("LeNet", "mnist", device="cpu")
    d = float((lenet.output(x).float().cpu() - cpu.output(x)).abs().max())
    if not d <= 1e-4:
        raise AssertionError(f"infer/e: LeNet on the device vs CPU {d}")
    return {"forward": out, "fit": fits,
            "lenet_pretrained": {"sha256": sha, "vs_cpu_max_abs": d}}


def infer_attn_net(cfg, device, heads, head):
    """The sequence classifier of parts (f) and (g):
    SelfAttentionLayer(heads x head, flash) -> masked average pooling ->
    2-way softmax, bf16 on f32 masters, Adam."""
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf import (GlobalPoolingLayer, InputType,
                                              NeuralNetConfiguration,
                                              OutputLayer,
                                              SelfAttentionLayer)
    from deeplearning4j_torch.optimize.updaters import Adam
    d = heads * head
    conf = (NeuralNetConfiguration.builder().seed(16)
            .updater(Adam(learning_rate=1e-4)).compute_dtype("bfloat16")
            .list()
            .layer(SelfAttentionLayer(n_heads=heads, head_size=head,
                                      n_out=d, use_flash=True))
            .layer(GlobalPoolingLayer(pooling_type="avg"))
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.recurrent(d))
            .build())
    return MultiLayerNetwork(conf).init(device=device)


def infer_capture(fa):
    """Wrap the four flash wrappers so each records a copy of its first
    call's operands; returns (records, restore)."""
    saved = {n: getattr(fa, n) for n in FLASH_WRAPPERS}
    rec = {}

    def wrap(name, orig):
        def w(*a, **kw):
            if name not in rec:
                rec[name] = ([x.detach().clone() if hasattr(x, "detach")
                              else x for x in a], dict(kw))
            return orig(*a, **kw)
        # the wrappers count through their module name, which this shim
        # holds while installed
        w.launches, w.builds = 0, {}
        return w
    for n, f in saved.items():
        setattr(fa, n, wrap(n, f))

    def restore():
        for n, f in saved.items():
            setattr(fa, n, f)
    return rec, restore


def infer_kernel_errors(torch, fa, rec, label="infer/f"):
    """Each captured launch replayed through its wrapper (before the
    counts are reset for the counted steps) against the plain version on
    the same operands, each output held to ``FLASH_TOL`` by
    ``flash_err``; ``label`` names the window in a failure."""
    bh = fa._to_bh
    errs = {}
    for name, (a, kw) in rec.items():
        if name in ("flash_fwd", "flash_fwd_single"):
            q, k, v, bias = (a + [None])[:4]
            o, lse = getattr(fa, name)(q, k, v, bias, **kw)
            ro, rl = fa.flash_fwd_reference(
                bh(q), bh(k), bh(v), bias, single=name.endswith("single"),
                **kw)
            pairs = {"o": (bh(o), ro), "lse": (lse, rl)}
        else:
            q, k, v, bias, do, lse, delta = a[:7]
            rq, rk, rv, _ = fa.flash_bwd_reference(
                bh(q), bh(k), bh(v), bias, bh(do), lse, delta,
                **{x: kw[x] for x in ("causal", "scale")})
            if name == "flash_bwd_dkdv":
                dk, dv, _ = fa.flash_bwd_dkdv(q, k, v, bias, do, lse, delta,
                                              **kw)
                pairs = {"dk": (bh(dk), rk), "dv": (bh(dv), rv)}
            else:
                dq = fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, **kw)
                pairs = {"dq": (bh(dq), rq)}
        for key, (x, r) in pairs.items():
            x, r = x.float(), r.float()
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{label}: {name} {key} non-finite")
            errs[f"{name}/{key}"] = flash_err(torch, x, r)[0]
    return errs


def infer_attention(torch, np, cfg, device, sync, part="f"):
    """Part (f): the sequence classifier trained on the flash route —
    ``attn_steps`` counted fit steps at t ``attn_t`` with each row's
    valid length seeded in 64..t (K4 forward, K5 without dBias, K6),
    then ``attn_long_steps`` unmasked steps at ``attn_t_long`` (K3, K5,
    K6); each window after a warm-up step whose launches' operands are
    replayed through the kernels against their plain versions before the
    counts are reset.  Part (g) is the same at ``wide_heads`` heads of
    ``wide_head`` (past 256: K3 and K4 on the 64-row wgmma kernel, K5
    and K6 on the panel kernels), b ``wide_b``,
    ``wide_steps`` and ``wide_long_steps`` steps; its windows are
    labelled ``dh<head>_masked`` and ``dh<head>_long``."""
    from deeplearning4j_torch.data import DataSet
    fa = flash_module()
    if part == "f":
        b, heads, head = cfg["attn_b"], cfg["attn_heads"], cfg["attn_head"]
        steps_m, steps_l, prefix = (cfg["attn_steps"],
                                    cfg["attn_long_steps"], "")
    else:
        b, heads, head = cfg["wide_b"], cfg["wide_heads"], cfg["wide_head"]
        steps_m, steps_l, prefix = (cfg["wide_steps"],
                                    cfg["wide_long_steps"], f"dh{head}_")
    net = infer_attn_net(cfg, device, heads, head)
    d = heads * head
    r = np.random.default_rng(17)
    out, counts, errs = {}, {}, {}
    y = np.eye(2, dtype=np.float32)[r.integers(0, 2, b)]
    for label, t, steps, masked in (
            (prefix + "masked", cfg["attn_t"], steps_m, True),
            (prefix + "long", cfg["attn_t_long"], steps_l, False)):
        x = r.normal(size=(b, t, d)).astype(np.float32)
        lens = bert_lengths(np, b, t, 3) if masked else np.full(b, t)
        mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
        ds = DataSet(x, y, features_mask=mask if masked else None)
        fwd = "flash_fwd_single" if t // 512 == 1 else "flash_fwd"
        want = {name: (steps if name in (fwd, "flash_bwd_dkdv",
                                         "flash_bwd_dq") else 0)
                for name in FLASH_WRAPPERS}
        rec, restore = infer_capture(fa)
        try:
            net.fit(ds)                                   # warm-up
        finally:
            restore()
        if set(rec) != {n for n, c in want.items() if c}:
            raise AssertionError(f"infer/{part}/{label}: captured "
                                 f"{sorted(rec)}")
        e = infer_kernel_errors(torch, fa, rec)
        bad = {k: v for k, v in e.items()
               if not (math.isfinite(v) and v <= FLASH_TOL["bfloat16"])}
        if bad:
            raise AssertionError(f"infer/{part}/{label}: kernel vs plain "
                                 f"{bad}")
        sync()
        route0 = fa._ROUTE_FLASH.value
        fallback0 = fa._ROUTE_XLA_LONG_T.value
        for name in FLASH_WRAPPERS:
            getattr(fa, name).launches = 0
        t0 = time.perf_counter()
        losses = [float(net.fit(ds)) for _ in range(steps)]
        sync()
        wall = time.perf_counter() - t0
        cnt = {name: getattr(fa, name).launches for name in FLASH_WRAPPERS}
        if cnt != want:
            raise AssertionError(f"infer/{part}/{label}: launches {cnt} != "
                                 f"{want}")
        if fa._ROUTE_FLASH.value - route0 != steps:
            raise AssertionError(f"infer/{part}/{label}: flash_route_total "
                                 "did not move once a step")
        if fa._ROUTE_XLA_LONG_T.value != fallback0:
            raise AssertionError(f"infer/{part}/{label}: long-t fallback")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"infer/{part}/{label}: losses {losses}")
        if masked and not losses[-1] < losses[0]:
            raise AssertionError(f"infer/{part}/{label}: losses {losses} "
                                 "not falling")
        counts[label] = cnt
        errs.update({f"{label}/{k}": v for k, v in e.items()})
        out[label] = {"b": b, "t": t, "heads": heads, "head": head,
                      "steps": steps, "losses": losses,
                      "valid_tokens": int(lens.sum()), "launches": cnt,
                      "step_ms": wall * 1e3 / steps,
                      "tokens_per_s": steps * b * t / wall,
                      "kernel_vs_plain": e}
    out["tol"] = FLASH_TOL["bfloat16"]
    out["measure"] = ("the warm-up step's operands of each wrapper, "
                      "replayed: flash_err of kernel vs plain")
    return out, counts, errs


def infer_parts(torch, np, device, cfg, vgg, sync, card):
    """Parts (a)-(g) of :func:`phase_infer` on ``device`` at ``cfg``'s
    sizes, ``vgg`` the VGG16 model config (smaller in the rehearsal).
    Emits one row and returns parts (f) and (g)'s launch counts by
    window."""
    t_phase = time.perf_counter()
    row = {"phase": "infer", "card": card}
    row["a_vgg_card_vs_cpu"] = infer_vgg_card_vs_cpu(torch, np, vgg, cfg,
                                                     device)
    row["b_transfer"], ft = infer_transfer(torch, np, vgg, cfg, device,
                                           sync)
    row["c_parallel_inference"] = infer_parallel(torch, np, ft, cfg)
    row["d_quantized"] = infer_quantized(torch, np, ft, cfg, sync)
    del ft
    row["e_zoo"] = infer_zoo(torch, np, cfg, device)
    row["f_attention"], counts, _ = infer_attention(torch, np, cfg, device,
                                                    sync)
    row["g_attention_wide"], wide, _ = infer_attention(torch, np, cfg,
                                                       device, sync, "g")
    counts.update(wide)
    row["reduced"] = [
        "seeded random weights for VGG16 and every zoo model (no "
        "pretrained VGG16/YOLO2 weights are in the repo)",
        "seeded random images for dl4j-examples' flower photos and "
        "ImageNet, which are not in the repo"]
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    return counts


def phase_infer(torch, np):
    """Batched inference and transfer learning on the card (phase 9b). (a)
    VGG16 (224 x 224 x 3, 1000 classes, seeded f32-representable
    weights) at b 2: the card's output, loss and every gradient in f64
    and in f32 against the CPU's f64 (``INFER_F64_TOL``, ``INFER_TOL``;
    the f32 gradients along the card's own ReLU and pool decisions), the
    share of flipped decisions, every layer alone; (b) dl4j-examples'
    EditLastLayerOthersFrozen:
    TransferLearning.Builder freezes VGG16 through fc2, replaces the
    head with 5 classes, fine-tunes with Nesterovs for 10 steps at b 16
    on one seeded batch — frozen params bit-identical, the head moved,
    the batch's score (no dropout) lower after, the source model
    unchanged; (c) ParallelInference (batch_limit 32, queue_limit 64)
    over the fine-tuned model, 8 caller threads x 16 single images, each
    result against the model's direct output() of its image, images/s,
    latency p50/p99, batches, occupancy and padding waste from the
    inference_* series, then a shed case; (d) QuantizedInference of it
    (weights dequantized to bf16, f32 math): compression, the largest
    weight error, top-1 agreement on 64 images, images/s against f32
    output() in turns; (e) every other
    zoo CNN at its default input through one forward, one fit step of
    YOLO2, UNet and FaceNetNN4Small2, the LeNet zip through
    load_pretrained; (f) a sequence classifier at BERT-base's attention
    width (SelfAttentionLayer 12 x 64, use_flash, masked pooling, 2
    classes; bf16 on f32 masters, Adam) at b 32: 5 steps at t 512 with
    seeded padding (K4, K5, K6 once a step each) and 2 unmasked steps at
    t 1024 (K3, K5, K6), every launch's operands replayed against the
    plain versions; (g) the same classifier past the fast kernels' head
    dims, 2 heads of 320 (K3/K4 on the 64-row wgmma kernel, K5/K6 on
    the panel kernels), b 16, 2 steps at t 512
    masked and 2 at t 1024.  Returns (f) and (g)'s launch counts."""
    from deeplearning4j_torch.zoo import VGG16
    try:
        return infer_parts(torch, np, "cuda", INFER_CFG, VGG16(),
                           torch.cuda.synchronize, card_line())
    finally:
        torch.cuda.empty_cache()


# -- phase 9c ----------------------------------------------------------
# BASELINE config 3 at bench.py's bench_bert_imported shape: the frozen
# BERT-base graph (weights emptied, seeded from its sidecar), b 40, t 512,
# bf16 on f32 masters, Adam(2e-5), the tiny-sentiment corpus
SAMEDIFF_CFG = {"graph": "tests/fixtures/bert_base_graph_only.pb",
                "rewrites": BERT_BASE_REWRITES, "layers": 12, "seed": 0,
                "b_f32": 2, "b": 40, "t": 512, "steps": 10, "lr": 2e-5,
                "gpt_steps": 3, "csv_rows": 4096, "csv_batch": 128,
                "csv_epochs": 4}
# (a) the card's f32 forward against the CPU's f64, normwise; (c) the
# committed fixtures against TensorFlow's goldens (the reference tests'
# bound); (d) ONNX graphs card against CPU, each element
SAMEDIFF_TOL = {"f32_normwise": 1e-4, "golden": 3e-5, "onnx": 1e-5,
                "zip": 1e-5}
SD_FIXTURES = "tests/fixtures"


def sd_sidecar_values(np, sidecar, seed):
    """{const name: value} of every Const the graph-only file emptied,
    seeded with numpy: N(0, 0.02) in f32, ones or zeros (the sidecar's
    ``init``)."""
    r = np.random.default_rng(seed)
    out = {}
    for c in sidecar["consts"]:
        shape = tuple(c["shape"])
        if c["init"] == "normal":
            out[c["name"]] = (r.standard_normal(shape, np.float32)
                              * np.float32(0.02))
        else:
            out[c["name"]] = np.full(shape, 1.0 if c["init"] == "ones"
                                     else 0.0, np.float32)
    return out


def sd_import(path, values, device, expect=None):
    """The graph at ``path`` imported on ``device``, ``values`` installed
    over its VARIABLEs, rewritten by ``optimize_for_tpu``.  Returns (the
    graph, the rewrite counts, the fused attention sites, seconds)."""
    from deeplearning4j_torch.autodiff.rewrites import optimize_for_tpu
    from deeplearning4j_torch.autodiff.tf_import import import_frozen_pb
    t0 = time.perf_counter()
    sd = import_frozen_pb(path, device=device)
    for k, v in (values or {}).items():
        if sd.vars[k].var_type != "VARIABLE":
            raise AssertionError(f"samediff: {k} is not a VARIABLE")
        sd.values[k] = v
    counts = optimize_for_tpu(sd)
    sites = sum(n.op_name == "fused_attention" for n in sd.ops)
    if expect is not None and counts != expect:
        raise AssertionError(f"samediff: rewrites {counts} != {expect}")
    return sd, counts, sites, time.perf_counter() - t0


def normwise(torch, got, want):
    """||got - want|| / ||want|| in f64 (``want`` is the reference)."""
    g = torch.as_tensor(got).double().cpu()
    w = torch.as_tensor(want).double().cpu()
    return float((g - w).norm() / w.norm().clamp_min(1e-300))


def sd_counts(fa):
    return {name: getattr(fa, name).launches for name in FLASH_WRAPPERS}


def sd_zero(fa):
    for name in FLASH_WRAPPERS:
        getattr(fa, name).launches = 0


def sd_base_forward(torch, np, cfg, device, sync, values):
    """Part (a): import + rewrite on the card (the counts the reference
    gives on the same file, ``cfg["layers"]`` fused sites), then the f32
    forward at b ``b_f32`` against the port on the CPU in f64: the
    last hidden state and the pooler output, normwise.  Returns (the
    card's graph, the row)."""
    fa = flash_module()
    path = os.path.join(ROOT_DIR, cfg["graph"])
    sd, counts, sites, secs = sd_import(path, values, device,
                                        cfg["rewrites"])
    if sites != cfg["layers"]:
        raise AssertionError(f"samediff/a: {sites} fused sites")
    b, t = cfg["b_f32"], cfg["t"]
    r = np.random.default_rng(cfg["seed"] + 1)
    vocab = cfg["vocab"]
    feeds = {"i": r.integers(0, vocab, (b, t)).astype(np.int32),
             "m": np.ones((b, t), np.int32),
             "t": np.zeros((b, t), np.int32)}
    feeds["m"][1, t // 2:] = 0
    outs = ["Identity", "Identity_1"]
    sync()
    sd_zero(fa)
    t0 = time.perf_counter()
    card = sd.output(feeds, outs)
    sync()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    launches = sd_counts(fa)
    if launches["flash_fwd_single"] != cfg["layers"]:
        raise AssertionError(f"samediff/a: f32 forward launches {launches}")
    cpu, _, _, _ = sd_import(path, {k: v.astype(np.float64)
                                    for k, v in values.items()}, "cpu")
    want = cpu.output(feeds, outs)
    errs = {o: normwise(torch, card[o], want[o]) for o in outs}
    for o, e in errs.items():
        if not (math.isfinite(e) and e <= SAMEDIFF_TOL["f32_normwise"]):
            raise AssertionError(f"samediff/a: {o} card f32 vs CPU f64 "
                                 f"{e}")
    return sd, {"import_s": secs, "ops": len(sd.ops), "rewrites": counts,
                "fused_sites": sites, "b": b, "t": t,
                "f32_vs_cpu_f64_normwise": errs,
                "bound": SAMEDIFF_TOL["f32_normwise"],
                "f32_forward_ms_first_call": fwd_ms,
                "launches": launches}


def sd_finetune(torch, np, sd, cfg, sync, peak, profile):
    """Part (b): ``attach_classifier_head`` and the bf16 fine-tune on the
    tiny-sentiment corpus through BertIterator at b ``b``, t ``t``: a
    warm-up step whose flash operands are replayed against the plain
    versions, then ``steps`` counted steps on one batch (K4, K5 and K6
    ``layers`` times a step each, K3 never), then the held-out accuracy.
    Returns (the row, the window's launches)."""
    from deeplearning4j_torch.autodiff import TrainingConfig
    from deeplearning4j_torch.data.bert_iterator import BertIterator
    from deeplearning4j_torch.data.tiny_sentiment import (make_tokenizer,
                                                          train_test_split)
    from deeplearning4j_torch.optimize.updaters import Adam
    from deeplearning4j_torch.utils.bert_fixture import (
        attach_classifier_head)
    fa = flash_module()
    b, t, steps, L = cfg["b"], cfg["t"], cfg["steps"], cfg["layers"]
    attach_classifier_head(sd)
    sd.set_training_config(TrainingConfig(
        updater=Adam(learning_rate=cfg["lr"]),
        data_set_feature_mapping=["i", "m", "t"],
        data_set_label_mapping=["labels"], compute_dtype="bfloat16"))
    tok = make_tokenizer()
    train, test = train_test_split()
    np.random.default_rng(7).shuffle(train)
    batch = next(iter(BertIterator(tok, train[:b], b, t)))
    valid = int(batch.features[1].sum())
    rec, restore = infer_capture(fa)
    try:
        warm = sd.fit([batch])
    finally:
        restore()
    want = {"flash_fwd": 0, "flash_fwd_single": steps * L,
            "flash_bwd_dkdv": steps * L, "flash_bwd_dq": steps * L}
    if set(rec) != {n for n, c in want.items() if c}:
        raise AssertionError(f"samediff/b: captured {sorted(rec)}")
    if rec["flash_bwd_dkdv"][1].get("need_dbias"):
        raise AssertionError("samediff/b: K5 asked for dBias")
    errs = infer_kernel_errors(torch, fa, rec)
    bad = {k: v for k, v in errs.items()
           if not (math.isfinite(v) and v <= FLASH_TOL["bfloat16"])}
    if bad:
        raise AssertionError(f"samediff/b: kernel vs plain {bad}")
    sync()
    fallback0 = fa._ROUTE_XLA_LONG_T.value
    interp0, runs0 = sd.run_stats["interpret_s"], sd.run_stats["runs"]
    peak(reset=True)
    sd_zero(fa)
    t0 = time.perf_counter()
    losses = sd.fit([batch] * steps)
    sync()
    wall = time.perf_counter() - t0
    counts = sd_counts(fa)
    if counts != want:
        raise AssertionError(f"samediff/b: launches {counts} != {want}")
    if fa._ROUTE_XLA_LONG_T.value != fallback0:
        raise AssertionError("samediff/b: long-t fallback")
    if not (all(math.isfinite(v) for v in losses) and
            losses[-1] < losses[0]):
        raise AssertionError(f"samediff/b: losses {losses}")
    step_s = sorted(sd.run_stats["step_s"][-steps:])
    step_ms = step_s[len(step_s) // 2] * 1e3
    interp_ms = (sd.run_stats["interpret_s"] - interp0) * 1e3 / steps
    # one training step alone (fit also copies every trained value back
    # to the host when it returns, which is not the step's work)
    names = ["i", "m", "t", "labels"]
    feeds = {n: sd._feed(x) for n, x in zip(
        names, list(batch.features) + list(batch.labels))}
    step_fn, _ = sd._train_step_fn(names)
    params = sd._device_params()
    prof = profile(lambda: float(step_fn(params, sd._updater_state,
                                         sd._step, feeds)[2]))
    hits = total = 0
    for tb in BertIterator(tok, test, b, t):
        ids, mask, tt = tb.features
        lg = sd.output({"i": ids, "m": mask, "t": tt}, ["logits"])["logits"]
        hits += int((lg.argmax(-1).cpu().numpy() == tb.labels[0]).sum())
        total += len(tb.labels[0])
    row = {"b": b, "t": t, "steps": steps, "warm_up_loss": warm[0],
           "losses": losses, "launches": counts,
           "kernel_vs_plain": errs, "tol": FLASH_TOL["bfloat16"],
           "step_ms_median": step_ms, "window_wall_s": wall,
           "padded_tokens_per_s": b * t / (step_ms / 1e3),
           "valid_tokens": valid, "valid_share": valid / (b * t),
           "valid_tokens_per_s": valid / (step_ms / 1e3),
           "interpreter_host_ms_per_step": interp_ms,
           "interpreter_runs": sd.run_stats["runs"] - runs0,
           "peak_bytes": peak(), "held_out_accuracy": hits / total,
           "held_out_sentences": total,
           "measure": ("step_ms: median of the counted steps' walls, each "
                       "ended by its loss's host read; interpreter: host "
                       "seconds inside SameDiff._run_graph (the forward "
                       "walk) per step")}
    if prof is not None:
        row["profile"] = prof
    return row, counts


def sd_goldens(torch, np, cfg, device, sync):
    """Part (c): the committed frozen fixtures on ``device`` against
    TensorFlow's goldens — bert_tiny unfused and fused, gpt_toy (t 512,
    causal) fused with the mask dropped on K4's causal route, then its
    3-step fine-tune on K4/K5/K6 — bert_tiny_sentiment imports and runs,
    and a zip saved from ``device`` loads on the CPU with equal outputs.
    Returns (the row, the fine-tune's launches)."""
    import tempfile
    from deeplearning4j_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_torch.autodiff.rewrites import optimize_for_tpu
    from deeplearning4j_torch.autodiff.tf_import import import_frozen_pb
    from deeplearning4j_torch.data import DataSet
    from deeplearning4j_torch.optimize.updaters import Adam
    fa = flash_module()
    fix = os.path.join(ROOT_DIR, SD_FIXTURES)
    tol = SAMEDIFF_TOL["golden"]
    row = {"tol": tol}
    g = np.load(os.path.join(fix, "golden.npz"))
    feeds = {"i": g["ids"], "m": g["mask"], "t": g["tt"]}
    for fused in (False, True):
        sd = import_frozen_pb(os.path.join(fix, "bert_tiny_frozen.pb"),
                              device=device)
        if fused:
            optimize_for_tpu(sd)
        out = sd.output(feeds, ["Identity", "Identity_1"])
        errs = {"last_hidden": float((out["Identity"].cpu() - torch.as_tensor(
                    g["last_hidden"])).abs().max()),
                "pooler": float((out["Identity_1"].cpu() - torch.as_tensor(
                    g["pooler"])).abs().max())}
        if not all(v <= tol for v in errs.values()):
            raise AssertionError(f"samediff/c: bert_tiny fused={fused} "
                                 f"{errs}")
        row[f"bert_tiny_{'fused' if fused else 'unfused'}"] = errs
    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "bert_tiny.sdz")
        sd.save(path)
        back = SameDiff.load(path, device="cpu").output(feeds, ["Identity"])
        row["zip_to_cpu_max_abs"] = float((back["Identity"] - out[
            "Identity"].cpu()).abs().max())
        if row["zip_to_cpu_max_abs"] > SAMEDIFF_TOL["zip"]:
            raise AssertionError(f"samediff/c: zip {row['zip_to_cpu_max_abs']}")
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    gg = np.load(os.path.join(fix, "gpt_toy_golden.npz"))
    gpt = import_frozen_pb(os.path.join(fix, "gpt_toy_frozen.pb"),
                           device=device)
    counts = optimize_for_tpu(gpt)
    nodes = [n for n in gpt.ops if n.op_name == "fused_attention"]
    if counts["attention"] != 2 or not all(
            n.attrs["causal"] and len(n.inputs) == 3 for n in nodes):
        raise AssertionError(f"samediff/c: gpt_toy fusion {counts}")
    sync()
    sd_zero(fa)
    out = gpt.output({"i": gg["ids"]}, ["Identity"])["Identity"]
    fwd = sd_counts(fa)
    err = float((out.cpu() - torch.as_tensor(gg["last_hidden"])).abs().max())
    if fwd["flash_fwd_single"] != 2 or err > tol:
        raise AssertionError(f"samediff/c: gpt_toy {fwd} err {err}")
    pooled = gpt.reduce_mean(gpt.vars["Identity"], axis=1)
    w = gpt.var("cls_W", np.random.default_rng(0).normal(
        scale=0.02, size=(64, 2)).astype(np.float32))
    labels = gpt.placeholder("labels", (None,), "int32")
    gpt.set_loss_variables(gpt.reduce_mean(gpt.op(
        "sparse_softmax_cross_entropy_with_logits", labels,
        gpt.matmul(pooled, w, name="logits")), name="loss"))
    gpt.set_training_config(TrainingConfig(
        updater=Adam(learning_rate=1e-3), data_set_feature_mapping=["i"],
        data_set_label_mapping=["labels"]))
    ids = np.random.default_rng(1).integers(0, 500, (2, 512)).astype(
        np.int32)
    sync()
    sd_zero(fa)
    losses = gpt.fit([DataSet(ids, np.asarray([0, 1], np.int32))],
                     n_epochs=cfg["gpt_steps"])
    sync()
    ft = sd_counts(fa)
    n = 2 * cfg["gpt_steps"]
    if ft != {"flash_fwd": 0, "flash_fwd_single": n, "flash_bwd_dkdv": n,
              "flash_bwd_dq": n}:
        raise AssertionError(f"samediff/c: gpt_toy fine-tune {ft}")
    if not (all(math.isfinite(v) for v in losses) and
            losses[-1] < losses[0]):
        raise AssertionError(f"samediff/c: gpt_toy losses {losses}")
    row["gpt_toy"] = {"rewrites": counts, "max_abs_err": err,
                      "forward_launches": fwd, "finetune_launches": ft,
                      "finetune_losses": losses}
    sent = import_frozen_pb(os.path.join(
        fix, "bert_tiny_sentiment_frozen.pb"), device=device)
    sc = optimize_for_tpu(sent)
    o = sent.output(feeds, ["Identity_1"])["Identity_1"]
    if tuple(o.shape) != (2, 64) or not bool(torch.isfinite(o).all()):
        raise AssertionError(f"samediff/c: sentiment {tuple(o.shape)}")
    row["bert_tiny_sentiment"] = {"rewrites": sc, "pooler_shape": list(
        o.shape)}
    return row, ft


def sd_onnx_models(np):
    """{name: (ONNX model dict, feeds, outputs)}: an MLP with Gemm, a small
    CNN and the attention block of tests/test_onnx_import.py, seeded."""
    from deeplearning4j_torch.autodiff import onnx_serde as O
    r = np.random.default_rng(3)

    def f32(*s):
        return r.normal(size=s).astype(np.float32)
    mlp = O.model(
        [O.node("Gemm", ["x", "w0", "b0"], ["h0"], transB=1),
         O.node("Relu", ["h0"], ["a0"]),
         O.node("Gemm", ["a0", "w1", "b1"], ["out"], transB=1)],
        [O.value_info("x", (None, 6))], [O.value_info("out", (None, 3))],
        [O.tensor("w0", f32(16, 6)), O.tensor("b0", f32(16)),
         O.tensor("w1", f32(3, 16)), O.tensor("b1", f32(3))])
    cnn = O.model(
        [O.node("Conv", ["x", "cw", "cb"], ["c"], strides=[1, 1],
                pads=[1, 1, 1, 1], group=1, dilations=[1, 1]),
         O.node("BatchNormalization", ["c", "g", "beta", "mu", "var"],
                ["bn"], epsilon=1e-5),
         O.node("Relu", ["bn"], ["rl"]),
         O.node("MaxPool", ["rl"], ["p"], kernel_shape=[2, 2],
                strides=[2, 2]),
         O.node("GlobalAveragePool", ["p"], ["gap"]),
         O.node("Flatten", ["gap"], ["fl"], axis=1),
         O.node("Gemm", ["fl", "fw", "fb"], ["out"], transB=1)],
        [O.value_info("x", (None, 3, 8, 8))],
        [O.value_info("out", (None, 4))],
        [O.tensor("cw", f32(8, 3, 3, 3)), O.tensor("cb", f32(8)),
         O.tensor("g", f32(8)), O.tensor("beta", f32(8)),
         O.tensor("mu", f32(8) * 0.1),
         O.tensor("var", np.abs(f32(8)) + 0.5),
         O.tensor("fw", f32(4, 8)), O.tensor("fb", f32(4))])
    d = 8
    att = O.model(
        [O.node("MatMul", ["x", "wq"], ["q"]),
         O.node("MatMul", ["x", "wk"], ["k"]),
         O.node("MatMul", ["x", "wv"], ["v"]),
         O.node("Transpose", ["k"], ["kT"], perm=[0, 2, 1]),
         O.node("MatMul", ["q", "kT"], ["qk"]),
         O.node("Mul", ["qk", "scale"], ["scaled"]),
         O.node("Softmax", ["scaled"], ["probs"], axis=-1),
         O.node("MatMul", ["probs", "v"], ["ctx"]),
         O.node("LayerNormalization", ["ctx", "ln_g", "ln_b"], ["out"],
                axis=-1, epsilon=1e-5)],
        [O.value_info("x", (2, 6, d))], [O.value_info("out", (2, 6, d))],
        [O.tensor("wq", f32(d, d)), O.tensor("wk", f32(d, d)),
         O.tensor("wv", f32(d, d)), O.tensor("ln_g", f32(d)),
         O.tensor("ln_b", f32(d)),
         O.tensor("scale", np.float32(1.0 / np.sqrt(d)))])
    return {"mlp": (mlp, {"x": f32(5, 6)}, ["out"]),
            "cnn": (cnn, {"x": f32(2, 3, 8, 8)}, ["out"]),
            "attention": (att, {"x": f32(2, 6, d)}, ["out"])}


def sd_onnx(torch, np, device):
    """Part (d): each model written to bytes, read back, imported on
    ``device`` and on the CPU; outputs held to ``SAMEDIFF_TOL["onnx"]``;
    the attention block rewrites to zero fused sites, as the reference's
    does."""
    from deeplearning4j_torch.autodiff import onnx_serde as O
    from deeplearning4j_torch.autodiff.onnx_import import import_onnx_model
    from deeplearning4j_torch.autodiff.rewrites import optimize_for_tpu
    row = {"tol": SAMEDIFF_TOL["onnx"]}
    for name, (model, feeds, outs) in sd_onnx_models(np).items():
        raw = O.encode(model, O.MODEL)
        back = O.decode(raw, O.MODEL)
        res = {}
        for dev in (device, "cpu"):
            sd = import_onnx_model(back, device=dev)
            res[dev] = sd.output(feeds, outs)[outs[0]].cpu()
        err = float((res[device] - res["cpu"]).abs().max())
        if not err <= SAMEDIFF_TOL["onnx"]:
            raise AssertionError(f"samediff/d: {name} {err}")
        row[name] = {"bytes": len(raw), "max_abs_card_vs_cpu": err}
    sd = import_onnx_model(sd_onnx_models(np)["attention"][0], device=device)
    counts = optimize_for_tpu(sd)
    if counts["attention"] != 0 or counts["parallel_matmuls"] != 1:
        raise AssertionError(f"samediff/d: attention block {counts}")
    row["attention"]["rewrites"] = counts
    return row


def sd_datavec(torch, np, cfg, device, sync):
    """Part (e): a seeded CSV (4 doubles, a 3-way categorical, the label,
    some rows with a missing value) through CSVRecordReader ->
    TransformProcess (filter_invalid, categorical_to_one_hot,
    categorical_to_integer) -> RecordReaderDataSetIterator ->
    AsyncDataSetIterator -> MultiLayerNetwork.fit on ``device``: rows/s of
    the ETL alone and of the fit, accuracy before and after."""
    import shutil
    import tempfile
    from deeplearning4j_torch.data.iterator import AsyncDataSetIterator
    from deeplearning4j_torch.datavec import (CSVRecordReader,
                                              RecordReaderDataSetIterator,
                                              Schema, TransformProcess)
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf import (DenseLayer,
                                              NeuralNetConfiguration,
                                              OutputLayer)
    from deeplearning4j_torch.optimize.updaters import Adam
    n = cfg["csv_rows"]
    r = np.random.default_rng(cfg["seed"] + 5)
    x = r.normal(size=(n, 4))
    colors = np.asarray(["red", "green", "blue"])[r.integers(0, 3, n)]
    y = (x @ np.asarray([1.0, -1.0, 0.5, 0.2])
         + 0.8 * (colors == "red")) > 0.2
    missing = r.random(n) < 0.02
    lines = [("" if miss else f"{row[0]:.6f}") + ","
             + ",".join(f"{v:.6f}" for v in row[1:])
             + f",{c},{'pos' if lab else 'neg'}"
             for row, c, lab, miss in zip(x, colors, y, missing)]
    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "train.csv")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        schema = (Schema.builder().add_column_double("a", "b", "c", "d")
                  .add_column_categorical("color", ["red", "green", "blue"])
                  .add_column_categorical("label", ["neg", "pos"]).build())
        tp = (TransformProcess.builder(schema).filter_invalid("a")
              .categorical_to_one_hot("color")
              .categorical_to_integer("label").build())
        it = RecordReaderDataSetIterator(
            CSVRecordReader(path), batch_size=cfg["csv_batch"],
            label_index=-1, n_classes=2, transform_process=tp)
        t0 = time.perf_counter()
        kept = sum(ds.num_examples() for ds in it)
        etl_s = time.perf_counter() - t0
        if kept != n - int(missing.sum()):
            raise AssertionError(f"samediff/e: {kept} rows kept")
        conf = (NeuralNetConfiguration.builder().seed(3)
                .updater(Adam(learning_rate=0.01)).list()
                .layer(DenseLayer(n_in=7, n_out=32, activation="relu"))
                .layer(OutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent")).build())
        net = MultiLayerNetwork(conf).init(device=device)
        before = net.evaluate(it).accuracy()
        sync()
        t0 = time.perf_counter()
        net.fit(AsyncDataSetIterator(it), n_epochs=cfg["csv_epochs"])
        sync()
        fit_s = time.perf_counter() - t0
        after = net.evaluate(it).accuracy()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not (after > before and after > 0.9):
        raise AssertionError(f"samediff/e: accuracy {before} -> {after}")
    return {"rows": n, "rows_kept": kept, "etl_rows_per_s": kept / etl_s,
            "fit_rows_per_s": kept * cfg["csv_epochs"] / fit_s,
            "epochs": cfg["csv_epochs"], "accuracy_before": before,
            "accuracy_after": after}


def samediff_parts(torch, np, device, cfg, sync, card, peak, profile):
    """Parts (a)-(e) of :func:`phase_samediff` on ``device`` at ``cfg``'s
    sizes.  Emits one row; returns the launch counts of (b)'s window and
    (c)'s fine-tune."""
    t_phase = time.perf_counter()
    side = json.load(open(os.path.join(
        ROOT_DIR, cfg["graph"][:-3] + ".json")))
    cfg = dict(cfg, vocab=side["config"]["vocab_size"])
    values = sd_sidecar_values(np, side, cfg["seed"])
    row = {"phase": "samediff", "card": card}
    sd, row["a_import_forward"] = sd_base_forward(torch, np, cfg, device,
                                                  sync, values)
    row["b_finetune"], b_counts = sd_finetune(torch, np, sd, cfg, sync,
                                              peak, profile)
    del sd
    row["c_goldens"], c_counts = sd_goldens(torch, np, cfg, device, sync)
    row["d_onnx"] = sd_onnx(torch, np, device)
    row["e_datavec"] = sd_datavec(torch, np, cfg, device, sync)
    row["reduced"] = [
        "graph-only BERT-base: its weights seeded from the sidecar "
        "(N(0, 0.02), ones, zeros), no pretrained checkpoint",
        f"{cfg['steps']} steps on one batch, not an SST-2 epoch: the "
        "tiny-sentiment corpus stands in for SST-2, which is not in the "
        "repo"]
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    return {"bert": b_counts, "gpt_toy": c_counts}


def phase_samediff(torch, np):
    """Graph import on the card (phase 9c; BASELINE config 3): (a) the
    graph-only BERT-base imported through tf_serde, seeded from its
    sidecar, rewritten by optimize_for_tpu (the reference's counts, 12
    fused sites), its f32 forward at b 2 against the port on the CPU in
    f64; (b) the bf16 fine-tune (Adam 2e-5, b 40, t 512, tiny-sentiment
    through BertIterator): K4, K5 (no dBias) and K6 12 times a step,
    held to their plain versions on the warm-up's operands, step ms,
    tokens/s, busy share, interpreter host ms, peak memory, held-out
    accuracy; (c) the committed fixtures against TensorFlow's goldens,
    gpt_toy on K4's causal route and its fine-tune on K4/K5/K6, a zip
    saved on the card loaded on the CPU; (d) ONNX models card against
    CPU, no fused sites on the attention block; (e) a CSV through
    DataVec into MultiLayerNetwork.fit.  Returns the launch counts."""
    def peak(reset=False):
        if reset:
            torch.cuda.reset_peak_memory_stats()
            return None
        return torch.cuda.max_memory_allocated()
    try:
        return samediff_parts(torch, np, "cuda", SAMEDIFF_CFG,
                              torch.cuda.synchronize, card_line(), peak,
                              lambda step: step_profile(torch, step))
    finally:
        torch.cuda.empty_cache()


# -- phase 9d (mesh) -----------------------------------------------------
# The mesh slice on one card listed twice (or four times): a tp = 2
# replica of full-width Gpt() (12 x 768, 6 heads of 128, vocab 32000);
# Gpt() trained at b 8, t 2048 (and t 512) under data, model and pipeline
# axes; BASELINE config 5's data-parallel ResNet-50 (global b 256, 224 x
# 224, bf16, AdaDelta) with the two data shards' batches drawn apart so
# per-shard batch statistics would differ from the global ones; ring
# attention at b 2, 12 x 64, t 4096 over 4 sequence shards; and one
# torch.distributed world over NCCL.  The CPU rehearsal passes smaller
# sizes (tests/test_torch_parallel.py).
MESH_CFG = {"gpt": {}, "vocab": 32000, "n_slots": 8, "max_len": 1024,
            "block_size": 16, "tick_batch": 8, "tp": 2,
            "f32_requests": 4, "f32_new": 32, "mixed_requests": 16,
            "spec": {"k": 4, "rounds": 2, "draft_layers": 2},
            "train_b": 8, "train_t": 2048, "short_t": 512, "dp_steps": 5,
            "tp_steps": 2, "pp_steps": 2, "short_steps": 2, "n_micro": 4,
            "resnet_b": 256, "resnet_hw": 224, "resnet_steps": 3,
            "resnet_shift": 0.5, "ring": {"b": 2, "h": 12, "dh": 64,
                                          "t": 4096, "seq": 4},
            "world_gpt": {"vocab_size": 512, "max_len": 128, "d_model": 256,
                          "n_layers": 4, "n_heads": 4, "d_ff": 1024,
                          "seq_len": 128},
            "world_b": 8, "world_batches": 4}
# Tolerances, each set between the sound run's reading and that of a
# control that breaks one thing at the phase's own sizes (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md §6).  Gpt() DP losses against the
# unsharded fit: 2e-4 relative (sound 1.4e-5; a shard's gradient dropped
# 5.6e-4, no copy to the replica 5.3e-4); the first step's summed
# gradient against the unsharded one, normwise: 5e-2 (sound 2.3e-3,
# dropped 0.70), and every replica bit-equal to the master (no copy:
# unequal).  ResNet-50's first loss against one device's: 1e-3 (sound
# 0.0, per-shard batch statistics 3.9e-3); its running means after one
# step, normwise over every batch norm: 1e-3 (sound 1.0e-7, per-shard
# 1.5e-2).  Ring attention in f32 (TF32 off) against one softmax:
# outputs 1e-5 of each element's size (flash_err), gradients 1e-4.
MESH_TOL = {"train_loss": 2e-4, "train_grad": 5e-2, "resnet_loss": 1e-3,
            "resnet_bn": 1e-3, "ring_out": 1e-5, "ring_grad": 1e-4}


def mesh_k_counts(pa, fa):
    return {"paged_decode_attention": pa.paged_decode_attention.launches,
            "paged_verify_attention": pa.paged_verify_attention.launches,
            **{n: getattr(fa, n).launches for n in FLASH_WRAPPERS}}


def mesh_zero(pa, fa):
    pa.paged_decode_attention.launches = 0
    pa.paged_verify_attention.launches = 0
    for n in FLASH_WRAPPERS:
        getattr(fa, n).launches = 0


def mesh_shard_kernels(torch, pa, ctx, device, h, dh, bs, mb, W=5,
                       seed=11):
    """K1 and K2 at one tp shard's call shape (h heads of dh, 8 slots,
    bf16, the shard ctx's chunk) against their plain versions."""
    g = torch.Generator(device=device).manual_seed(seed)
    B, dtype = 8, torch.bfloat16
    nb = 1 + B * mb
    kp = torch.randn((nb, h, bs, dh), generator=g, device=device).to(dtype)
    vp = torch.randn((nb, h, bs, dh), generator=g, device=device).to(dtype)
    table = (torch.randperm(nb - 1, generator=g, device=device)[:B * mb]
             .reshape(B, mb) + 1).to(torch.int32)
    pos = torch.randint(W, mb * bs - W, (B,), generator=g, device=device,
                        dtype=torch.int32)
    scale = dh ** -0.5
    q = torch.randn((B, h, dh), generator=g, device=device).to(dtype)
    rows = (B * ctx.data, h * ctx.tp)       # the replica's slots, heads
    out = pa.paged_decode_attention(q, kp, vp, table, pos, scale,
                                    split_rows=rows)
    ref = pa.paged_decode_attention_reference(q, kp, vp, table, pos, scale)
    k1 = flash_err(torch, out.float(), ref.float())[0]
    qv = torch.randn((B, W, h, dh), generator=g, device=device).to(dtype)
    out = pa.paged_verify_attention(qv, kp, vp, table, pos, scale,
                                    split_rows=rows)
    ref = pa.paged_verify_attention_reference(qv, kp, vp, table, pos, scale)
    k2 = flash_err(torch, out.float(), ref.float())[0]
    for name, err, tol in (("K1", k1, PAGED_TOL["K1"]["bfloat16"]),
                           ("K2", k2, PAGED_TOL["K2"]["bfloat16"])):
        if not err <= tol:
            raise AssertionError(f"mesh/serve: {name} at a shard's shape "
                                 f"(h {h}, dh {dh}) vs plain {err} > {tol}")
    return {"K1": k1, "K2": k2, "h": h, "dh": dh, "slots": B,
            "chunk": pa.decode_chunk(q, kp, table, rows),
            "verify_chunk": pa.verify_chunk(qv, kp, table, rows)}


def mesh_sampled_ties(torch, np, gen, reqs, outs, refs):
    """Sampled streams against the tp = 1 server's, draw by draw: every
    draw is argmax(filtered logits / T + Gumbel noise of (seed, position))
    on both sides, so two streams may part only where the two drawn
    tokens' perturbed scores lie within the near-tie rule's margin / T —
    the same law up to rounding.  Returns the divergences."""
    from deeplearning4j_torch.models.generation import (_filter_logits_rows,
                                                        _gumbel_rows)
    from deeplearning4j_torch.parallel.generation_server import (
        STREAM_SAMPLE)
    emb_p, blk_ps, head_p = gen._serving_params()
    ties = []
    for (p, n, s), a, b in zip(reqs, outs, refs):
        if s is None or (a.shape == b.shape and (a == b).all()):
            continue
        i = int(next(j for j in range(min(len(a), len(b))) if a[j] != b[j]))
        ctx = torch.as_tensor(a[None, :i].astype("int64"),
                              device=gen.device)
        lg = gen._prefill_rows(emb_p, blk_ps, head_p, ctx)[0].float()
        V, dev = lg.shape[-1], lg.device
        temp = float(s["temperature"])
        f = _filter_logits_rows(
            lg / temp, torch.tensor([s.get("top_k") or V], device=dev),
            torch.tensor([s.get("top_p") or 1.0], device=dev))
        one = lambda v: torch.tensor([v], dtype=torch.int64,  # noqa: E731
                                     device=dev)
        score = (f + _gumbel_rows(one(s["seed"]), one(STREAM_SAMPLE),
                                  one(i), V))[0]
        margin = float((score[int(a[i])] - score[int(b[i])]).abs())
        if not margin <= NEAR_TIE_BF16 / temp:
            raise AssertionError(f"mesh/serve: a sampled stream parts from "
                                 f"tp = 1's at {i} with perturbed-score "
                                 f"margin {margin} > {NEAR_TIE_BF16 / temp}")
        ties.append({"index": i, "margin": margin})
    return ties


def mesh_serve(torch, np, pa, fa, net, cfg, devs, sync):
    """Part (a): the tp = 2 replica (and, in f32, a data = 2 x tp = 2
    one) against the tp = 1 one."""
    from deeplearning4j_torch import telemetry
    from deeplearning4j_torch.models.generation import TransformerGenerator
    from deeplearning4j_torch.parallel import GenerationServer
    from deeplearning4j_torch.parallel.mesh import TpShardCtx, serving_mesh
    ticks = telemetry.get_registry().counter(
        "generation_server_ticks_total")
    tp, vocab = cfg["tp"], cfg["vocab"]
    dev = devs[0]
    n_layers = len(net.layers) - 2
    h = net.layers[1].n_heads
    kw = dict(n_slots=cfg["n_slots"], max_len=cfg["max_len"],
              block_size=cfg["block_size"], tick_batch=cfg["tick_batch"])
    row = {}
    # (a1) f32 greedy, tp = 2 against tp = 1
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, vocab, int(t)).astype(np.int32),
             cfg["f32_new"], None)
            for t in rng.integers(64, 769, cfg["f32_requests"])]
    with GenerationServer(net, compute_dtype=None, device=dev, **kw) as s1:
        one, _, _ = serve(s1, reqs)
    with GenerationServer(net, compute_dtype=None, devices=devs[:tp],
                          tp=tp, **kw) as s2:
        mesh_zero(pa, fa)
        k0 = ticks.value
        two, _, _ = serve(s2, reqs)
        sync()
        f32_k1, f32_ticks = pa.paged_decode_attention.launches, \
            ticks.value - k0
    gen = TransformerGenerator(net, device=dev)
    row["f32"] = {"requests": len(reqs),
                  "near_ties": check_streams(torch, gen,
                                             list(zip(two, one)),
                                             NEAR_TIE_F32),
                  "k1_launches": f32_k1, "ticks": f32_ticks}
    if f32_k1 < n_layers * tp * f32_ticks:
        raise AssertionError(f"mesh/serve f32: {f32_k1} K1 launches < "
                             f"{n_layers} layers x {tp} shards x "
                             f"{f32_ticks} ticks")
    # (a1') the same at data = 2 x tp: each data row decodes its half of
    # the slots on its own tp shards and pool replica
    with GenerationServer(net, compute_dtype=None, devices=devs[:2 * tp],
                          tp=tp, **kw) as s4:
        mesh_zero(pa, fa)
        k0 = ticks.value
        four, _, _ = serve(s4, reqs)
        sync()
        d2_k1, d2_ticks = pa.paged_decode_attention.launches, \
            ticks.value - k0
    row["f32_data2"] = {"requests": len(reqs), "data": 2, "tp": tp,
                        "near_ties": check_streams(torch, gen,
                                                   list(zip(four, one)),
                                                   NEAR_TIE_F32),
                        "k1_launches": d2_k1, "ticks": d2_ticks}
    if d2_k1 < n_layers * 2 * tp * d2_ticks:
        raise AssertionError(f"mesh/serve f32 data 2: {d2_k1} K1 launches "
                             f"< {n_layers} layers x 2 rows x {tp} shards "
                             f"x {d2_ticks} ticks")
    # (a2) bf16, phase 4(b)'s mix: tp = 1 then tp = 2
    system, reqs = mixed_requests(np, vocab)
    reqs = reqs[:cfg["mixed_requests"]]
    warm = np.concatenate([system, [7, 7, 7]]).astype(np.int32)
    runs = {}
    for name, extra in (("tp1", dict(device=dev)),
                        ("tp2", dict(devices=devs[:tp], tp=tp))):
        with GenerationServer(net, compute_dtype="bfloat16", **kw,
                              **extra) as srv:
            srv.submit(warm, 8)
            sync()
            mesh_zero(pa, fa)
            k0 = ticks.value
            outs, ttfts, wall = serve(srv, reqs)
            sync()
            runs[name] = {"outs": outs, "wall": wall, "ttfts": ttfts,
                          "ticks": ticks.value - k0,
                          "k1": pa.paged_decode_attention.launches}
    check_finished(reqs, runs["tp2"]["outs"], vocab)
    gen16 = TransformerGenerator(net, compute_dtype="bfloat16", device=dev)
    greedy = [(b, a) for (p, n, s), a, b in
              zip(reqs, runs["tp1"]["outs"], runs["tp2"]["outs"])
              if s is None]
    ties = check_streams(torch, gen16, greedy, NEAR_TIE_BF16)
    sampled_ties = mesh_sampled_ties(torch, np, gen16, reqs,
                                     runs["tp2"]["outs"],
                                     runs["tp1"]["outs"])
    t2 = runs["tp2"]
    if t2["k1"] < n_layers * tp * t2["ticks"]:
        raise AssertionError(f"mesh/serve bf16: {t2['k1']} K1 launches < "
                             f"{n_layers} x {tp} x {t2['ticks']} ticks")
    new_tokens = sum(n for _, n, _ in reqs)
    row["bf16"] = {
        "requests": len(reqs), "new_tokens": new_tokens,
        "greedy_near_ties": ties,
        "sampled_near_ties": sampled_ties,
        "sampled_equal": sum(1 for (p, n, q), a, b in
                             zip(reqs, runs["tp1"]["outs"],
                                 runs["tp2"]["outs"])
                             if q is not None and a.shape == b.shape
                             and (a == b).all()),
        "tp1": {"seconds": runs["tp1"]["wall"],
                "new_tokens_per_s": new_tokens / runs["tp1"]["wall"],
                "ticks": runs["tp1"]["ticks"], "k1_launches":
                    runs["tp1"]["k1"]},
        "tp2": {"seconds": t2["wall"],
                "new_tokens_per_s": new_tokens / t2["wall"],
                "ttft_p50_s": pct(t2["ttfts"], 0.5),
                "ticks": t2["ticks"], "k1_launches": t2["k1"],
                "k1_launches_per_shard": t2["k1"] / tp},
        "note": "one card driven as two shards: no scaling figure"}
    # (a3) speculative tp = 2 (greedy requests) against tp = 1 bf16
    greedy_reqs = [r for r in reqs if r[2] is None]
    with GenerationServer(net, compute_dtype="bfloat16", devices=devs[:tp],
                          tp=tp, speculative=cfg["spec"], **kw) as srv:
        srv.submit(warm, 8)
        sync()
        mesh_zero(pa, fa)
        p0 = ticks.value
        outs, _, wall = serve(srv, greedy_reqs)
        sync()
        passes = ticks.value - p0
        k2 = pa.paged_verify_attention.launches
        st = srv.stats()
    refs = [a for (p, n, s), a in zip(reqs, runs["tp1"]["outs"])
            if s is None]
    sties = check_streams(torch, gen16, list(zip(outs, refs)),
                          NEAR_TIE_BF16)
    if not (k2 > 0 and k2 == n_layers * tp * passes):
        raise AssertionError(f"mesh/serve spec: {k2} K2 launches != "
                             f"{n_layers} x {tp} x {passes} verify passes")
    row["spec"] = {"speculative": cfg["spec"], "requests": len(greedy_reqs),
                   "verify_passes": passes, "k2_launches": k2,
                   "k2_launches_per_shard": k2 / tp,
                   "acceptance_rate": st["spec_acceptance_rate"],
                   "near_ties": sties, "seconds": wall}
    ctx = TpShardCtx(serving_mesh(devs[:tp], tp))
    row["shard_kernels"] = mesh_shard_kernels(
        torch, pa, ctx, dev, h // tp, net.layers[0].n_out // h,
        cfg["block_size"], cfg["max_len"] // cfg["block_size"])
    counts = {"f32": {"paged_decode_attention": f32_k1},
              "f32_data2": {"paged_decode_attention": d2_k1},
              "bf16": {"paged_decode_attention": t2["k1"]},
              "spec": {"paged_verify_attention": k2}}
    return row, counts


def mesh_train(torch, np, fa, cfg, devs, sync, peak):
    """Part (b): Gpt() under data, model and pipeline axes, each run's
    losses against the unsharded fit's on the same batches, every flash
    launch of a step counted and one of each held to its plain version."""
    from deeplearning4j_torch.data import DataSet
    from deeplearning4j_torch.parallel import MeshConfig, ShardedTrainer
    from deeplearning4j_torch.zoo import Gpt
    b, out, counts = cfg["train_b"], {}, {}
    dev = devs[0]

    def batches(t, n):
        return [train_batch(np, b, t, cfg["vocab"], 20 + i)
                for i in range(n)]

    def run(t, mesh, steps, tag, fault=None, probe=False):
        """(losses, step ms, counts per step, kernel errors); ``fault``
        (a control run) breaks the sharded step with :func:`mesh_fault`;
        ``probe`` keeps the first step's gradients (``first_grads``) and
        reads whether every data replica equals the master at the end."""
        net = Gpt(**dict(cfg["gpt"], seed=0, seq_len=t)).init_graph(
            device=dev)
        data = batches(t, steps + 1)
        tr = None
        if mesh is None:
            net._build_solver()
            solver = net._solver
            step = lambda x, y: net.fit(DataSet(x, y))  # noqa: E731
        else:
            tr = ShardedTrainer(net, mesh, devices=devs,
                                n_micro=cfg["n_micro"])
            solver = tr.solver
            step = lambda x, y: float(tr.fit_batch(x, y))  # noqa: E731
            if fault:
                mesh_fault(fault, net, tr)
        kept = mesh_grad_probe(solver) if probe else None
        rec, restore = (None, lambda: None) if fault else infer_capture(fa)
        try:
            warm = step(*data[0])                # also captures operands
        finally:
            restore()
        errs = infer_kernel_errors(torch, fa, rec) if rec else {}
        sync()
        peak(reset=True)
        mesh_zero(pa_module(), fa)
        t0 = time.perf_counter()
        losses = [step(*xy) for xy in data[1:]]
        sync()
        wall = time.perf_counter() - t0
        cnt = {n: getattr(fa, n).launches for n in FLASH_WRAPPERS}
        res = {"warmup_loss": warm, "losses": losses,
               "step_ms": wall * 1e3 / steps,
               "tokens_per_s": steps * b * t / wall,
               "peak_allocated_bytes": peak(),
               "launches_per_step": {k: v / steps for k, v in cnt.items()},
               "kernel_vs_plain": errs}
        if probe:
            res["first_grads"] = kept
            if tr is not None:
                res["replicas_equal_master"] = all(
                    torch.equal(a, m) for r in range(1, tr.n_data)
                    for a, m in zip(tr._flat(tr._store[r]),
                                    tr._flat(tr._store[0])))
        del net, tr
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return res, cnt

    def loss_err(res, ref, steps):
        return max(abs(a - c) / abs(c) for a, c in
                   zip([res["warmup_loss"]] + res["losses"],
                       [ref["warmup_loss"]] + ref["losses"][:steps]))

    def grad_err(res, ref):
        """The first step's summed data-parallel gradient against the
        unsharded one, normwise over every leaf."""
        num = sum(float((a - c).square().sum()) for a, c in
                  zip(res.pop("first_grads"), ref["first_grads"]))
        den = sum(float(c.square().sum()) for c in ref["first_grads"])
        return math.sqrt(num / max(den, 1e-30))

    def misses(res, ref):
        """What the phase's checks of a data=2 run read, and which of
        them a control trips."""
        got = {"loss_max_rel_diff": loss_err(res, ref, cfg["dp_steps"]),
               "first_grad_normwise_diff": grad_err(res, ref),
               "replicas_equal_master": res["replicas_equal_master"]}
        tripped = [k for k, lim in (
            ("loss_max_rel_diff", MESH_TOL["train_loss"]),
            ("first_grad_normwise_diff", MESH_TOL["train_grad"]))
            if not got[k] <= lim]
        if not got["replicas_equal_master"]:
            tripped.append("replicas_equal_master")
        return got, tripped

    t, ts = cfg["train_t"], cfg["short_t"]
    n_layers = Gpt(**cfg["gpt"]).n_layers
    # the unsharded fit on the same init and batches, once per length
    refs = {t: run(t, None, max(cfg["dp_steps"], cfg["tp_steps"],
                                cfg["pp_steps"], cfg["short_steps"]),
                   "single", probe=True)[0]}
    if ts not in refs:
        refs[ts] = run(ts, None, cfg["short_steps"], "single")[0]
    for tag, tt, mesh, steps in (
            ("dp", t, MeshConfig(data=2), cfg["dp_steps"]),
            ("tp", t, MeshConfig(model=2), cfg["tp_steps"]),
            ("pp", t, MeshConfig(pipeline=2), cfg["pp_steps"]),
            ("dp_t512", ts, MeshConfig(data=2), cfg["short_steps"])):
        ref = refs[tt]
        res, cnt = run(tt, mesh, steps, tag, probe=tag == "dp")
        err = loss_err(res, ref, steps)
        if tag == "dp":
            checks, tripped = misses(res, ref)
            if tripped:
                raise AssertionError(f"mesh/train dp: {tripped} of "
                                     f"{checks}")
            res.update(checks)
        bad = [k for k, v in res["kernel_vs_plain"].items()
               if not v <= FLASH_TOL["bfloat16"]]
        if not (all(math.isfinite(x) for x in res["losses"])
                and err <= MESH_TOL["train_loss"] and not bad):
            raise AssertionError(f"mesh/train {tag}: losses {res['losses']}"
                                 f" vs unsharded {ref['losses']} (max rel "
                                 f"{err}), kernels over the bound {bad}")
        fwd = "flash_fwd" if tt >= 1024 else "flash_fwd_single"
        per = {"dp": 2 * n_layers, "tp": n_layers,
               "pp": cfg["n_micro"] * n_layers,
               "dp_t512": 2 * n_layers}[tag]
        want = {n: (per * steps if n in (fwd, "flash_bwd_dkdv",
                                         "flash_bwd_dq") else 0)
                for n in FLASH_WRAPPERS}
        if cnt != want:
            raise AssertionError(f"mesh/train {tag}: launches {cnt} != "
                                 f"{want}")
        out[tag] = dict(res, t=tt, mesh=mesh.__dict__, steps=steps,
                        loss_max_rel_diff=err)
        if tag == "pp":
            from deeplearning4j_torch.parallel.pipeline import _PIPE_BUBBLE
            out[tag]["pipeline_bubble_fraction"] = _PIPE_BUBBLE.value
        counts[tag] = cnt
    # controls: the data=2 run with one fault each must miss the
    # unsharded losses by more than the limit the sound run keeps
    out["controls"] = {}
    for fault in ("grad", "stale"):
        res, _ = run(t, MeshConfig(data=2), cfg["dp_steps"], "dp", fault,
                     probe=True)
        checks, tripped = misses(res, refs[t])
        if not tripped:
            raise AssertionError(f"mesh/train control {fault}: every "
                                 f"check passed {checks}")
        out["controls"][f"dp_{fault}"] = dict(checks, tripped=tripped,
                                              losses=res["losses"])
    refs[t].pop("first_grads")
    out["unsharded"] = {str(k): v for k, v in refs.items()}
    return out, counts


def mesh_grad_probe(solver):
    """Keep the gradients of ``solver``'s first step: f32 copies, in
    ``iter_leaves`` order (the list returned fills on that step)."""
    from deeplearning4j_torch.utils.trees import iter_leaves
    kept, real = [], solver.apply_grads

    def apply(params, opt, state, new_state, grads, *a, **kw):
        if not kept:
            kept.extend(g.detach().float().clone()
                        for _, g in iter_leaves(grads))
        return real(params, opt, state, new_state, grads, *a, **kw)
    solver.apply_grads = apply
    return kept


def mesh_fault(kind, net, tr):
    """Break a data-parallel step for a control run.  ``grad``: shard 1's
    loss is detached, so its gradient never reaches the sum (the loss it
    reports is unchanged); ``stale``: the updated master parameters are
    not copied into the other replica, which goes on from the init."""
    from deeplearning4j_torch.runtime import spmd
    if kind == "grad":
        score = net._score_batch

        def detached(*a, **kw):
            loss, state = score(*a, **kw)
            info = spmd.current()
            return (loss.detach() if info is not None and info.rank == 1
                    else loss), state
        net._score_batch = detached
    elif kind == "stale":
        tr._broadcast = lambda: None
    else:
        raise ValueError(f"unknown fault {kind!r}")


def mesh_local_bn():
    """A control's context: batch norm inside a data shard takes the
    shard's OWN statistics (no sum over the shards, the shard's count),
    as a trainer without sync-BN would.  Returns the undo."""
    from deeplearning4j_torch.nn.conf import layers_conv
    real = layers_conv.spmd

    class Local:
        all_reduce_sum = staticmethod(list)
        shard_rows = staticmethod(lambda n: (0, n))
    layers_conv.spmd = Local

    def undo():
        layers_conv.spmd = real
    return undo


def pa_module():
    import importlib
    return importlib.import_module(
        "deeplearning4j_torch.kernels.paged_attention")


def mesh_resnet(torch, np, cfg, devs, sync, peak):
    """Part (c), BASELINE config 5: ResNet50 under MeshConfig(data=2) at
    global b ``resnet_b``, the two shards' halves drawn apart by
    ``resnet_shift``; the first loss and the running statistics after one
    step against one device's on the same batch (sync-BN), then
    ``resnet_steps`` finite steps; images/s and peak memory."""
    from deeplearning4j_torch.data import DataSet
    from deeplearning4j_torch.parallel import MeshConfig, ShardedTrainer
    from deeplearning4j_torch.utils.trees import iter_leaves
    from deeplearning4j_torch.zoo import ResNet50
    b, hw, dev = cfg["resnet_b"], cfg["resnet_hw"], devs[0]
    g = torch.Generator(device=dev).manual_seed(0)
    xs = []
    for _ in range(cfg["resnet_steps"]):
        x = torch.randn((b, hw, hw, 3), generator=g, device=dev)
        x[: b // 2] += cfg["resnet_shift"]
        xs.append(x.to(torch.bfloat16))
    y = np.eye(1000, dtype=np.float32)[
        np.random.default_rng(0).integers(0, 1000, b)]

    def bn_means(net):
        return {p: leaf.float().clone() for p, leaf in
                iter_leaves(net.state_tree) if p[-1] == "mean"}

    single = ResNet50(input_shape=(hw, hw, 3)).init_graph(device=dev)
    loss1 = float(single.fit(DataSet(xs[0], y)))
    means1 = bn_means(single)
    del single
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    net = ResNet50(input_shape=(hw, hw, 3)).init_graph(device=dev)
    tr = ShardedTrainer(net, MeshConfig(data=2), devices=devs)
    peak(reset=True)
    t0 = time.perf_counter()
    losses = []
    for i, x in enumerate(xs):
        losses.append(float(tr.fit_batch(x, y)))
        if i == 0:
            means_dp = bn_means(net)
            t0 = time.perf_counter()
    sync()
    wall = time.perf_counter() - t0

    def bn_diff(means):
        num = sum(float((means[p] - m).square().sum()) for p, m in
                  means1.items())
        den = sum(float(m.square().sum()) for m in means1.values())
        return math.sqrt(num / max(den, 1e-30))
    bn_err = bn_diff(means_dp)
    loss_err = abs(losses[0] - loss1) / abs(loss1)
    if not (all(math.isfinite(v) for v in losses)
            and loss_err <= MESH_TOL["resnet_loss"]
            and bn_err <= MESH_TOL["resnet_bn"]):
        raise AssertionError(f"mesh/resnet: losses {losses}, first vs one "
                             f"device {loss1} ({loss_err}), running means "
                             f"normwise {bn_err}")
    peak_bytes = peak()
    # control: the same first step with each shard's own batch
    # statistics must miss the running means by more than the limit
    del tr, net
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    net = ResNet50(input_shape=(hw, hw, 3)).init_graph(device=dev)
    tr = ShardedTrainer(net, MeshConfig(data=2), devices=devs)
    undo = mesh_local_bn()
    try:
        local_loss = float(tr.fit_batch(xs[0], y))
    finally:
        undo()
    local = {"first_loss_rel_diff": abs(local_loss - loss1) / abs(loss1),
             "bn_running_mean_normwise_diff": bn_diff(bn_means(net))}
    del tr, net
    local["tripped"] = [k for k, lim in (
        ("first_loss_rel_diff", MESH_TOL["resnet_loss"]),
        ("bn_running_mean_normwise_diff", MESH_TOL["resnet_bn"]))
        if not local[k] <= lim]
    if not local["tripped"]:
        raise AssertionError(f"mesh/resnet control: per-shard statistics "
                             f"pass every sync-BN check {local}")
    n = len(xs) - 1
    return {"b": b, "hw": hw, "updater": "AdaDelta", "shards": 2,
            "batch_shift": cfg["resnet_shift"], "losses": losses,
            "one_device_first_loss": loss1, "first_loss_rel_diff": loss_err,
            "bn_running_mean_normwise_diff": bn_err,
            "step_ms": wall * 1e3 / max(n, 1),
            "images_per_s": n * b / wall if n else None,
            "peak_allocated_bytes": peak_bytes, "control_local_bn": local}


def mesh_ring(torch, cfg, devs):
    """Part (d): ring attention over ``seq`` sequence shards against one
    softmax, output and gradients (f32)."""
    from deeplearning4j_torch.parallel import MeshConfig, ring_self_attention
    from deeplearning4j_torch.parallel.ring_attention import (
        full_attention_reference)
    r = cfg["ring"]
    dev = devs[0]
    mesh = MeshConfig(sequence=r["seq"]).build(devs)
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = [torch.randn((r["b"], r["h"], r["t"], r["dh"]), generator=g,
                       device=dev).requires_grad_(True) for _ in range(3)]
    do = torch.randn((r["b"], r["h"], r["t"], r["dh"]), generator=g,
                     device=dev)
    out = ring_self_attention(mesh, *qkv)
    g_ring = torch.autograd.grad(out, qkv, do)
    ref = full_attention_reference(*qkv)
    g_ref = torch.autograd.grad(ref, qkv, do)
    err = flash_err(torch, out.detach(), ref.detach())[0]
    gerr = max(float((a - c).abs().max()) / float(c.abs().max())
               for a, c in zip(g_ring, g_ref))
    if not (err <= MESH_TOL["ring_out"] and gerr <= MESH_TOL["ring_grad"]):
        raise AssertionError(f"mesh/ring: output {err}, gradients {gerr}")
    return dict(r, out_err=err, grad_err=gerr, dtype="float32")


def mesh_world(torch, np, cfg, devs, sync, tmp):
    """Part (e): one torch.distributed world on the card — the control
    reductions and the DP gradient all-reduce through the backend, the
    scaling harness at one device, a pipeline checkpoint restored at
    data=1 through the elastic path, and a FleetCoordinator run that is
    preempted and resumed."""
    import socket
    from deeplearning4j_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_torch.parallel import (CheckpointListener,
                                               MeshConfig, ShardedTrainer,
                                               distributed, measure_scaling)
    from deeplearning4j_torch.resilience import (FaultInjector,
                                                 TrainingPreempted,
                                                 clear_preemption,
                                                 fleet_resume_fit)
    from deeplearning4j_torch.zoo import Gpt
    dev = devs[0]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    distributed.initialize(f"tcp://127.0.0.1:{port}", 1, 0, backend=backend)
    try:
        row = {"backend": backend,
               "process_count": distributed.process_count(),
               "or": distributed.or_reduce_flag(True),
               "min": distributed.min_reduce(7),
               "sum": distributed.sum_reduce(1)}
        wg = cfg["world_gpt"]
        b = cfg["world_b"]

        def gpt():
            return Gpt(seed=4, compute_dtype=None, **wg).init_graph(
                device=dev)

        data = [train_batch(np, b, wg["seq_len"], wg["vocab_size"], 40 + i)
                for i in range(cfg["world_batches"])]

        def it():
            return ListDataSetIterator([DataSet(x, y) for x, y in data])
        rows = measure_scaling(
            gpt, lambda n: train_batch(np, n, wg["seq_len"],
                                       wg["vocab_size"], 7),
            per_device_batch=b, device_counts=[1], n_steps=3, warmup=1,
            out_path=os.path.join(tmp, "scaling.json"), devices=devs[:1])
        with open(os.path.join(tmp, "scaling.json")) as f:
            if json.load(f)["rows"] != rows:
                raise AssertionError("mesh/world: scaling artefact")
        row["scaling"] = rows
        # pipeline=2 preempted mid-fit, resumed on a plain trainer
        ref = gpt()
        ref_loss = ShardedTrainer(ref, MeshConfig(pipeline=2), devices=devs,
                                  n_micro=2).fit(it(), n_epochs=2)
        m = gpt()
        tr = ShardedTrainer(m, MeshConfig(pipeline=2), devices=devs,
                            n_micro=2)
        ck = CheckpointListener(os.path.join(tmp, "pipe"),
                                save_every_n_iterations=2)
        m.set_listeners(ck)
        preempted = False
        try:
            with FaultInjector([f"preempt@{cfg['world_batches'] + 1}"]):
                tr.fit(it(), n_epochs=2)
        except TrainingPreempted:
            preempted = True
        clear_preemption()
        if not preempted:
            raise AssertionError("mesh/world: the pipeline fit was not "
                                 "preempted")
        ck.ckpt.close()
        meta = ck.ckpt.world_at(ck.ckpt.all_steps()[-1])
        m2 = gpt()
        tr2 = ShardedTrainer(m2, MeshConfig(data=1), devices=devs[:1])
        m2.set_listeners(CheckpointListener(os.path.join(tmp, "pipe")))
        loss2 = tr2.fit(it(), n_epochs=2, resume=True)
        rel = abs(loss2 - ref_loss) / abs(ref_loss)
        if not (meta["opt_layout"] == "pipe" and rel <= 1e-3):
            raise AssertionError(f"mesh/world: elastic resume loss {loss2} "
                                 f"vs {ref_loss}, sidecar {meta}")
        row["elastic"] = {"saved": meta, "resumed_loss": loss2,
                          "uninterrupted_loss": ref_loss, "rel_diff": rel}
        # a FleetCoordinator run preempted and resumed (data=2)
        base = gpt()
        base_loss = ShardedTrainer(base, MeshConfig(data=2),
                                   devices=devs).fit(it(), n_epochs=2)
        m3 = gpt()
        tr3 = ShardedTrainer(m3, MeshConfig(data=2), devices=devs)
        ck3 = CheckpointListener(os.path.join(tmp, "fleet"),
                                 save_every_n_iterations=2)
        m3.set_listeners(ck3)
        with FaultInjector([f"preempt@{cfg['world_batches']}"]):
            loss3 = fleet_resume_fit(
                lambda: tr3.fit(it(), n_epochs=2, resume=True),
                mesh=tr3.mesh, checkpoint=ck3)
        ck3.ckpt.close()
        rel3 = abs(loss3 - base_loss) / abs(base_loss)
        if rel3 > 1e-5:
            raise AssertionError(f"mesh/world: fleet resume loss {loss3} vs "
                                 f"{base_loss}")
        row["fleet"] = {"resumed_loss": loss3, "uninterrupted_loss":
                        base_loss, "rel_diff": rel3}
        sync()
        return row
    finally:
        distributed.shutdown()


def mesh_parts(torch, np, device, cfg, sync, card, peak, parts="abcde"):
    """Parts (a)-(e) of :func:`phase_mesh` on ``device`` at ``cfg``'s
    sizes.  Emits one row; returns the launch counts by part."""
    import tempfile
    from deeplearning4j_torch.zoo import Gpt
    pa, fa = pa_module(), flash_module()
    dev = torch.device(device)
    devs = [dev] * 4
    t_phase = time.perf_counter()
    row = {"phase": "mesh", "card": card, "devices": [str(d) for d in devs]}
    counts = {}
    if "a" in parts:
        t0 = time.perf_counter()
        net = Gpt(seed=0, **cfg["gpt"]).init_graph(device=dev)
        row["a_serve"], counts["serve"] = mesh_serve(
            torch, np, pa, fa, net, cfg, devs, sync)
        row["a_serve"]["seconds"] = time.perf_counter() - t0
        del net
    if "b" in parts:
        t0 = time.perf_counter()
        row["b_train"], counts["train"] = mesh_train(torch, np, fa, cfg,
                                                     devs[:2], sync, peak)
        row["b_train"]["seconds"] = time.perf_counter() - t0
    if "c" in parts:
        t0 = time.perf_counter()
        row["c_resnet"] = mesh_resnet(torch, np, cfg, devs[:2], sync, peak)
        row["c_resnet"]["seconds"] = time.perf_counter() - t0
    if "d" in parts:
        t0 = time.perf_counter()
        row["d_ring"] = mesh_ring(torch, cfg, devs[:cfg["ring"]["seq"]])
        row["d_ring"]["seconds"] = time.perf_counter() - t0
    if "e" in parts:
        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp()
        try:
            row["e_world"] = mesh_world(torch, np, cfg, devs[:2], sync, tmp)
        finally:
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)
        row["e_world"]["seconds"] = time.perf_counter() - t0
    row["reduced"] = [
        "one H100 listed as every device of the mesh: real per-shard "
        "tensors, gathers and sums, no second card, so no scaling figure",
        "random seeded weights; no ImageNet (ResNet-50 on seeded images)"]
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    return counts


def phase_mesh(torch, np):
    """Multi-device training and serving on the card (phase 9d): (a) a
    tp = 2 GenerationServer of full-width Gpt() over [cuda:0] * 2 — f32
    greedy streams (also at data = 2 x tp = 2 over [cuda:0] * 4) and
    phase 4(b)'s bf16 mix against a tp = 1 server (near-tie rule;
    sampled streams draw for draw, the same rule on the perturbed
    scores), a speculative run (k 4), K1 and K2 launched per shard on 3
    of the 6 heads, each at that shape held to its plain version,
    tokens/s beside tp = 1's; (b) Gpt() at b 8, t 2048 under
    MeshConfig(data=2) (5 steps), (model=2) and (pipeline=2, n_micro 4)
    (2 each), and data=2 at t 512 (K4), losses against the unsharded
    fit's, K3-K6 counted per step and one launch of each held to its
    plain version, and two control runs (a shard's gradient dropped, no
    copy to the replica) that the checks must catch; (c) BASELINE config
    5: data-parallel ResNet-50 at global b 256, sync-BN checked against
    one device, and a per-shard-statistics control the check must catch;
    (d) ring attention over 4 sequence shards against one softmax; (e)
    one NCCL world: reductions, the gradient all-reduce, the scaling
    harness, an elastic pipeline resume and a coordinated preemption.
    Returns the launch counts by part."""
    def peak(reset=False):
        if reset:
            torch.cuda.reset_peak_memory_stats()
            return None
        return torch.cuda.max_memory_allocated()
    try:
        return mesh_parts(torch, np, "cuda", MESH_CFG,
                          torch.cuda.synchronize, card_line(), peak)
    finally:
        torch.cuda.empty_cache()


# -- phase 9f ----------------------------------------------------------
# Every mesh axis across OS processes on the card: worker processes of
# this script (``--dist-worker``), each on cuda:0, joined by
# torch.distributed over gloo (NCCL refuses two ranks on one device; gloo
# stages every collective through host memory).  (a) Gpt() at b 8, t 2048,
# bf16 under MeshConfig(model=2) over 2 processes; (b) (pipeline=2,
# n_micro 4) over 2; (c) (data=2, model=2, pipeline=2) over 8 at depth 4
# (the time limit); (d) ring attention over a 2-process sequence axis at
# t 2048; (e) phase 9d's data 2 x tp 2 server, its per-slot state on its
# rows; (f) a worker SIGKILLed mid-decode and its black box salvaged.
DIST_CFG = {"gpt": {}, "vocab": 32000, "b": 8, "t": 2048, "steps": 2,
            "n_micro": 4, "axis3_layers": 4,
            "ring": {"b": 2, "h": 12, "dh": 64, "t": 2048},
            "serve": {"n_slots": 8, "max_len": 1024, "block_size": 16,
                      "tick_batch": 8, "tp": 2, "requests": 4, "new": 32,
                      "prompt_t": [64, 769],
                      "spec": {"k": 4, "rounds": 2, "draft_layers": 2}},
            "device": "cuda", "kernels": True, "timeout_s": 420}


def dist_grad_probe(solver):
    """Keep the first step's gradients handed to ``solver``: {storage
    path: f32 copy}."""
    from deeplearning4j_torch.utils.trees import iter_leaves
    kept, real = {}, solver.apply_grads

    def apply(params, opt, state, new_state, grads, *a, **kw):
        if not kept:
            kept.update(("/".join(map(str, p)), g.detach().float().clone())
                        for p, g in iter_leaves(grads))
        return real(params, opt, state, new_state, grads, *a, **kw)
    solver.apply_grads = apply
    return kept


def dist_grad_diff(got, ref):
    """Normwise difference of the gradients ``got`` holds (a process's
    shards) from the same storage leaves of ``ref``."""
    num = sum(float((g.to(ref[p].device) - ref[p]).square().sum())
              for p, g in got.items())
    den = sum(float(ref[p].square().sum()) for p in got)
    return math.sqrt(num / max(den, 1e-30))


def dist_train_job(torch, np, cfg, dev, mesh_kw, gpt_kw, fault=None,
                   capture=False, probe=None):
    """One worker's share of a cross-process mesh run: a warm-up step
    (its flash operands captured and replayed against the plain versions
    when ``capture``), then ``steps`` counted steps with the flash counts
    set to 0 just before.  ``fault="drop"``: the model group's sums
    (forward and backward) leave coordinate 1's part out (the control);
    the warm-up step and one more.  ``probe``: a file the warm-up step's
    gradients of this process's storage go to."""
    from deeplearning4j_torch.parallel import (MeshConfig, ShardedTrainer,
                                               distributed)
    from deeplearning4j_torch.utils.trees import iter_leaves
    from deeplearning4j_torch.zoo import Gpt
    fa = flash_module()
    b, t, steps = cfg["b"], cfg["t"], cfg["steps"]
    net = Gpt(**dict(cfg["gpt"], **gpt_kw, seed=0, seq_len=t)).init_graph(
        device=dev)
    tr = ShardedTrainer(net, MeshConfig(**mesh_kw),
                        devices=distributed.global_devices([dev]),
                        n_micro=cfg["n_micro"])
    data = [train_batch(np, b, t, cfg["vocab"], 20 + i)
            for i in range(steps + 1)]
    kept = dist_grad_probe(tr.solver) if probe else None
    if fault == "drop":
        g = tr._gm
        g.sum = lambda x: g.gather(x)[0]
        try:
            losses = [float(tr.fit_batch(*xy)) for xy in data[:2]]
        finally:
            del g.sum
        if kept is not None:
            torch.save({k: v.cpu() for k, v in kept.items()}, probe)
        return {"losses": losses}
    rec, restore = infer_capture(fa) if capture else (None, lambda: None)
    try:
        warm = float(tr.fit_batch(*data[0]))
    finally:
        restore()
    errs = infer_kernel_errors(torch, fa, rec) if rec else {}
    if kept is not None:
        torch.save({k: v.cpu() for k, v in kept.items()}, probe)
        kept.clear()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    coll = dist_collective_clock()
    sync()
    torch.distributed.barrier()      # every rank starts the window at once
    for n in FLASH_WRAPPERS:
        getattr(fa, n).launches = 0
    coll.reset()
    t0 = time.perf_counter()
    losses = [float(tr.fit_batch(*xy)) for xy in data[1:]]
    sync()
    wall = time.perf_counter() - t0
    coll.stop()
    held = sum(x.numel() * x.element_size()
               for _, x in iter_leaves(tr._store[0]))
    return {"warmup_loss": warm, "losses": losses,
            "step_ms": wall * 1e3 / steps,
            "collective_share": coll.seconds / wall,
            "launches": {n: getattr(fa, n).launches
                         for n in FLASH_WRAPPERS},
            "kernel_vs_plain": errs, "held_param_bytes": held,
            "owners": tr.mesh.owners.reshape(-1).tolist()}


class dist_collective_clock:
    """Host seconds spent inside the port's cross-process collectives
    (the ``AxisGroup`` methods, the pipeline's hand-off included): gloo
    stages each through host memory and blocks, so this is the staging,
    the transfer and any wait for the peer."""

    def __init__(self):
        from deeplearning4j_torch.parallel import distributed as d
        self.seconds, self._saved = 0.0, []
        for name in ("gather", "broadcast", "rotate", "send", "recv"):
            orig = getattr(d.AxisGroup, name)
            self._saved.append((name, orig))
            setattr(d.AxisGroup, name, self._timed(orig))

    def _timed(self, fn):
        def w(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
        return w

    def reset(self):
        self.seconds = 0.0

    def stop(self):
        from deeplearning4j_torch.parallel import distributed as d
        for name, orig in self._saved:
            setattr(d.AxisGroup, name, orig)


def dist_ring_job(torch, np, cfg, dev):
    """(d): ring_self_attention over a 2-process sequence axis, f32 (TF32
    off), output and q/k/v gradients against one softmax; every rank
    returns the full tensors."""
    from deeplearning4j_torch.parallel import (MeshConfig, distributed,
                                               ring_self_attention)
    from deeplearning4j_torch.parallel.ring_attention import (
        full_attention_reference)
    r = cfg["ring"]
    mesh = MeshConfig(sequence=2).build(distributed.global_devices([dev]))
    g = torch.Generator(device=dev).manual_seed(5)
    shape = (r["b"], r["h"], r["t"], r["dh"])
    qkv = [torch.randn(shape, generator=g, device=dev).requires_grad_(True)
           for _ in range(3)]
    do = torch.randn(shape, generator=g, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    torch.autograd.grad(ring_self_attention(mesh, *qkv), qkv, do)  # warm
    sync()
    torch.distributed.barrier()
    coll = dist_collective_clock()
    t0 = time.perf_counter()
    out = ring_self_attention(mesh, *qkv)
    sync()
    t1 = time.perf_counter()
    g_ring = torch.autograd.grad(out, qkv, do)
    sync()
    wall = time.perf_counter() - t0
    coll.stop()
    ref = full_attention_reference(*qkv)
    g_ref = torch.autograd.grad(ref, qkv, do)
    return {"out_err": flash_err(torch, out.detach(), ref.detach())[0],
            "grad_err": max(float((a - c).abs().max())
                            / float(c.abs().max())
                            for a, c in zip(g_ring, g_ref)),
            "step_ms": wall * 1e3, "forward_ms": (t1 - t0) * 1e3,
            "collective_share": coll.seconds / wall}


def dist_blackbox_job(torch, np, cfg, dev, out_dir):
    """(f)'s victim: a small GenerationServer on the device with the
    flight recorder's black box persisted every 50 ms and every scheduler
    pass throttled, so one decode stays in flight until the SIGKILL."""
    from deeplearning4j_torch import telemetry
    from deeplearning4j_torch.parallel import GenerationServer
    from deeplearning4j_torch.resilience import FaultInjector
    from deeplearning4j_torch.resilience.faults import throttled_stall_plan
    from deeplearning4j_torch.zoo import Gpt
    telemetry.get_flight_recorder().install_dump(
        out_dir, host=f"victim-{os.getpid()}", persist_interval_s=0.05)
    net = Gpt(vocab_size=50, max_len=64, d_model=32, n_layers=2, n_heads=4,
              d_ff=64, seq_len=8, compute_dtype=None,
              seed=3).init_graph(device=dev)
    with FaultInjector(throttled_stall_plan(
            4000, "serve_tick_stall@4001:0.05", enqueue_s=0.05)):
        with GenerationServer(net, n_slots=2, max_len=64, tick_batch=1,
                              tick_timeout_s=None, device=dev) as srv:
            srv.submit_async(np.asarray([1, 2, 3, 4], np.int32),
                             n_new=40).result(timeout=600)
    raise SystemExit("the decode finished before the SIGKILL")


def dist_worker(argv) -> int:
    """``chip_smoke.py --dist-worker JOBS RANK WORLD PORT OUT CFG``: one
    rank of phase 9f; writes ``OUT/rank<RANK>.json``."""
    jobs, rank, world, port, out_dir, cfg_path = argv
    rank, world = int(rank), int(world)
    import numpy as np
    import torch
    sys.path.insert(0, ROOT_DIR)
    with open(cfg_path) as f:
        cfg = json.load(f)
    dev = torch.device(cfg["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if jobs == "blackbox":
        return dist_blackbox_job(torch, np, cfg, dev, out_dir)
    from deeplearning4j_torch.parallel import distributed
    # the caller's explicit choice: gloo moves the cross-process traffic
    # through host memory; NCCL stays initialize()'s default
    distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                           backend="gloo")
    depth = {"n_layers": cfg["axis3_layers"]}
    probe = (lambda tag: os.path.join(out_dir, f"grads_{tag}.pt")
             if rank == 0 else None)
    run = {"tp": lambda: dist_train_job(torch, np, cfg, dev,
                                        {"model": 2}, {},
                                        capture=rank == 0,
                                        probe=probe("tp")),
           "tp_drop": lambda: dist_train_job(torch, np, cfg, dev,
                                             {"model": 2}, {},
                                             fault="drop",
                                             probe=probe("tp_drop")),
           "pp": lambda: dist_train_job(torch, np, cfg, dev,
                                        {"pipeline": 2}, {}),
           "axis3": lambda: dist_train_job(
               torch, np, cfg, dev,
               {"data": 2, "model": 2, "pipeline": 2}, depth),
           "ring": lambda: dist_ring_job(torch, np, cfg, dev)}
    out = {}
    for job in jobs.split(","):
        out[job] = run[job]()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()
    return 0


def dist_launch(world, jobs, out_dir, cfg_path, timeout_s):
    """Start ``world`` worker processes on ``jobs``; every one must exit 0
    within ``timeout_s`` (else all are killed and the phase fails).
    Returns their result dicts by rank."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT_DIR + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    logs = [os.path.join(out_dir, f"{jobs}_{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-worker",
                 jobs, str(r), str(world), str(port), out_dir, cfg_path],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = {r: open(logs[r]).read()[-2500:] for r in bad}
        raise AssertionError(f"dist {jobs}: ranks {bad} failed or hung "
                             f"past {timeout_s} s: {tails}")
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
        os.remove(os.path.join(out_dir, f"rank{r}.json"))
    return out


def dist_reference(torch, np, cfg, dev, mesh, gpt_kw, n=None, probe=False):
    """The same steps in this process: unsharded (``mesh`` None) or on a
    one-process mesh over ``[dev] * n``; returns the losses, warm-up
    first (and with ``probe`` the warm-up step's gradients by storage
    path)."""
    from deeplearning4j_torch.data import DataSet
    from deeplearning4j_torch.parallel import ShardedTrainer
    from deeplearning4j_torch.zoo import Gpt
    b, t = cfg["b"], cfg["t"]
    net = Gpt(**dict(cfg["gpt"], **gpt_kw, seed=0, seq_len=t)).init_graph(
        device=dev)
    data = [train_batch(np, b, t, cfg["vocab"], 20 + i)
            for i in range(cfg["steps"] + 1)]
    if mesh is None:
        losses = [float(net.fit(DataSet(x, y))) for x, y in data]
    else:
        tr = ShardedTrainer(net, mesh, devices=[dev] * n,
                            n_micro=cfg["n_micro"])
        kept = dist_grad_probe(tr.solver) if probe else None
        losses = [float(tr.fit_batch(x, y)) for x, y in data]
        del tr
    del net
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return (losses, kept) if probe else losses


def dist_check_train(tag, ranks, refs, cfg, per_step):
    """Every rank's losses equal (rtol 1e-6) and within MESH_TOL of each
    reference; on the card, K3/K5/K6 = ``per_step`` x steps in every
    worker (K4 none) and the captured launches within FLASH_TOL."""
    got = [[r[tag]["warmup_loss"]] + r[tag]["losses"] for r in ranks]
    spread = max(abs(a - c) / abs(c) for g in got[1:]
                 for a, c in zip(g, got[0]))
    diffs = {name: max(abs(a - c) / abs(c) for a, c in zip(got[0], ref))
             for name, ref in refs.items()}
    launches = [r[tag]["launches"] for r in ranks]
    want = {n: (per_step * cfg["steps"]
                if n in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
                else 0) for n in FLASH_WRAPPERS}
    errs = {k: v for r in ranks for k, v in
            r[tag]["kernel_vs_plain"].items()}
    bad = [k for k, v in errs.items() if not v <= FLASH_TOL["bfloat16"]]
    if not (all(math.isfinite(x) for g in got for x in g) and spread <= 1e-6
            and all(d <= MESH_TOL["train_loss"] for d in diffs.values())
            and not bad and (not cfg["kernels"]
                             or all(c == want for c in launches))):
        raise AssertionError(
            f"dist {tag}: losses {got} (rank spread {spread}), against "
            f"the references {diffs}, launches {launches} (want {want}), "
            f"kernels over the bound {bad}")
    r0 = ranks[0][tag]
    return {"losses": got[0], "rank_spread": spread,
            "ref_max_rel_diff": diffs, "step_ms": [r[tag]["step_ms"]
                                                   for r in ranks],
            "collective_share": [r[tag]["collective_share"]
                                 for r in ranks],
            "held_param_bytes": [r[tag]["held_param_bytes"]
                                 for r in ranks],
            "owners": r0["owners"], "launches_by_rank": launches,
            "kernel_vs_plain": errs}


def dist_serve(torch, np, cfg, dev, sync):
    """(e): phase 9d's data 2 x tp 2 replica of Gpt() (f32 greedy) against
    a tp = 1 one: the streams (near-tie rule), each data row's per-slot
    state on its row's device in tensors of its own slots, every row's
    tick reading its own block table in place (no per-tick row copy), and
    K1 launched per row and shard; then the same replica speculative (K2
    per row and shard on every verify pass)."""
    from deeplearning4j_torch import telemetry
    from deeplearning4j_torch.models.generation import TransformerGenerator
    from deeplearning4j_torch.parallel import GenerationServer
    from deeplearning4j_torch.zoo import Gpt
    s = cfg["serve"]
    pa, fa = pa_module(), flash_module()
    net = Gpt(seed=0, **cfg["gpt"]).init_graph(device=dev)
    n_layers = len(net.layers) - 2
    kw = dict(n_slots=s["n_slots"], max_len=s["max_len"],
              block_size=s["block_size"], tick_batch=s["tick_batch"])
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg["vocab"], int(t)).astype(np.int32),
             s["new"], None)
            for t in rng.integers(*s["prompt_t"], s["requests"])]
    with GenerationServer(net, compute_dtype=None, device=dev, **kw) as s1:
        one, _, _ = serve(s1, reqs)
    with GenerationServer(net, compute_dtype=None, devices=[dev] * 4,
                          tp=s["tp"], **kw) as s4:
        seen = []
        inner = s4._row_step

        def row_step(step, params_rows, kc, vc, r=0):
            fn = inner(step, params_rows, kc, vc, r)

            def spy(*rows):
                tbl = rows[2]
                seen.append((r, tbl.shape[0], tbl.untyped_storage().nbytes()
                             // tbl.element_size() // tbl.shape[1]))
                return fn(*rows)
            return spy
        s4._row_step = row_step
        mesh_zero(pa, fa)
        t0 = time.perf_counter()
        four, _, _ = serve(s4, reqs)
        sync()
        wall = time.perf_counter() - t0
        k1 = pa.paged_decode_attention.launches
        state, row_devs = s4._state, [c.devices[0] for c in s4._rows]
        ticks = s4.stats().get("ticks")
    n = s["n_slots"] // 2
    placed = all(len(getattr(state, "rows", ())) == 2 and
                 t.shape[0] == n and t.device == row_devs[r]
                 for r, row in enumerate(getattr(state, "rows", ()))
                 for t in row.values())
    in_place = bool(seen) and {r for r, _, _ in seen} == {0, 1} and all(
        m == n and rows == n for _, m, rows in seen)
    gen = TransformerGenerator(net, device=dev)
    ties = check_streams(torch, gen, list(zip(four, one)), NEAR_TIE_F32)
    if not (placed and in_place):
        raise AssertionError(f"dist/serve: per-slot state on its rows "
                             f"{placed}, read in place {in_place}")
    if cfg["kernels"] and k1 < n_layers * 2 * s["tp"]:
        raise AssertionError(f"dist/serve: {k1} K1 launches")
    ticks_c = telemetry.get_registry().counter(
        "generation_server_ticks_total")
    with GenerationServer(net, compute_dtype=None, devices=[dev] * 4,
                          tp=s["tp"], speculative=s["spec"], **kw) as sp:
        mesh_zero(pa, fa)
        p0 = ticks_c.value
        spec_outs, _, spec_wall = serve(sp, reqs)
        sync()
        passes, k2 = ticks_c.value - p0, pa.paged_verify_attention.launches
        spec_rows = len(getattr(sp._state, "rows", ()))
    spec_ties = check_streams(torch, gen, list(zip(spec_outs, one)),
                              NEAR_TIE_F32)
    if spec_rows != 2 or (cfg["kernels"] and not (
            k2 > 0 and k2 == n_layers * 2 * s["tp"] * passes)):
        raise AssertionError(f"dist/serve spec: {spec_rows} state rows, "
                             f"{k2} K2 launches for {passes} verify "
                             "passes")
    del net
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"requests": len(reqs), "data": 2, "tp": s["tp"],
            "near_ties": ties, "state_on_rows": placed,
            "row_ticks_read_in_place": len(seen), "k1_launches": k1,
            "ticks": ticks, "wall_s": wall,
            "spec": {"speculative": s["spec"], "verify_passes": passes,
                     "k2_launches": k2, "near_ties": spec_ties,
                     "wall_s": spec_wall}}


def dist_blackbox(out_dir, cfg_path, timeout_s):
    """(f): a worker SIGKILLed mid-decode; its black box salvaged into a
    postmortem bundle holding its admit event and its open decode span."""
    import signal
    from deeplearning4j_torch.telemetry import flightrec
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT_DIR + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    box = os.path.join(out_dir, "blackbox")
    os.makedirs(box)
    log = os.path.join(out_dir, "blackbox.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker",
             "blackbox", "0", "1", "0", box, cfg_path], env=env, stdout=f,
            stderr=subprocess.STDOUT)
    bbdir = os.path.join(box, flightrec.BLACKBOX_DIRNAME)
    ready, t0 = False, time.monotonic()
    try:
        while not ready and time.monotonic() - t0 < timeout_s and \
                proc.poll() is None:
            for name in (os.listdir(bbdir) if os.path.isdir(bbdir)
                         else []):
                try:
                    doc = flightrec.load_bundle(os.path.join(bbdir, name))
                except (OSError, ValueError):
                    continue
                ready = ready or (
                    "admit" in {e["kind"] for e in doc.get("events", ())}
                    and "request/decode" in
                    {s["name"] for s in doc.get("open_spans", ())})
            time.sleep(0.05)
        if not ready:
            raise AssertionError(f"dist/blackbox: no decode-in-flight "
                                 f"black box (rc {proc.poll()}): "
                                 f"{open(log).read()[-2000:]}")
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    new = flightrec.salvage_bundles(box)
    doc = flightrec.load_bundle(new[0]) if len(new) == 1 else {}
    kinds = [e["kind"] for e in doc.get("events", ())]
    spans = {s["name"] for s in doc.get("open_spans", ())}
    if not (len(new) == 1 and doc["salvaged"] and "admit" in kinds
            and "request/decode" in spans and proc.returncode == -9):
        raise AssertionError(f"dist/blackbox: salvaged {new}, events "
                             f"{kinds}, open spans {spans}")
    return {"killed_by": "SIGKILL", "salvaged": True, "events": len(kinds),
            "open_spans": sorted(spans), "reason": doc["reason"]}


def dist_parts(torch, np, device, cfg, sync, card, parts="abcdef"):
    """Parts (a)-(f) of :func:`phase_dist` on ``device`` at ``cfg``'s
    sizes.  Emits a row per part as it ends (``dist/<part>``), then the
    phase's row; returns the launch counts by part (the sum over the
    workers)."""
    import shutil
    import tempfile
    from deeplearning4j_torch.parallel import MeshConfig
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t_phase = time.perf_counter()
    row = {"phase": "dist", "card": card, "backend": "gloo",
           "device": str(dev)}
    counts = {}
    tmp = tempfile.mkdtemp()
    cfg_path = os.path.join(tmp, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(dict(cfg, device=str(dev)), f)
    depth = {"n_layers": cfg["axis3_layers"]}
    n_layers = cfg["gpt"].get("n_layers", 12)
    try:
        jobs = [j for j, p in (("tp", "a"), ("tp_drop", "a"), ("pp", "b"),
                               ("ring", "d")) if p in parts]
        if jobs:
            t0 = time.perf_counter()
            ranks = dist_launch(2, ",".join(jobs), tmp, cfg_path,
                                cfg["timeout_s"])
            row["workers_2_s"] = time.perf_counter() - t0
        if "a" in parts:
            t0 = time.perf_counter()
            one = dist_reference(torch, np, cfg, dev, None, {})
            mesh1, grads1 = dist_reference(torch, np, cfg, dev,
                                           MeshConfig(model=2), {}, 2,
                                           probe=True)
            refs = {"unsharded": one, "one_process_mesh": mesh1}
            row["a_tp"] = dist_check_train("tp", ranks, refs, cfg,
                                           n_layers)
            # rank 0's first-step gradients (its shards and the
            # replicated leaves) against the one-process mesh's, sound
            # and with the dropped sums: the limit sits between them
            gd = {tag: dist_grad_diff(torch.load(os.path.join(
                tmp, f"grads_{tag}.pt")), grads1)
                for tag in ("tp", "tp_drop")}
            del grads1
            drop = ranks[0]["tp_drop"]["losses"]
            off = max(abs(a - c) / abs(c) for a, c in zip(drop, one))
            tripped = [k for k, v, lim in (
                ("loss", off, MESH_TOL["train_loss"]),
                ("first_grad", gd["tp_drop"], MESH_TOL["train_grad"]))
                if not v <= lim]
            row["a_tp"]["first_grad_normwise_diff"] = gd["tp"]
            row["a_tp"]["control_drop"] = {
                "losses": drop, "loss_rel_diff": off,
                "first_grad_normwise_diff": gd["tp_drop"],
                "tripped": tripped}
            if not gd["tp"] <= MESH_TOL["train_grad"] or not tripped:
                raise AssertionError(
                    f"dist/tp: first-step gradients {gd['tp']} from the "
                    f"one-process mesh; the control (a model rank's sums "
                    f"dropped) tripped {tripped}: {row['a_tp']}")
            row["a_tp"]["reference_s"] = time.perf_counter() - t0
            counts["tp"] = {n: sum(r["tp"]["launches"][n] for r in ranks)
                            for n in FLASH_WRAPPERS}
        if "a" in parts:
            emit({"phase": "dist/a_tp", **row["a_tp"]})
        if "b" in parts:
            refs = {"unsharded": one if "a" in parts else dist_reference(
                torch, np, cfg, dev, None, {}),
                "one_process_mesh": dist_reference(
                    torch, np, cfg, dev, MeshConfig(pipeline=2), {}, 2)}
            row["b_pp"] = dist_check_train(
                "pp", ranks, refs, cfg, n_layers // 2 * cfg["n_micro"])
            counts["pp"] = {n: sum(r["pp"]["launches"][n] for r in ranks)
                            for n in FLASH_WRAPPERS}
            emit({"phase": "dist/b_pp", **row["b_pp"]})
        if "c" in parts:
            t0 = time.perf_counter()
            ranks8 = dist_launch(8, "axis3", tmp, cfg_path,
                                 cfg["timeout_s"])
            row["workers_8_s"] = time.perf_counter() - t0
            refs = {"unsharded": dist_reference(torch, np, cfg, dev, None,
                                                depth),
                    "one_process_mesh": dist_reference(
                        torch, np, cfg, dev,
                        MeshConfig(data=2, model=2, pipeline=2), depth, 8)}
            row["c_axis3"] = dist_check_train(
                "axis3", ranks8, refs, cfg,
                cfg["axis3_layers"] // 2 * cfg["n_micro"])
            row["c_axis3"]["n_layers"] = cfg["axis3_layers"]
            counts["axis3"] = {n: sum(r["axis3"]["launches"][n]
                                      for r in ranks8)
                               for n in FLASH_WRAPPERS}
            emit({"phase": "dist/c_axis3", **row["c_axis3"]})
        if "d" in parts:
            rr = [r["ring"] for r in ranks]
            if not all(x["out_err"] <= MESH_TOL["ring_out"] and
                       x["grad_err"] <= MESH_TOL["ring_grad"] for x in rr):
                raise AssertionError(f"dist/ring: {rr}")
            row["d_ring"] = dict(cfg["ring"], processes=2, dtype="float32",
                                 by_rank=rr)
            emit({"phase": "dist/d_ring", **row["d_ring"]})
        if "e" in parts:
            t0 = time.perf_counter()
            row["e_serve"] = dist_serve(torch, np, cfg, dev, sync)
            row["e_serve"]["seconds"] = time.perf_counter() - t0
            counts["serve"] = {"paged_decode_attention":
                               row["e_serve"]["k1_launches"],
                               "paged_verify_attention":
                               row["e_serve"]["spec"]["k2_launches"]}
        if "f" in parts:
            t0 = time.perf_counter()
            row["f_blackbox"] = dist_blackbox(tmp, cfg_path,
                                              cfg["timeout_s"])
            row["f_blackbox"]["seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["reduced"] = [
        "every process on the one H100 (cuda:0): gloo through host "
        "memory, so the times say nothing of NVLink or NCCL",
        f"(c) at depth {cfg['axis3_layers']} of {n_layers}: eight "
        "processes within the phase's time"]
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    return counts


def phase_dist(torch, np):
    """Every mesh axis across processes on the card (phase 9f, parts
    (a)-(f) above).  Returns the launch counts by part."""
    try:
        return dist_parts(torch, np, "cuda", DIST_CFG,
                          torch.cuda.synchronize, card_line())
    finally:
        torch.cuda.empty_cache()


# -- phase 10 ----------------------------------------------------------
# -- phase 9e ----------------------------------------------------------
# The periphery on the card, each part at the size its users run:
# (a) Keras import: dl4j-examples' LeNet golden and Keras's ResNet-50
#     functional config at 224 (seeded weights); (b) Word2Vec at
#     dl4j-examples' Word2VecRawTextExample settings (layerSize 100,
#     windowSize 5, minWordFrequency 5, seed 42, negative sampling with 5
#     negatives, 1 epoch) over a seeded Zipf corpus of planted topics,
#     then ParagraphVectors, FastText and the serializer; (c) rl4j's
#     learners at the reference tests' gridworld configurations; (d) the
#     reference test's arbiter random search; (e) the ui listeners on
#     Gpt(); (f) native_io over a seeded 200,000 x 32 CSV.
PERIPHERY_CFG = {
    "lenet": "tests/fixtures/keras_lenet_golden.npz",
    "resnet_config": "tests/fixtures/keras_resnet50_config.json",
    "resnet_hw": 224, "resnet_b": 2, "resnet_fit_b": 64, "resnet_steps": 3,
    "w2v": {"tokens": 1_000_000, "topics": 64, "topic_words": 300,
            "sent_len": 20, "zipf": 1.0, "layer_size": 100, "window": 5,
            "min_freq": 5, "negative": 5, "seed": 42, "epochs": 1,
            "probe_steps": 200},
    "pv_sentences": 5000, "ft_tokens": 200_000, "ft_bucket": 50000,
    "grid": 4,
    "dqn": {"seed": 7, "max_step": 2500, "batch_size": 32,
            "update_start": 64, "target_dqn_update_freq": 50,
            "eps_decay_steps": 1500, "learning_rate": 2e-3,
            "exp_replay_size": 4000},
    "dqn_hidden": 32,
    "a3c": {"n_threads": 2, "max_step": 5000, "t_max": 8,
            "learning_rate": 5e-3, "seed": 1},
    "nstepq": {"n_threads": 2, "max_step": 6000}, "nstepq_seeds": (2, 12, 22),
    "arbiter_candidates": 6, "arbiter_epochs": 20,
    "ui_gpt": {}, "ui_b": 8, "ui_t": 2048, "ui_steps": 5, "prof_start": 2,
    "prof_n": 2,
    "csv_rows": 200_000, "csv_cols": 32, "csv_classes": 10,
    "csv_batch": 1000, "csv_python_rows": 40_000,
}
# (a) the LeNet golden against Keras's predict; ResNet-50's f32 logits on
# the card against the port's f64 on the CPU, each element to its own
# size (flash_err; TF32 off); (b) one NS and one HS step on the card in
# f32 against the CPU in f64 (flash_err over both tables)
PERIPHERY_TOL = {"lenet": 1e-5, "resnet_f32": 1e-4, "w2v_step": 1e-5,
                 "serializer": 1e-6}


def keras_resnet50_config(root, hw):
    """Keras's ResNet-50 functional config (the committed
    ``keras_resnet50_config.json``) with its input at hw x hw x 3."""
    with open(os.path.join(root, PERIPHERY_CFG["resnet_config"])) as f:
        cfg = json.load(f)
    inp = cfg["config"]["layers"][0]
    if inp["class_name"] != "InputLayer":
        raise AssertionError("periphery/a: the config's first layer is "
                             f"{inp['class_name']}")
    inp["config"]["batch_shape"] = [None, hw, hw, 3]
    return cfg


def seeded_keras_weights(np, model, seed):
    """Weights in ``KerasModelImport._read_weights``' form for every
    parameter and batch-norm statistic of an imported graph, numpy-seeded:
    He-scaled kernels, gamma near 1, small beta and means, variances in
    [0.5, 1.5]."""
    leaf = {"W": "kernel", "b": "bias", "gamma": "gamma", "beta": "beta",
            "mean": "moving_mean", "var": "moving_variance"}
    r = np.random.default_rng(seed)
    out = {}
    for name in model.params_tree:
        w = {}
        for ours, t in {**model.params_tree[name],
                        **model.state_tree[name]}.items():
            shape = tuple(t.shape)
            if ours == "W":
                v = r.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
            elif ours == "gamma":
                v = 1.0 + 0.1 * r.normal(size=shape)
            elif ours == "var":
                v = r.uniform(0.5, 1.5, size=shape)
            else:
                v = 0.1 * r.normal(size=shape)
            w[leaf[ours]] = v.astype(np.float32)
        if w:
            out[name] = w
    return out


def only_output(y):
    """A graph's single output (``output`` returns {name: tensor} for a
    graph, the tensor for a list)."""
    if isinstance(y, dict):
        (y,) = y.values()
    return y


def keras_graph_as(torch, model, dtype, compute_dtype, device):
    """The imported graph ``model`` rebuilt from its configuration with
    parameter type ``dtype`` and compute type ``compute_dtype``, its
    parameters and batch-norm statistics carried over, on ``device``."""
    from deeplearning4j_torch.models.computation_graph import (
        ComputationGraph, ComputationGraphConfiguration)
    from deeplearning4j_torch.utils.convert import (load_numpy_params,
                                                    load_numpy_state)
    from deeplearning4j_torch.utils.trees import map_leaves
    conf = ComputationGraphConfiguration.from_dict(model.conf.to_dict())
    conf.global_conf.dtype = dtype
    conf.global_conf.compute_dtype = compute_dtype
    host = {"float64": torch.float64}.get(dtype, torch.float32)
    net = load_numpy_params(ComputationGraph(conf), map_leaves(
        lambda t: t.to("cpu", host).numpy(), model.params_tree),
        device=device)
    return load_numpy_state(net, map_leaves(
        lambda t: t.to("cpu", host).numpy(), model.state_tree))


def periphery_keras(torch, np, root, cfg, device, sync):
    """Part (a): the LeNet golden on ``device`` against Keras's predict;
    ResNet-50's config at ``resnet_hw`` with seeded weights, f32 on
    ``device`` against f64 on the CPU at b ``resnet_b``, then bf16 on f32
    masters at b ``resnet_fit_b``, ``resnet_steps`` timed fit steps."""
    from deeplearning4j_torch.data import DataSet
    from deeplearning4j_torch.keras_import import KerasModelImport
    t_part = time.perf_counter()
    g = np.load(os.path.join(root, cfg["lenet"]))
    weights = {}
    for key in g.files:
        if key.startswith("w/"):
            _, layer, leaf = key.split("/")
            weights.setdefault(layer, {})[leaf] = g[key]
    lcfg = json.loads(str(g["config"]))
    lenet = KerasModelImport._import_sequential(lcfg["config"], weights,
                                                device=device)
    got = lenet.output(g["x"]).float().cpu()
    lenet_err = float((got - torch.from_numpy(g["predict"])).abs().max())
    if not lenet_err <= PERIPHERY_TOL["lenet"]:
        raise AssertionError(f"periphery/a: LeNet vs Keras predict "
                             f"{lenet_err} > {PERIPHERY_TOL['lenet']}")
    out = {"lenet": {"layers": [type(ly).__name__
                                for ly in lenet.conf.layers],
                     "max_abs_err_vs_keras": lenet_err,
                     "tol": PERIPHERY_TOL["lenet"]}}
    hw, b = cfg["resnet_hw"], cfg["resnet_b"]
    rcfg = keras_resnet50_config(root, hw)["config"]
    t0 = time.perf_counter()
    probe = KerasModelImport._import_functional(rcfg, {}, device="cpu")
    kw = seeded_keras_weights(np, probe, 0)
    del probe
    card = KerasModelImport._import_functional(rcfg, kw, device=device)
    sync()
    import_s = time.perf_counter() - t0
    # the comparison reads the logits: the same graph with the head's
    # softmax off (random weights saturate the softmax to one-hot)
    lcfg_r = json.loads(json.dumps(rcfg))
    head = lcfg_r["layers"][-1]["config"]
    if head.get("activation") != "softmax":
        raise AssertionError(f"periphery/a: the head is {head}")
    head["activation"] = "linear"
    logits = KerasModelImport._import_functional(lcfg_r, kw, device=device)
    cpu64 = keras_graph_as(torch, logits, "float64", "float64", "cpu")
    x = np.random.default_rng(2).random((b, hw, hw, 3)).astype(np.float32)
    y32 = only_output(logits.output(x)).double().cpu()
    y64 = only_output(cpu64.output(x.astype(np.float64)))
    err, detail = flash_err(torch, y32, y64)
    if not (bool(torch.isfinite(y32).all()) and err <= PERIPHERY_TOL[
            "resnet_f32"]):
        raise AssertionError(f"periphery/a: ResNet-50 card f32 vs CPU f64 "
                             f"{err} > {PERIPHERY_TOL['resnet_f32']}")
    del cpu64, logits
    n_params = sum(int(t.numel()) for layer in card.params_tree.values()
                   for t in layer.values())
    bf = keras_graph_as(torch, card, "float32", "bfloat16", device)
    del card
    fb = cfg["resnet_fit_b"]
    r = np.random.default_rng(3)
    ds = DataSet(r.random((fb, hw, hw, 3)).astype(np.float32),
                 np.eye(1000, dtype=np.float32)[r.integers(0, 1000, fb)])
    losses = [float(bf.fit(ds))]                      # warm-up
    sync()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses += [float(bf.fit(ds)) for _ in range(cfg["resnet_steps"])]
    sync()
    wall = time.perf_counter() - t0
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"periphery/a: ResNet-50 losses {losses}")
    out["resnet50"] = {
        "hw": hw, "params": n_params, "weights_leaves": len(kw),
        "import_s": import_s,
        "f32_vs_f64": {"b": b, "compared": "logits", "flash_err": err,
                       **detail,
                       "tol": PERIPHERY_TOL["resnet_f32"]},
        "bf16_fit": {"b": fb, "steps": cfg["resnet_steps"],
                     "losses": losses,
                     "step_ms": wall * 1e3 / cfg["resnet_steps"],
                     "images_per_s": fb * cfg["resnet_steps"] / wall,
                     "peak_bytes": (torch.cuda.max_memory_allocated()
                                    if device == "cuda" else None)}}
    del bf
    out["seconds"] = time.perf_counter() - t_part
    return out


def zipf_topic_corpus(np, topics, topic_words, tokens, sent_len, zipf, seed):
    """Sentences of ``sent_len`` words, each from one seeded topic of
    ``topic_words`` words (``t<topic>w<rank>``) with Zipf(``zipf``) rank
    frequencies, ``tokens`` words in all; returns (sentences, topic of
    each sentence)."""
    r = np.random.default_rng(seed)
    n = tokens // sent_len
    p = 1.0 / np.arange(1, topic_words + 1) ** zipf
    sent_topic = r.integers(0, topics, n)
    ranks = r.choice(topic_words, size=(n, sent_len), p=p / p.sum())
    names = np.asarray([[f"t{t}w{w}" for w in range(topic_words)]
                        for t in range(topics)])
    words = names[sent_topic[:, None], ranks]
    return [" ".join(row) for row in words], sent_topic


def window_pair_count(np, lengths, w):
    """How many (centre, context) pairs windows of ``w`` make over
    sentences of ``lengths`` in-vocabulary words."""
    total = 0
    for n, c in zip(*np.unique(np.asarray(lengths), return_counts=True)):
        i = np.arange(n)
        total += int(c) * int((np.minimum(n, i + w + 1)
                               - np.maximum(0, i - w) - 1).sum())
    return total


def topic_cosines(np, vec, topics, n_words=5):
    """(mean cosine of frequent words within a topic, across topics):
    the ``n_words`` most frequent words (ranks 0..) of each topic."""
    v = np.stack([[vec(f"t{t}w{w}") for w in range(n_words)]
                  for t in range(topics)])
    v = v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)
    intra = np.einsum("twd,tud->twu", v, v)
    off = ~np.eye(n_words, dtype=bool)
    same = float(intra[:, off].mean())
    # each topic's words against the previous topic's
    other = float(np.einsum("twd,tud->twu", v, np.roll(v, 1, axis=0))
                  .mean())
    return same, other


def w2v_step_checks(torch, np, model, device):
    """One NS step with the same negatives and one HS step on ``device``
    in f32 against the CPU in f64, from the trained tables: flash_err
    over both tables after the step."""
    from deeplearning4j_torch.nlp import word2vec as w2v
    n = len(model.vocab)
    r = np.random.default_rng(11)
    c, x = (torch.as_tensor(r.integers(0, n, 512)) for _ in range(2))
    gen = torch.Generator(device=device).manual_seed(5)
    negs = w2v.sample_negatives(model._unigram_cdf(n), n, model.negative,
                                512, gen, device).cpu()
    hs1 = (r.normal(size=(n - 1, model.vector_size)) * 0.1).astype(
        np.float32)
    out = {}
    for kind in ("ns", "hs"):
        tables = {}
        for side, dev, dt in (("card", device, torch.float32),
                              ("cpu", "cpu", torch.float64)):
            s0 = torch.tensor(model.syn0, dtype=dt, device=dev)  # copies
            s1 = torch.tensor(model.syn1 if kind == "ns" else hs1,
                              dtype=dt, device=dev)
            if kind == "ns":
                loss = w2v.ns_update(s0, s1, c.to(dev), x.to(dev),
                                     negs.to(dev), 0.025)
            else:
                pts, cds, msk = model._huffman_tensors(dev)
                loss = w2v.hs_update(s0, s1, c.to(dev), x.to(dev), pts,
                                     cds.to(dt), msk.to(dt), 0.025)
            tables[side] = (
                float(loss), s0.double().cpu(), s1.double().cpu())
        card, cpu = tables["card"], tables["cpu"]
        errs = [flash_err(torch, card[i], cpu[i])[0] for i in (1, 2)]
        out[kind] = {"loss_card": card[0], "loss_cpu_f64": cpu[0],
                     "loss_err": abs(card[0] - cpu[0]) / abs(cpu[0]),
                     "syn0_err": errs[0], "syn1_err": errs[1]}
        if not max(errs + [out[kind]["loss_err"]]) <= PERIPHERY_TOL[
                "w2v_step"]:
            raise AssertionError(f"periphery/b: {kind} step card vs CPU "
                                 f"f64 {out[kind]}")
    out["tol"] = PERIPHERY_TOL["w2v_step"]
    return out


def periphery_word2vec(torch, np, cfg, device, sync, profile, tmpdir):
    """Part (b): Word2Vec's fit over the planted-topic corpus on
    ``device`` (pairs/s, words/s, the device's busy share over a window
    of ``probe_steps`` NS steps), its loss and topic structure, the NS/HS
    step checks, then ParagraphVectors and FastText on cut corpora and a
    serializer round trip."""
    from deeplearning4j_torch.nlp import (FastText, ParagraphVectors,
                                          Word2Vec, WordVectorSerializer)
    t_part = time.perf_counter()
    c = cfg["w2v"]
    sents, topic_of = zipf_topic_corpus(
        np, c["topics"], c["topic_words"], c["tokens"], c["sent_len"],
        c["zipf"], c["seed"])
    kw = dict(vector_size=c["layer_size"], window_size=c["window"],
              min_word_frequency=c["min_freq"], negative=c["negative"],
              seed=c["seed"], epochs=c["epochs"], device=device)
    m = Word2Vec(**kw)
    t0 = time.perf_counter()
    losses = m.fit(sents)
    sync()
    wall = time.perf_counter() - t0
    lengths = [sum(w in m.vocab for w in s.split()) for s in sents]
    n_pairs = window_pair_count(np, lengths, c["window"]) * c["epochs"]
    k = max(1, len(losses) // 20)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    same, other = topic_cosines(np, m.get_word_vector, c["topics"])
    if not (all(math.isfinite(v) for v in losses) and last < first
            and same > other):
        raise AssertionError(f"periphery/b: Word2Vec losses {first} -> "
                             f"{last}, topic cosines {same} vs {other}")
    # the device's share of a window of the same NS steps
    n = len(m.vocab)
    step = m._make_step(n)
    s0 = torch.tensor(m.syn0, device=device)      # copies: the steps
    s1 = torch.tensor(m.syn1, device=device)      # write in place
    gen = torch.Generator(device=device).manual_seed(1)
    pairs = torch.as_tensor(np.random.default_rng(4).integers(
        0, n, (c["probe_steps"], 512, 2)), device=device)

    def window():
        for i in range(c["probe_steps"]):
            step(s0, s1, pairs[i, :, 0], pairs[i, :, 1], 0.025, gen)
    prof = profile(window)
    out = {"settings": {k2: c[k2] for k2 in ("layer_size", "window",
                                             "min_freq", "negative",
                                             "seed", "epochs")},
           "corpus": {"tokens": c["tokens"], "sentences": len(sents),
                      "topics": c["topics"],
                      "topic_words": c["topic_words"], "zipf": c["zipf"]},
           "vocab": n, "pairs": n_pairs, "steps": len(losses),
           "fit_s": wall, "pairs_per_s": n_pairs / wall,
           "words_per_s": c["tokens"] * c["epochs"] / wall,
           "loss_first": first, "loss_last": last,
           "topic_cosine": {"same": same, "other": other},
           "ns_window": {"steps": c["probe_steps"], **prof}}
    out["step_checks"] = w2v_step_checks(torch, np, m, device)
    # ParagraphVectors on the first sentences (one document each)
    docs = sents[:cfg["pv_sentences"]]
    pv = ParagraphVectors(**kw)
    t0 = time.perf_counter()
    pv_losses = pv.fit(docs)
    pv_s = time.perf_counter() - t0
    dv = np.stack([pv.get_doc_vector(i) for i in range(len(docs))])
    dv /= np.linalg.norm(dv, axis=1, keepdims=True) + 1e-12
    tops = topic_of[:len(docs)]
    cent = np.stack([dv[tops == t].mean(0) for t in range(c["topics"])])
    own = float(np.mean(np.einsum("nd,nd->n", dv, cent[tops])))
    rest = float(np.mean(dv @ cent.T))
    if not (np.isfinite(pv_losses).all() and own > rest):
        raise AssertionError(f"periphery/b: ParagraphVectors doc/topic "
                             f"cosine {own} vs {rest}")
    out["paragraph_vectors"] = {"documents": len(docs), "vocab":
                                len(pv.vocab), "steps": len(pv_losses),
                                "fit_s": pv_s,
                                "doc_topic_cosine": {"own": own,
                                                     "mean": rest}}
    # FastText on the first ft_tokens words
    ft_sents = sents[:cfg["ft_tokens"] // c["sent_len"]]
    ft = FastText(bucket=cfg["ft_bucket"], **kw)
    t0 = time.perf_counter()
    ft_losses = ft.fit(ft_sents)
    sync()
    ft_wall = time.perf_counter() - t0
    fs, fo = topic_cosines(np, ft.get_word_vector, c["topics"])
    oov = ft.get_word_vector("t0w99999")
    k = max(1, len(ft_losses) // 20)
    if not (np.isfinite(ft_losses).all() and np.isfinite(oov).all()
            and np.mean(ft_losses[-k:]) < np.mean(ft_losses[:k])
            and fs > fo):
        raise AssertionError(f"periphery/b: FastText topic cosines {fs} vs "
                             f"{fo}")
    out["fasttext"] = {"tokens": len(ft_sents) * c["sent_len"],
                       "bucket": cfg["ft_bucket"], "vocab": len(ft.vocab),
                       "steps": len(ft_losses), "fit_s": ft_wall,
                       "topic_cosine": {"same": fs, "other": fo},
                       "oov_norm": float(np.linalg.norm(oov))}
    # the serializer round trip of the Word2Vec model
    path = os.path.join(tmpdir, "vectors.txt")
    t0 = time.perf_counter()
    WordVectorSerializer.write_word_vectors(m, path)
    back = WordVectorSerializer.read_word_vectors(path)
    ser_s = time.perf_counter() - t0
    ser_err = float(np.abs(back.syn0 - m.syn0).max())
    if back.index2word != m.index2word or not ser_err <= PERIPHERY_TOL[
            "serializer"]:
        raise AssertionError(f"periphery/b: serializer round trip {ser_err}")
    out["serializer"] = {"bytes": os.path.getsize(path), "seconds": ser_s,
                         "max_abs_err": ser_err,
                         "tol": PERIPHERY_TOL["serializer"]}
    out["reduced"] = [
        f"ParagraphVectors on the corpus's first {len(docs)} sentences",
        f"FastText on its first {len(ft_sents) * c['sent_len']} tokens"]
    out["seconds"] = time.perf_counter() - t_part
    return out


def periphery_rl(torch, np, cfg, device, sync):
    """Part (c): DQN, A3C (two actor threads) and async n-step Q-learning
    on ``device`` at the reference tests' gridworld configurations, each
    held to the return its test asserts; env steps per second."""
    from deeplearning4j_torch import rl
    n = cfg["grid"]
    out = {}
    t0 = time.perf_counter()
    ql = rl.QLearningDiscrete(rl.SimpleGridWorld(n),
                              rl.QLearningConfiguration(**cfg["dqn"]),
                              hidden=cfg["dqn_hidden"], device=device)
    rewards = ql.train()
    wall = time.perf_counter() - t0
    score = ql.get_policy().play(rl.SimpleGridWorld(n), max_steps=40)
    if not (len(rewards) > 5 and score > 0.8):
        raise AssertionError(f"periphery/c: DQN greedy return {score}")
    out["dqn"] = {"steps": ql.step_count, "episodes": len(rewards),
                  "greedy_return": score, "seconds": wall,
                  "steps_per_s": ql.step_count / wall}
    t0 = time.perf_counter()
    a3c = rl.A3CDiscrete(lambda: rl.SimpleGridWorld(n),
                         rl.A3CConfiguration(**cfg["a3c"]), device=device)
    rewards = a3c.train()
    wall = time.perf_counter() - t0
    early, late = float(np.mean(rewards[:10])), float(np.mean(rewards[-10:]))
    score = a3c.get_policy().play(rl.SimpleGridWorld(n), max_steps=50)
    if not (len(rewards) > 50 and late > 0.8 and late > early + 0.3
            and score > 0.8):
        raise AssertionError(f"periphery/c: A3C returns {early} -> {late}, "
                             f"greedy {score}")
    out["a3c"] = {"steps": a3c.step_count, "episodes": len(rewards),
                  "early": early, "late": late, "greedy_return": score,
                  "seconds": wall, "steps_per_s": a3c.step_count / wall}
    tries = []
    for seed in cfg["nstepq_seeds"]:
        t0 = time.perf_counter()
        nq = rl.AsyncNStepQLearningDiscrete(
            lambda: rl.SimpleGridWorld(n),
            rl.AsyncNStepQConfiguration(seed=seed, **cfg["nstepq"]),
            device=device)
        rewards = nq.train()
        wall = time.perf_counter() - t0
        tries.append({"seed": seed, "steps": nq.step_count,
                      "episodes": len(rewards),
                      "late": float(np.mean(rewards[-10:])),
                      "seconds": wall, "steps_per_s": nq.step_count / wall})
        if tries[-1]["late"] > 0.8:
            break
    if not tries[-1]["late"] > 0.8:
        raise AssertionError(f"periphery/c: async n-step Q {tries}")
    out["async_nstep_q"] = tries
    return out


def arbiter_data(np):
    """The reference arbiter test's data: 256 seeded points, the XOR of
    the first two features' signs, 192 to train in batches of 48."""
    from deeplearning4j_torch.data import DataSet, ListDataSetIterator
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 6)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[:, 0] * x[:, 1] > 0).astype(int)]
    return (ListDataSetIterator(DataSet(x[:192], y[:192]).batch_by(48)),
            ListDataSetIterator(DataSet(x[192:], y[192:]).batch_by(64)))


def arbiter_space():
    from deeplearning4j_torch.arbiter import (ContinuousParameterSpace,
                                              IntegerParameterSpace)
    return {"lr": ContinuousParameterSpace(1e-4, 0.3, log_scale=True),
            "hidden": IntegerParameterSpace(4, 32)}


def periphery_arbiter(np, cfg, device):
    """Part (d): the reference test's random search (seed 4, lr
    log-uniform in [1e-4, 0.3], hidden in [4, 32]), each candidate an MLP
    trained on ``device``; the candidates in the order the same generator
    gives on the host, the best accuracy above 0.8."""
    from deeplearning4j_torch.arbiter import (OptimizationRunner,
                                              RandomSearchGenerator)
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf import (DenseLayer,
                                              NeuralNetConfiguration,
                                              OutputLayer)
    from deeplearning4j_torch.optimize.updaters import Adam
    train, test = arbiter_data(np)

    def build(params):
        conf = (NeuralNetConfiguration.builder().seed(9)
                .updater(Adam(learning_rate=params["lr"])).list()
                .layer(DenseLayer(n_in=6, n_out=params["hidden"],
                                  activation="tanh"))
                .layer(OutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent"))
                .build())
        return MultiLayerNetwork(conf).init(device=device)

    def score(model, params):
        model.fit(train, n_epochs=cfg["arbiter_epochs"])
        return model.evaluate(test).accuracy()

    n = cfg["arbiter_candidates"]
    t0 = time.perf_counter()
    res = OptimizationRunner(RandomSearchGenerator(arbiter_space(), seed=4),
                             build, score, max_candidates=n).execute()
    wall = time.perf_counter() - t0
    gen = iter(RandomSearchGenerator(arbiter_space(), seed=4))
    host = [next(gen) for _ in range(n)]
    ran = [r["candidate"] for r in res.all_results]
    if ran != host or not res.best_score > 0.8:
        raise AssertionError(f"periphery/d: candidates {ran} vs {host}, "
                             f"best {res.best_score}")
    return {"candidates": ran, "scores": [r["score"]
                                          for r in res.all_results],
            "best_candidate": res.best_candidate,
            "best_score": res.best_score, "order_equals_host": True,
            "seconds": wall}


def periphery_ui(torch, np, cfg, device, sync, tmpdir):
    """Part (e): ``StatsListener`` into a ``FileStatsStorage`` beside a
    ``ProfilerListener(prof_start, prof_n)`` on Gpt() (bf16 on f32
    masters) for ``ui_steps`` fit steps at b ``ui_b``, t ``ui_t``: one
    record per step with parameter summaries, a Chrome trace naming the
    flash kernels the steps launched (K3, K5, K6 on the card), the HTML
    report.  Returns (row, the flash launch counts of the steps)."""
    from deeplearning4j_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_torch.ui import (FileStatsStorage, ProfilerListener,
                                         StatsListener, render_report)
    from deeplearning4j_torch.zoo import Gpt
    fa = flash_module()
    gpt = Gpt(seq_len=cfg["ui_t"], **cfg["ui_gpt"])
    net = gpt.init_graph(device=device)
    store = FileStatsStorage(os.path.join(tmpdir, "stats.jsonl"))
    prof = ProfilerListener(os.path.join(tmpdir, "trace"),
                            start_iteration=cfg["prof_start"],
                            n_iterations=cfg["prof_n"])
    net.set_listeners(StatsListener(store, collect_param_stats=True,
                                    param_stats_frequency=2), prof)
    # one epoch of ui_steps seeded batches: the profiler's window must lie
    # inside one fit (an epoch's end closes it, as in the reference)
    it = ListDataSetIterator([DataSet(*train_batch(
        np, cfg["ui_b"], cfg["ui_t"], gpt.vocab_size, 21 + i))
        for i in range(cfg["ui_steps"])])
    sync()
    for name in FLASH_WRAPPERS:
        getattr(fa, name).launches = 0
    t0 = time.perf_counter()
    net.fit(it, async_prefetch=False)
    sync()
    wall = time.perf_counter() - t0
    counts = {name: getattr(fa, name).launches for name in FLASH_WRAPPERS}
    n_layers = gpt.n_layers
    want = {"flash_fwd": n_layers * cfg["ui_steps"], "flash_fwd_single": 0,
            "flash_bwd_dkdv": n_layers * cfg["ui_steps"],
            "flash_bwd_dq": n_layers * cfg["ui_steps"]}
    if counts != want:
        raise AssertionError(f"periphery/e: launches {counts} != {want}")
    recs = store.records()
    if [r["iteration"] for r in recs] != list(range(cfg["ui_steps"])) or \
            "params" not in recs[0]:
        raise AssertionError(f"periphery/e: stats records "
                             f"{[sorted(r) for r in recs]}")
    with open(prof.trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    cats, by_class = {}, {}
    for e in events:
        cat = str(e.get("cat", "")).lower()
        cats[cat] = cats.get(cat, 0) + 1
        if cat == "kernel":
            cls = kernel_class(e.get("name", ""))
            by_class[cls] = by_class.get(cls, 0) + 1
    # the trace names each flash kernel, a launch a layer a step of its
    # window; the device tracer can start a few microseconds after the
    # window's first launch (an H100 trace missed one K3 of 24), so the
    # count is held to the window's last step at least — the counters
    # above hold the exact launches
    full = n_layers * cfg["prof_n"]
    if device == "cuda" and not all(
            full - n_layers < by_class.get(k, 0) <= full
            for k in ("K3", "K5", "K6")):
        raise AssertionError(f"periphery/e: trace kernels {by_class}, "
                             f"event categories {cats}")
    html = render_report(store, os.path.join(tmpdir, "report.html"),
                         title="Gpt() bf16")
    with open(html) as f:
        page = f.read()
    if "<svg" not in page or f"{cfg['ui_steps']} iterations" not in page:
        raise AssertionError("periphery/e: the report lacks its chart")
    return {"b": cfg["ui_b"], "t": cfg["ui_t"], "steps": cfg["ui_steps"],
            "records": len(recs), "param_leaves": len(recs[0]["params"]),
            "launches": counts, "trace_kernels_by_class": by_class,
            "trace_bytes": os.path.getsize(prof.trace_path),
            "report_bytes": len(page), "step_ms": wall * 1e3
            / cfg["ui_steps"]}, counts


def periphery_native(torch, np, cfg, device, sync, tmpdir):
    """Part (f): ``build_native`` (cmake, in the checkout), a seeded
    ``csv_rows`` x ``csv_cols`` CSV (the last column a class label),
    parsed natively and, its first ``csv_python_rows`` rows, by the
    port's ``CSVRecordReader`` (~12 k rows/s: the whole file would take
    ~17 s of the phase) — equal — rows/s of each, then one epoch of an
    MLP on ``device`` fed by ``NativeCSVRecordReader``."""
    import itertools

    from deeplearning4j_torch import native_io
    from deeplearning4j_torch.datavec import (CSVRecordReader,
                                              RecordReaderDataSetIterator)
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf import (DenseLayer,
                                              NeuralNetConfiguration,
                                              OutputLayer)
    from deeplearning4j_torch.optimize.updaters import Adam
    t0 = time.perf_counter()
    lib = native_io.build_native()
    build_s = time.perf_counter() - t0
    rows, cols, k = cfg["csv_rows"], cfg["csv_cols"], cfg["csv_classes"]
    r = np.random.default_rng(6)
    x = r.normal(size=(rows, cols - 1)).astype(np.float32)
    w = r.normal(size=(cols - 1, k))
    label = (x @ w).argmax(1)
    path = os.path.join(tmpdir, "data.csv")
    np.savetxt(path, np.column_stack([x, label]), fmt="%.6f", delimiter=",")
    t0 = time.perf_counter()
    nat = native_io.load_csv_native(path)
    nat_s = time.perf_counter() - t0
    n_py = min(rows, cfg["csv_python_rows"])
    t0 = time.perf_counter()
    py = np.asarray(list(itertools.islice(CSVRecordReader(path), n_py)),
                    np.float32)
    py_s = time.perf_counter() - t0
    if nat.shape != (rows, cols) or not np.array_equal(nat[:n_py], py):
        raise AssertionError(f"periphery/f: native parse {nat.shape} "
                             "differs from CSVRecordReader's")
    it = RecordReaderDataSetIterator(native_io.NativeCSVRecordReader(path),
                                     batch_size=cfg["csv_batch"],
                                     label_index=-1, n_classes=k)
    conf = (NeuralNetConfiguration.builder().seed(1)
            .updater(Adam(learning_rate=1e-2)).list()
            .layer(DenseLayer(n_in=cols - 1, n_out=64, activation="relu"))
            .layer(OutputLayer(n_out=k, activation="softmax",
                               loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init(device=device)
    first = float(net.score(next(iter(it))))
    t0 = time.perf_counter()
    net.fit(it, n_epochs=1)
    sync()
    fit_s = time.perf_counter() - t0
    last = float(net.score(next(iter(it))))
    if not last < first:
        raise AssertionError(f"periphery/f: the epoch's score {first} -> "
                             f"{last}")
    return {"library": os.path.relpath(lib, ROOT_DIR), "build_s": build_s,
            "rows": rows, "cols": cols, "bytes": os.path.getsize(path),
            "native_s": nat_s, "native_rows_per_s": rows / nat_s,
            "python_rows": n_py, "python_s": py_s,
            "python_rows_per_s": n_py / py_s,
            "parses_equal": True,
            "epoch": {"batches": -(-rows // cfg["csv_batch"]),
                      "fit_s": fit_s, "score_first_batch": [first, last]}}


def periphery_parts(torch, np, device, cfg, sync, card, profile, root):
    """Parts (a)-(f) of :func:`phase_periphery` on ``device`` at ``cfg``'s
    sizes; ``profile(fn)`` measures the device's share of ``fn()`` (the
    card's CUDA-only trace, :func:`step_profile`).  Emits a row per part
    as it ends (``periphery/<part>``) and a closing ``periphery`` row;
    returns part (e)'s flash launch counts."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="periphery-")
    row = {"phase": "periphery", "card": card}
    try:
        parts = (("a_keras", lambda: periphery_keras(torch, np, root, cfg,
                                                     device, sync)),
                 ("b_word2vec", lambda: periphery_word2vec(
                     torch, np, cfg, device, sync, profile, tmp)),
                 ("c_rl4j", lambda: periphery_rl(torch, np, cfg, device,
                                                 sync)),
                 ("d_arbiter", lambda: periphery_arbiter(np, cfg, device)))
        row["part_s"] = {}

        def run(key, fn):
            t0 = time.perf_counter()
            out = fn()
            row["part_s"][key] = time.perf_counter() - t0
            part = out[0] if isinstance(out, tuple) else out
            emit({"phase": f"periphery/{key}", "card": card, **part})
            return out
        for key, fn in parts:
            run(key, fn)
        _, counts = run("e_ui", lambda: periphery_ui(torch, np, cfg, device,
                                                     sync, tmp))
        run("f_native_io", lambda: periphery_native(torch, np, cfg, device,
                                                    sync, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["e_launches"] = counts
    row["reduced"] = [
        "seeded random weights for Keras's ResNet-50 (weights=None) and "
        "Gpt(); a seeded Zipf corpus of planted topics for the "
        "example's raw text, which is not in the repo",
        f"the Python CSVRecordReader parses the CSV's first "
        f"{cfg['csv_python_rows']} rows (the native parse all "
        f"{cfg['csv_rows']})"]
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    return counts


def phase_periphery(torch, np, root):
    """The periphery on the card (phase 9e): (a) Keras import — the
    committed LeNet golden (config + weights of a Keras 3.13.1 legacy
    h5, no h5py here) within 1e-5 of Keras's predict, Keras's ResNet-50
    functional config at 224 with seeded weights, f32 on the card
    against f64 on the CPU at b 2, then bf16 on f32 masters at b 64, 3
    timed fit steps (step ms, images/s, peak); (b) Word2Vec at
    dl4j-examples' Word2VecRawTextExample settings over a seeded Zipf
    corpus (64 topics x 300 words, 1,000,000 tokens): pairs/s, words/s,
    the device's busy share over 200 NS steps, the loss falls and
    same-topic words embed closer, one NS step (same negatives) and one
    HS step against the CPU in f64, then ParagraphVectors and FastText
    on cut corpora and a WordVectorSerializer round trip; (c) DQN, A3C
    and async n-step Q on the gridworld, each to the return its
    reference test asserts; (d) the arbiter random search, candidates in
    the host generator's order; (e) StatsListener, FileStatsStorage and
    ProfilerListener(start 2, n 2) on Gpt() bf16, b 8, t 2048, 5 steps:
    K3/K5/K6 launches counted from 0 and named in the trace, the HTML
    report; (f) native_io built with cmake, a seeded 200,000 x 32 CSV
    parsed natively and by CSVRecordReader (equal, rows/s), one MLP epoch
    from it.  Returns (e)'s launch counts."""
    def profile(fn):
        prof = step_profile(torch, fn)
        return {k: prof[k] for k in ("profiled_wall_ms", "device_ms",
                                     "device_events",
                                     "device_busy_share")}
    try:
        return periphery_parts(torch, np, "cuda", PERIPHERY_CFG,
                               torch.cuda.synchronize, card_line(), profile,
                               root)
    finally:
        torch.cuda.empty_cache()


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


def sdpa_bwd_ms(torch, F, sets, scale, n_sets, causal=True, mask=None):
    """SDPA's backward alone (dq, dk and dv together), timed as the
    kernels are, by CUDA-graph replay over the rotating input sets
    ``sets`` ((q, k, v, dO) in [b, h, t, dh]; ``mask`` an optional float
    ``attn_mask``, no gradient): the forwards are recorded beforehand on
    the capture stream, since autograd runs each backward op on its
    forward's stream, and ``torch.autograd.grad`` is captured.  Returns
    (median, sorted per-replay times)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        grad_in = [tuple(x.detach().requires_grad_(True) for x in z[:3])
                   for z in sets]
        outs = [F.scaled_dot_product_attention(*z, attn_mask=mask,
                                               is_causal=causal, scale=scale)
                for z in grad_in]
    torch.cuda.current_stream().wait_stream(side)
    return time_ms(torch, lambda i: torch.autograd.grad(
        outs[i % n_sets], grad_in[i % n_sets], sets[i % n_sets][3],
        retain_graph=True), stream=side, spread=True)


def flash_bound(n_products, b, t, h, dh, n_tensors, n_stats, causal=True,
                key_lens=None, dtype="bfloat16"):
    """(bound ms, 'bytes' | 'operations', flops, bytes): the larger of
    the flops over the peak of ``dtype`` (bf16 tensor cores, or f32
    outside them) and the bytes over HBM bandwidth.  Flops: 2 dh per
    (query, key) pair per product over the pairs the causal mask leaves
    — or, with ``key_lens`` (each batch row's valid keys under a padding
    bias), over every query and the valid keys of its row, the pairs
    this data needs; bytes:
    ``n_tensors`` [b, t, h, dh] operands in ``dtype`` and ``n_stats``
    [b*h, t] f32 stats, each read or written once."""
    if key_lens is not None:
        pairs_all = t * int(sum(key_lens))
    else:
        pairs_all = b * (t * (t + 1) // 2 if causal else t * t)
    f32 = dtype == "float32"
    flops = 2 * dh * n_products * pairs_all * h
    n_bytes = (n_tensors * b * t * h * dh * (4 if f32 else 2)
               + n_stats * b * h * t * 4)
    t_ops = flops / (H100_F32_FLOPS if f32 else H100_BF16_FLOPS) * 1e3
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, n_bytes)


def phase_timings_flash(torch, h=6, dh=128, phase="timings/flash", b=8,
                        ts=(2048, 512), causal=True, dtype="bfloat16",
                        bwd=True):
    """K3, K5 and K6 at the training path's shapes (``dtype``, bf16 unless
    asked, b 8, t 2048, ``h`` heads of ``dh`` (6 of 128), causal, bthd
    views of a [b, t, 3d] projection) and K4 at t 512, against their
    plain versions (``b``, ``ts`` = (K3/K5/K6's t, K4's t) and
    ``causal`` for other paths; ``bwd=False``: K3 and K4 alone);
    yardsticks: one
    ``F.scaled_dot_product_attention(is_causal=causal)`` call (forward) and
    its backward through autograd alone (dq, dk and dv together, on a
    forward recorded beforehand).  The port never calls SDPA.  Kernels,
    plain versions and both SDPA yardsticks are timed by CUDA-graph replay
    over 4 input sets in rotation (~300 MB, beyond the 50 MB L2); SDPA's
    backward with the spread of its 9 replays."""
    import torch.nn.functional as F
    fa = flash_module()
    dev, dt, NB = "cuda", getattr(torch, dtype), 4
    scale = dh ** -0.5
    g = torch.Generator(device=dev).manual_seed(9)
    bh = fa._to_bh
    rows = {}
    for t in ts:
        sets = []
        for _ in range(NB):
            qkv = torch.randn((b, t, 3 * h * dh), generator=g,
                              device=dev).to(dt)
            q, k, v = (z.reshape(b, t, h, dh)
                       for z in qkv.split(h * dh, dim=-1))
            do = torch.randn((b, t, h, dh), generator=g, device=dev).to(dt)
            sets.append((qkv, q, k, v, do))
        single = t == ts[1]
        fwd = fa.flash_fwd_single if single else fa.flash_fwd
        outs = [fwd(q, k, v, None, causal=causal, scale=scale)
                for _, q, k, v, _ in sets]
        deltas = [fa.row_delta(s[4], o) for s, (o, _) in zip(sets, outs)]
        plain_in = [tuple(bh(x) for x in s[1:]) for s in sets]
        sdpa_in = [tuple(x.transpose(1, 2).contiguous() for x in s[1:])
                   for s in sets]
        kern = {
            "fwd": lambda i: fwd(*sets[i % NB][1:4], None, causal=causal,
                                 scale=scale)}
        plain = {
            "fwd": lambda i: fa.flash_fwd_reference(
                *plain_in[i % NB][:3], None, causal=causal, scale=scale,
                single=single)}
        # errors of this run at these shapes (absolute, in dtype)
        ro, _ = plain["fwd"](0)
        errs = {"fwd": float((bh(outs[0][0]).float() - ro.float())
                             .abs().max())}
        del ro
        if not bwd or single:
            ms = {"kernel_fwd": time_ms(torch, kern["fwd"]),
                  "plain_fwd": time_ms(torch, plain["fwd"], n_inner=8,
                                       reps=5),
                  "kernel_fwd_again": time_ms(torch, kern["fwd"])}
            lib_fwd = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                *sdpa_in[i % NB][:3], is_causal=causal, scale=scale))
            name = "flash_fwd_single" if single else "flash_fwd"
            bound, by, flops, n_bytes = flash_bound(
                2, b, t, h, dh, 4, 1, causal=causal, dtype=dtype)
            rows[name] = {
                "kernel_ms": ms["kernel_fwd"], "plain_ms": ms["plain_fwd"],
                "library_ms": lib_fwd, "plain_scope": "kernel",
                "library_scope": "kernel", "bound_ms": bound,
                "bound_by": by, "flops": flops, "bytes": n_bytes,
                "max_abs_err": errs["fwd"],
                "kernel_ms_again": ms["kernel_fwd_again"],
                "build": fa.fwd_build(fa.kernel_head_dim(dh),
                                      dt == torch.bfloat16),
                "shapes": {"b": b, "t": t, "h": h, "dh": dh,
                           "dtype": dtype, "causal": causal}}
            del sets, outs, deltas, plain_in, sdpa_in
            torch.cuda.empty_cache()
            continue
        kern["dkdv"] = lambda i: fa.flash_bwd_dkdv(
            *sets[i % NB][1:4], None, sets[i % NB][4],
            outs[i % NB][1], deltas[i % NB], causal=causal,
            scale=scale)
        kern["dq"] = lambda i: fa.flash_bwd_dq(
            *sets[i % NB][1:4], None, sets[i % NB][4], outs[i % NB][1],
            deltas[i % NB], causal=causal, scale=scale)
        plain["bwd"] = lambda i: fa.flash_bwd_reference(
            *plain_in[i % NB][:3], None, plain_in[i % NB][3],
            outs[i % NB][1], deltas[i % NB], causal=causal,
            scale=scale)
        rq, rk, rv, _ = plain["bwd"](0)
        dk, dv, _ = kern["dkdv"](0)
        errs["dkdv"] = max(
            float((bh(dk).float() - rk.float()).abs().max()),
            float((bh(dv).float() - rv.float()).abs().max()))
        errs["dq"] = float((bh(kern["dq"](0)).float() - rq.float())
                           .abs().max())
        del rq, rk, rv, dk, dv
        ms = {f"kernel_{n}": time_ms(torch, fn) for n, fn in kern.items()}
        ms.update({f"plain_{n}": time_ms(torch, fn, n_inner=8, reps=5)
                   for n, fn in plain.items()})
        ms["kernel_fwd_again"] = time_ms(torch, kern["fwd"])
        lib_fwd = time_ms(torch, lambda i: F.scaled_dot_product_attention(
            *sdpa_in[i % NB][:3], is_causal=causal, scale=scale))
        lib_bwd, lib_bwd_reps = sdpa_bwd_ms(torch, F, sdpa_in, scale, NB,
                                            causal=causal)
        names = ({"fwd": "flash_fwd_single"} if single else
                 {"fwd": "flash_fwd", "dkdv": "flash_bwd_dkdv",
                  "dq": "flash_bwd_dq"})
        # (products, [b, t, h, dh] operands, f32 stats): fwd q k v -> O,
        # LSE; dkdv q k v dO -> dK dV, reading LSE and delta; dq likewise
        # -> dQ
        spec = {"fwd": (2, 4, 1), "dkdv": (4, 6, 2), "dq": (3, 5, 2)}
        for part, name in names.items():
            bound, by, flops, n_bytes = flash_bound(
                spec[part][0], b, t, h, dh, *spec[part][1:], causal=causal,
                dtype=dtype)
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
                           "dtype": dtype, "causal": causal}}
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


def phase_timings_bert(torch, np, phase="timings/bert"):
    """K4, K5 and K6 at BERT-base's training shape — the BERT main path's
    attention: bf16, b 32, t 512, 12 heads of 64, not causal, bthd views
    of a [b, t, 3d] projection, the main path's padding as the key bias,
    K5 without dBias — beside their plain versions and SDPA's forward and
    its backward alone on the same inputs with the bias as a float
    ``attn_mask`` ([b, 1, 1, t], bf16), timed as ``timings/flash``
    times them (graph replay over 4 input sets in rotation).  The bound
    counts the valid keys only (``flash_bound(key_lens=...)``)."""
    import torch.nn.functional as F
    fa = flash_module()
    dev, dt, NB = "cuda", torch.bfloat16, 4
    b, t, h, dh = BERT_B, BERT_T, 12, 64
    scale = dh ** -0.5
    g = torch.Generator(device=dev).manual_seed(10)
    bh = fa._to_bh
    lens = bert_lengths(np, b, t, BERT_SEED)
    bias = key_bias(torch, "bert", b, h, t, g)
    sets = []
    for _ in range(NB):
        qkv = torch.randn((b, t, 3 * h * dh), generator=g,
                          device=dev).to(dt)
        q, k, v = (z.reshape(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
        do = torch.randn((b, t, h, dh), generator=g, device=dev).to(dt)
        sets.append((qkv, q, k, v, do))
    kw = dict(causal=False, scale=scale)
    outs = [fa.flash_fwd_single(q, k, v, bias, **kw)
            for _, q, k, v, _ in sets]
    deltas = [fa.row_delta(z[4], o) for z, (o, _) in zip(sets, outs)]
    plain_in = [tuple(bh(x) for x in z[1:]) for z in sets]
    sdpa_in = [tuple(x.transpose(1, 2).contiguous() for x in z[1:])
               for z in sets]
    mask = bias.view(b, h, t)[:, :1, None, :].to(dt)      # [b, 1, 1, t]
    kern = {
        "fwd": lambda i: fa.flash_fwd_single(*sets[i % NB][1:4], bias, **kw),
        "dkdv": lambda i: fa.flash_bwd_dkdv(
            *sets[i % NB][1:4], bias, sets[i % NB][4], outs[i % NB][1],
            deltas[i % NB], need_dbias=False, **kw),
        "dq": lambda i: fa.flash_bwd_dq(
            *sets[i % NB][1:4], bias, sets[i % NB][4], outs[i % NB][1],
            deltas[i % NB], **kw)}
    plain = {
        "fwd": lambda i: fa.flash_fwd_reference(
            *plain_in[i % NB][:3], bias, single=True, **kw),
        "bwd": lambda i: fa.flash_bwd_reference(
            *plain_in[i % NB][:3], bias, plain_in[i % NB][3],
            outs[i % NB][1], deltas[i % NB], **kw)}
    ro, _ = plain["fwd"](0)
    rq, rk, rv, _ = plain["bwd"](0)
    dk, dv, _ = kern["dkdv"](0)
    errs = {"fwd": float((bh(outs[0][0]).float() - ro.float()).abs().max()),
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
        *sdpa_in[i % NB][:3], attn_mask=mask, scale=scale))
    lib_bwd, lib_bwd_reps = sdpa_bwd_ms(torch, F, sdpa_in, scale, NB,
                                        causal=False, mask=mask)
    names = {"fwd": "flash_fwd_single", "dkdv": "flash_bwd_dkdv",
             "dq": "flash_bwd_dq"}
    # (products, [b, t, h, dh] operands, f32 stats): fwd q k v -> O, bias
    # -> LSE; dkdv q k v dO -> dK dV, reading bias, LSE and delta; dq
    # likewise -> dQ
    spec = {"fwd": (2, 4, 2), "dkdv": (4, 6, 3), "dq": (3, 5, 3)}
    rows = {}
    for part, name in names.items():
        bound, by, flops, n_bytes = flash_bound(
            spec[part][0], b, t, h, dh, *spec[part][1:], key_lens=lens)
        rows[name] = {
            "kernel_ms": ms[f"kernel_{part}"],
            "plain_ms": ms["plain_fwd" if part == "fwd" else "plain_bwd"],
            "library_ms": lib_fwd if part == "fwd" else lib_bwd,
            "plain_scope": "kernel" if part == "fwd" else "bwd_all",
            "library_scope": "kernel" if part == "fwd" else "bwd_all",
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": n_bytes, "max_abs_err": errs[part],
            "shapes": {"b": b, "t": t, "h": h, "dh": dh,
                       "dtype": "bfloat16", "causal": False,
                       "bias": "padding, valid keys 64..512 per row",
                       "valid_keys": int(lens.sum())}}
    rows["flash_fwd_single"]["kernel_ms_again"] = ms["kernel_fwd_again"]
    for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
        rows[name]["library_reps_ms"] = lib_bwd_reps
    emit({"phase": phase, "kernels": rows,
          "library_note": "SDPA with the padding bias as a bf16 attn_mask "
                          "[b, 1, 1, t]; its backward alone through "
                          "autograd (dq, dk, dv together)",
          "card": card_line()})
    del sets, outs, deltas, plain_in, sdpa_in
    torch.cuda.empty_cache()
    return rows


def paged_bound(positions, h, dh, bs, L, W=None, dtype="bfloat16"):
    """(bound ms, "bytes" | "operations", bytes, flops) of one K1 call
    (``W`` None) or K2 call (``W`` rows a slot) at ``positions`` in
    ``dtype``: the K and V rows of each slot's context read once, q read
    and the output written once, the table entries and positions read;
    4 flops per (query, key) pair and head column, over the bf16
    tensor-core peak or, in float32, the f32 peak."""
    esz = 2 if dtype == "bfloat16" else 4
    if W is None:
        ctx, n_q = [p + 1 for p in positions], len(positions)
        keys = sum(ctx)
    else:
        ctx, n_q = [min(p + W, L) for p in positions], len(positions) * W
        keys = sum(min(p + w + 1, L) for p in positions for w in range(W))
    n_bytes = (sum(ctx) * h * dh * 2 * esz          # K and V rows read
               + 2 * n_q * h * dh * esz             # q read, out written
               + sum((c - 1) // bs + 1 for c in ctx) * 4
               + len(positions) * 4)
    n_flops = 4 * keys * h * dh
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / (H100_BF16_FLOPS if esz == 2 else H100_F32_FLOPS) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes, n_flops)


def phase_timings(torch, pa, positions, h=6, dh=128, phase="timings",
                  dtype="bfloat16"):
    """Median per-call times at the path shapes (``dtype``, 8 slots, ``h``
    heads of ``dh`` (6 of 128), block 16, 64-entry tables).  Calls cycle
    over 12 layers' pools (~300 MB), as one decode tick does, so the
    50 MB L2 cannot hold the working set.  ``build``: the builds the
    first call launched (``pa.paged_decode_attention.builds``)."""
    import torch.nn.functional as F
    dev, dname, dtype = "cuda", dtype, getattr(torch, dtype)
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
    pa.paged_decode_attention.builds = {}
    err = float((kern(0).float() - plain(0).float()).abs().max())
    builds = sorted(pa.paged_decode_attention.builds)
    ms = {name: time_ms(torch, fn) for name, fn in
          (("kernel", kern), ("plain", plain), ("library", lib),
           ("kernel_again", kern))}
    bound, by, n_bytes, n_flops = paged_bound(positions, h, dh, bs, mb * bs,
                                              dtype=dname)
    out = {"phase": phase, "shapes": {"B": B, "h": h, "dh": dh,
                                          "bs": bs, "max_blocks": mb,
                                          "dtype": dname,
                                          "pos": positions},
           "kernel_ms": ms["kernel"], "kernel_ms_again": ms["kernel_again"],
           "plain_ms": ms["plain"], "library_ms": ms["library"],
           "bound_ms": bound, "bound_by": by,
           "bytes": n_bytes, "flops": n_flops, "max_abs_err": err,
           "build": builds, "card": card_line()}
    emit(out)
    return out


def phase_timings_verify(torch, pa, positions, W=5, h=6, dh=128,
                         phase="timings/verify", dtype="bfloat16"):
    """K2 at the path shapes with W = 5 (k = 4): ``dtype``, 8 slots, ``h``
    heads of ``dh`` (6 of 128), block 16, 64-entry tables, chunks
    starting at ``positions``; 12 layers' pools in rotation as for K1.
    The yardstick is one SDPA call over K/V gathered beforehand with a
    [B, 1, W, L] causal mask; ``build`` as :func:`phase_timings`."""
    import torch.nn.functional as F
    dev, dname, dtype = "cuda", dtype, getattr(torch, dtype)
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
    pa.paged_verify_attention.builds = {}
    err = float((kern(0).float() - plain(0).float()).abs().max())
    builds = sorted(pa.paged_verify_attention.builds)
    ms = {name: time_ms(torch, fn) for name, fn in
          (("kernel", kern), ("plain", plain), ("library", lib),
           ("kernel_again", kern))}
    bound, by, n_bytes, n_flops = paged_bound(positions, h, dh, bs, L, W,
                                              dtype=dname)
    out = {"phase": phase,
           "shapes": {"B": B, "W": W, "h": h, "dh": dh, "bs": bs,
                      "max_blocks": mb, "dtype": dname,
                      "pos0": positions},
           "kernel_ms": ms["kernel"], "kernel_ms_again": ms["kernel_again"],
           "plain_ms": ms["plain"], "library_ms": ms["library"],
           "bound_ms": bound, "bound_by": by,
           "bytes": n_bytes, "flops": n_flops, "max_abs_err": err,
           "build": builds, "card": card_line()}
    emit(out)
    return out


# -- extra phase: chunked ---------------------------------------------
# (dtype, heads, head dim) past the wgmma builds, where K3-K6 take the
# chunked FMA build: f32 past 256 (zoo.Gpt(n_heads=2)'s 384), and the
# bf16 backward past 512 (2 heads of 576; the bf16 forward there runs the
# cluster kernel)
CHUNKED_SHAPES = (("float32", 2, 384), ("bfloat16", 2, 576))


def phase_chunked(torch):
    """K3-K6 at ``CHUNKED_SHAPES`` — the chunked FMA build, but K3 and K4
    in bf16, which take the cluster kernel — timed as phase 10b (a)
    times the wgmma builds (:func:`phase_timings_flash`: b 8, t 2048
    causal, K4 at t 512) beside their plain versions, SDPA and the
    bound, so the builds never redesigned can be ranked by how far they
    stand from their library call.  Emits one
    ``timings/chunked_<dtype>_dh<dh>`` line a shape."""
    try:
        return {f"{dt}_dh{dh}": phase_timings_flash(
            torch, h=h, dh=dh, dtype=dt,
            phase=f"timings/chunked_{dt}_dh{dh}")
            for dt, h, dh in CHUNKED_SHAPES}
    finally:
        torch.cuda.empty_cache()


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


# -- phase 10b: wide -------------------------------------------------------
# Gpt() at its widths (12 x 768, ff 3072, vocab 32000, bf16, seeded random
# weights) with wider heads — the reference's zoo.Gpt(n_heads=...)
# (deeplearning4j_tpu/zoo/gpt.py:62): (b) 3 heads of 256, (c) 4 of 192,
# forward and backward on the wgmma builds at those head dims; (d) 2 heads
# of 384, K3 and K4 on the 64-row wgmma kernel, K5 and K6 on the panel
# kernels; served: (e) 3 heads of 256 and (f) 2 of 384, K1 and K2 on
# their wide builds; (g) one head of 768, K3 and K4 on the cluster kernel
# (forward only: past 512 the backward is the chunked build).
WIDE_CFG = {"gpt": {}, "vocab": 32000, "b": 8, "t": 2048, "t_single": 512,
            "steps": 2, "heads": 3, "narrow": {"n_heads": 4},
            "wider": {"n_heads": 2}, "widest": {"n_heads": 1},
            "kernels": True,
            # part (e): Gpt(n_heads=3) served as phase 4(b) serves Gpt()
            "serve": {"gpt": {"n_heads": 3},
                      "server": {"n_slots": 8, "max_len": 1024,
                                 "block_size": 16, "tick_batch": 8,
                                 "compute_dtype": "bfloat16"},
                      "requests": 8, "spec_requests": 4,
                      "speculative": SPEC_FULL},
            # part (f): Gpt(n_heads=2) (2 heads of 384) served the same
            # way, phase 4(b)'s first 4 requests, then its 2 greedy ones
            # speculative
            "serve_wider": {"gpt": {"n_heads": 2},
                            "server": {"n_slots": 8, "max_len": 1024,
                                       "block_size": 16, "tick_batch": 8,
                                       "compute_dtype": "bfloat16"},
                            "requests": 4, "spec_requests": 2,
                            "speculative": SPEC_FULL}}


def wide_window(torch, fa, label, run, want, cfg, sync, reps=1):
    """``run()`` once as a warm-up whose flash launches' operands are
    replayed through the kernels against their plain versions
    (``infer_kernel_errors``, ``FLASH_TOL``); then every count set to 0,
    ``run()`` ``reps`` times, the counts read and, when ``cfg["kernels"]``
    (the card), held to ``want`` x ``reps``.  Returns (the warm-up's and
    the counted runs' results, the counted runs' wall seconds, counts,
    errors, peak bytes or None)."""
    rec, restore = infer_capture(fa)
    try:
        first = run()
    finally:
        restore()
    if set(rec) != {n for n, c in want.items() if c}:
        raise AssertionError(f"{label}: captured {sorted(rec)}")
    errs = infer_kernel_errors(torch, fa, rec, label)
    del rec
    bad = {k: v for k, v in errs.items()
           if not (math.isfinite(v) and v <= FLASH_TOL["bfloat16"])}
    if bad:
        raise AssertionError(f"{label}: kernel vs plain {bad}")
    sync()
    cuda = cfg["kernels"]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for name in FLASH_WRAPPERS:
        getattr(fa, name).launches = 0
    for name in ("flash_fwd", "flash_fwd_single"):
        getattr(fa, name).builds = {}
    t0 = time.perf_counter()
    outs = [run() for _ in range(reps)]
    sync()
    wall = time.perf_counter() - t0
    cnt = {name: getattr(fa, name).launches for name in FLASH_WRAPPERS}
    want = {n: c * reps for n, c in want.items()}
    if cuda and cnt != want:
        raise AssertionError(f"{label}: launches {cnt} != {want}")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    return [first] + outs, wall, cnt, errs, peak


def wide_forward(torch, np, fa, net, cfg, t, label, sync, plain=None,
                 build=None):
    """One counted ``output()`` of ``net`` at [b, t] after a warm-up (K3
    past t 512, K4 at it; once a layer): finite probabilities of shape
    [b, t, vocab].  With ``plain`` (the same seeded net on plain
    attention) its ``output()`` on the same tokens runs no flash kernel,
    and the two agree within ``FLASH_TOL["bfloat16"]`` by
    :func:`flash_err`.  With ``build`` (and the card) every counted
    launch went through that build (``<wrapper>.builds``)."""
    b, vocab = cfg["b"], cfg["vocab"]
    x = train_batch(np, b, t, vocab, 4)[0]
    fwd = "flash_fwd" if t > 512 else "flash_fwd_single"
    want = {n: (len(net.layers) - 2 if n == fwd else 0)
            for n in FLASH_WRAPPERS}
    ys, wall, cnt, errs, peak = wide_window(
        torch, fa, label, lambda: net.output(x), want, cfg, sync)
    builds = dict(getattr(fa, fwd).builds)
    if build is not None and cfg["kernels"] and builds != {build: want[fwd]}:
        raise AssertionError(f"{label}: launches by build {builds}, want "
                             f"{want[fwd]} on {build}")
    y = ys[-1]
    if tuple(y.shape) != (b, t, vocab) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{label}: output {tuple(y.shape)}, finite "
                             f"{bool(torch.isfinite(y).all())}")
    res = {"b": b, "t": t, "ms": wall * 1e3, "tokens_per_s": b * t / wall,
           "peak_allocated_bytes": peak, "launches": cnt, "builds": builds,
           "kernel_vs_plain": errs}
    if plain is not None:
        for name in FLASH_WRAPPERS:
            getattr(fa, name).launches = 0
        yp = plain.output(x)
        p_cnt = {name: getattr(fa, name).launches for name in FLASH_WRAPPERS}
        err, detail = flash_err(torch, y.float(), yp.float())
        del yp
        if not err <= FLASH_TOL["bfloat16"] or any(p_cnt.values()):
            raise AssertionError(f"{label}: output vs plain attention {err} "
                                 f"({detail}), plain launches {p_cnt}")
        res["plain_attention"] = {"err": err, **detail}
    return res


def wide_fit(torch, np, fa, net, make_plain, cfg, label, sync,
             profile=False):
    """``cfg["steps"]`` counted fit steps of ``net`` (a Gpt) at [b, t]
    after a warm-up (:func:`wide_window`; K3, K5 and K6 once a layer a
    step), finite losses, then the same steps of ``make_plain()`` — the
    same seeded init on plain attention — from the same batch: the two
    loss curves agree to bf16 rounding (1e-3), and no flash kernel runs.
    With ``profile`` (and the card) one more step is profiled."""
    from deeplearning4j_torch.data import DataSet
    t = cfg["t"]
    n_layers = len(net.layers) - 2
    ds = DataSet(*train_batch(np, cfg["b"], t, cfg["vocab"], 2))
    want = {n: (n_layers if n != "flash_fwd_single" else 0)
            for n in FLASH_WRAPPERS}
    losses, wall, cnt, errs, peak = wide_window(
        torch, fa, label, lambda: float(net.fit(ds)), want, cfg, sync,
        reps=cfg["steps"])
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: losses {losses}")
    row = {"b": cfg["b"], "t": t, "steps": cfg["steps"], "losses": losses,
           "step_ms": wall * 1e3 / cfg["steps"],
           "tokens_per_s": cfg["steps"] * cfg["b"] * t / wall,
           "peak_allocated_bytes": peak, "launches": cnt,
           "kernel_vs_plain": errs}
    if profile and cfg["kernels"]:
        row["profile"] = step_profile(torch, lambda: net.fit(ds))
    plain = make_plain()
    for name in FLASH_WRAPPERS:
        getattr(fa, name).launches = 0
    p_losses = [float(plain.fit(ds)) for _ in losses]
    p_cnt = {name: getattr(fa, name).launches for name in FLASH_WRAPPERS}
    curve = max(abs(a - c) / abs(c) for a, c in zip(losses, p_losses))
    if curve > 1e-3 or any(p_cnt.values()):
        raise AssertionError(f"{label}: plain-attention losses "
                             f"{p_losses} vs flash {losses} (max rel "
                             f"{curve}), launches {p_cnt}")
    row["plain_attention"] = {"losses": p_losses,
                              "loss_curve_max_rel_diff": curve}
    return row


def wide_parts(torch, np, device, cfg, sync, card):
    """Parts (b)-(d) and (g) of :func:`phase_wide` on ``device`` at
    ``cfg``'s sizes: (b) Gpt(n_heads=cfg["heads"]) — one output() at t
    (K3) and one at t_single (K4), then ``steps`` fit steps at t (K3, K5
    and K6 once a layer a step, :func:`wide_fit`, one more step
    profiled), each window after a warm-up (:func:`wide_window`); (c) the
    same forward at t and the same fit steps with ``cfg["narrow"]``; (d)
    (b)'s two output() windows, each held to the same net on plain
    attention, and (b)'s fit steps with ``cfg["wider"]``; (g) (d)'s two
    output() windows with ``cfg["widest"]``, every launch on the cluster
    build (no fit steps).  Emits ``wide/gpt`` and returns the launch
    counts by window."""
    from deeplearning4j_torch.zoo import Gpt
    fa = flash_module()
    t_phase = time.perf_counter()
    t = cfg["t"]
    row = {"phase": "wide/gpt", "card": card, "weights": "random (seeded)",
           "tol": FLASH_TOL["bfloat16"]}
    counts = {}
    both = (("fwd", t), ("fwd_single", cfg["t_single"]))
    for part, gpt, windows in (
            ("b", {**cfg["gpt"], "n_heads": cfg["heads"]}, both),
            ("c", {**cfg["gpt"], **cfg["narrow"]}, (("fwd", t),)),
            ("d", {**cfg["gpt"], **cfg["wider"]}, both),
            ("g", {**cfg["gpt"], **cfg["widest"]}, both)):
        def make(use_flash=True, gpt=gpt):
            return Gpt(seed=0, seq_len=t, use_flash=use_flash,
                       **gpt).init_graph(device=device)
        net = make()
        plain = make(False) if part in "dg" else None
        sub = {"n_layers": len(net.layers) - 2, "heads": gpt["n_heads"],
               "head_dim": gpt.get("d_model", 768) // gpt["n_heads"]}
        for label, tt in windows:
            sub[label] = wide_forward(
                torch, np, fa, net, cfg, tt, f"wide/{part}/{label}", sync,
                plain, build="cluster" if part == "g" else None)
        # (d)'s plain net has only run output(): it is the fresh
        # plain-attention control
        if part != "g":
            sub["fit"] = wide_fit(torch, np, fa, net,
                                  (lambda: plain) if plain is not None
                                  else lambda: make(False),
                                  cfg, f"wide/{part}/fit", sync,
                                  profile=part == "b")
        del net, plain
        if part == "b":
            row.update(sub)
            counts.update({w: sub[w]["launches"]
                           for w in ("fwd", "fwd_single", "fit")})
        elif part == "c":
            fwd = sub.pop("fwd")
            row["narrow"] = {"gpt": cfg["narrow"], **sub, **fwd}
            counts["narrow"] = fwd["launches"]
            counts["narrow_fit"] = sub["fit"]["launches"]
        elif part == "d":
            row["wider"] = {"gpt": cfg["wider"], **sub}
            counts["wider"] = sub["fwd"]["launches"]
            counts["wider_single"] = sub["fwd_single"]["launches"]
            counts["wider_fit"] = sub["fit"]["launches"]
        else:
            row["widest"] = {"gpt": cfg["widest"], **sub}
            counts["widest"] = sub["fwd"]["launches"]
            counts["widest_single"] = sub["fwd_single"]["launches"]
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    return counts


def paged_capture(gen_mod):
    """Wrap the two paged wrappers as the generation module calls them
    (``paged_decode_attention``, ``paged_verify_attention``) so each
    records a copy of its first call's operands; returns (records,
    restore)."""
    names = ("paged_decode_attention", "paged_verify_attention")
    saved = {n: getattr(gen_mod, n) for n in names}
    rec = {}

    def wrap(name, orig):
        def w(*a, **kw):
            if name not in rec:
                rec[name] = ([x.detach().clone() if hasattr(x, "detach")
                              else x for x in a], dict(kw))
            return orig(*a, **kw)
        return w
    for n, f in saved.items():
        setattr(gen_mod, n, wrap(n, f))

    def restore():
        for n, f in saved.items():
            setattr(gen_mod, n, f)
    return rec, restore


def paged_kernel_errors(torch, pa, rec, label):
    """Each captured paged launch replayed through its wrapper (the
    kernel on the card) against the plain version on the same operands,
    held to ``PAGED_TOL`` by ``flash_err``; ``label`` names the window in
    a failure."""
    errs = {}
    for name, (a, kw) in rec.items():
        kern = "K1" if name == "paged_decode_attention" else "K2"
        out = getattr(pa, name)(*a, **kw)
        ref = getattr(pa, f"{name}_reference")(*a[:5], kw["scale"])
        x, r = out.float(), ref.float()
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{label}: {name} non-finite")
        err = flash_err(torch, x, r)[0]
        tol = PAGED_TOL[kern][str(a[0].dtype).replace("torch.", "")]
        if not err <= tol:
            raise AssertionError(f"{label}: {name} vs plain {err} > {tol}")
        errs[name] = err
    return errs


def wide_serve(torch, np, pa, device, cfg, sync, card, system, reqs,
               key="serve"):
    """Parts (e) and (f) of :func:`phase_wide` (``key`` "serve" and
    "serve_wider"): ``Gpt(**cfg[key]["gpt"])`` at ``cfg``'s other widths
    (seeded weights) served through GenerationServer
    (``cfg[key]["server"]``): the first
    ``requests`` of ``reqs`` (greedy and sampled; ``system`` the shared
    prompt the warm-up seeds), then the first ``spec_requests`` greedy
    ones with ``speculative``.  Each window comes after a warm-up whose
    K1 (and K2) operands are replayed through the kernels against their
    plain versions (:func:`paged_kernel_errors`), whose route must be the
    wide builds' (``pa.call_route``); then the counts start from 0: K1 =
    n_layers a tick (the plain window) and K2 = n_layers a verify pass,
    more than none (the speculative one), every launch through the wide
    builds (``<wrapper>.builds`` on the card).  Greedy streams are
    held to offline ``generate()`` under the bf16 near-tie rule, sampled
    ones finish inside the vocabulary.  Emits ``wide/<key>`` and returns
    the launch counts by window."""
    from deeplearning4j_torch import telemetry
    from deeplearning4j_torch.models import generation as gen_mod
    from deeplearning4j_torch.models.generation import TransformerGenerator
    from deeplearning4j_torch.parallel import GenerationServer
    from deeplearning4j_torch.zoo import Gpt
    sv = cfg[key]
    t_phase = time.perf_counter()
    ticks = telemetry.get_registry().counter("generation_server_ticks_total")
    vocab = cfg["vocab"]
    gpt = {**cfg["gpt"], **sv["gpt"]}
    net = Gpt(seed=0, **gpt).init_graph(device=device)
    n_layers = len(net.layers) - 2
    kw = dict(sv["server"], device=device)
    reqs = reqs[:sv["requests"]]
    greedy = [i for i, (_, _, smp) in enumerate(reqs) if smp is None]
    gen = TransformerGenerator(net, compute_dtype=kw["compute_dtype"],
                               device=device)
    refs = {i: gen.generate(reqs[i][0][None], reqs[i][1])[0]
            for i in greedy}
    warm = np.concatenate([system, [7, 7, 7]]).astype(np.int32)
    row = {"phase": f"wide/{key}", "card": card,
           "weights": "random (seeded)",
           "gpt": sv["gpt"], "n_layers": n_layers,
           "head_dim": gpt.get("d_model", 768) // gpt["n_heads"],
           **sv["server"]}
    counts = {}
    for part, extra, part_reqs in (
            ("plain", {}, reqs),
            ("spec", {"speculative": sv["speculative"]},
             [reqs[i] for i in greedy[:sv["spec_requests"]]])):
        k1 = gen_mod.paged_decode_attention
        k2 = gen_mod.paged_verify_attention
        with GenerationServer(net, **kw, **extra) as srv:
            rec, restore = paged_capture(gen_mod)
            try:
                srv.submit(warm, 8)        # also seeds the shared prompt
            finally:
                restore()
            want = {"paged_decode_attention"} | (
                {"paged_verify_attention"} if extra else set())
            if set(rec) != want:
                raise AssertionError(f"wide/{key}/{part}: captured "
                                     f"{sorted(rec)}")
            errs = paged_kernel_errors(torch, pa, rec, f"wide/{key}/{part}")
            # the route each window's calls take (a function of their
            # shapes, which the warm-up's share)
            routes = {n: pa.call_route(
                a[0], a[1], a[3], n == "paged_verify_attention",
                kw.get("split_rows"),
                torch.cuda.get_device_properties(a[0].device)
                .multi_processor_count if a[0].is_cuda
                else pa.H100_SMS)[0] for n, (a, kw) in rec.items()}
            if cfg["kernels"] and set(routes.values()) != {"wide"}:
                raise AssertionError(f"wide/{key}/{part}: routes {routes}")
            del rec
            sync()
            t0 = ticks.value
            for k in (k1, k2):
                k.launches, k.builds = 0, {}
            outs, ttfts, wall = serve(srv, part_reqs)
            l1, l2, dt = k1.launches, k2.launches, ticks.value - t0
            builds = {"paged_decode_attention": dict(k1.builds),
                      "paged_verify_attention": dict(k2.builds)}
        check_finished(part_reqs, outs, vocab)
        pairs = ([(outs[i], refs[i]) for i in greedy] if part == "plain"
                 else [(o, refs[i]) for o, i in zip(outs, greedy)])
        ties = check_streams(torch, gen, pairs, NEAR_TIE_BF16)
        if cfg["kernels"] and device != "cpu" and builds != {
                "paged_decode_attention": {"wide": l1} if l1 else {},
                "paged_verify_attention": {"wide": l2} if l2 else {}}:
            raise AssertionError(f"wide/{key}/{part}: launches by build "
                                 f"{builds}, want the wide builds' alone")
        if cfg["kernels"]:
            if part == "plain" and not (l1 > 0 and l1 == n_layers * dt
                                        and l2 == 0):
                raise AssertionError(f"wide/{key}/plain: K1 {l1} != "
                                     f"{n_layers} layers x {dt} ticks, "
                                     f"K2 {l2}")
            if part == "spec" and not (l2 > 0 and l2 == n_layers * dt
                                       and l1 > 0):
                raise AssertionError(f"wide/{key}/spec: K2 {l2} != "
                                     f"{n_layers} layers x {dt} verify "
                                     f"passes (or none), K1 {l1}")
        new_tokens = sum(n for _, n, _ in part_reqs)
        row[part] = {"requests": len(part_reqs), "greedy": len(pairs),
                     "new_tokens": new_tokens, "seconds": wall,
                     "new_tokens_per_s": new_tokens / wall,
                     "ttft_p50_s": pct(ttfts, 0.50),
                     "ttft_p99_s": pct(ttfts, 0.99), "ticks": dt,
                     "k1_launches": l1, "k2_launches": l2,
                     "routes": routes, "builds": builds,
                     "kernel_vs_plain": errs, "near_ties": ties}
        counts[part] = {"paged_decode_attention": l1,
                        "paged_verify_attention": l2}
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    del net, gen
    return counts


def phase_wide(torch, np, pa):
    """Phase 10b: (a) the paged builds past head dim 128 timed at the
    serving path's shape (K1 and K2 in bf16 at ``WIDE_DH``: 4 heads of
    192, 3 of 256, 3 of 160, 2 of 384 and 2 of 512, all on the wide
    builds; in f32 at 3 heads of 256 on the any-dh kernel) and K3-K6 at
    b 8, 3 heads of 256, t 2048 causal, K4 at t 512, and again at 4
    heads of 192, 2 of 384 and 2 of 512, and K3 and K4 alone at
    ``CLUSTER_DH`` (1 head of 768, 2 of 576, 4 of 1024), each beside its
    plain version, SDPA and the bound, each held to the build it must
    launch; then (b)-(d) and (g), :func:`wide_parts` at ``WIDE_CFG``,
    and (e) and (f), :func:`wide_serve`.  Returns (the timings by build,
    the launch counts by window)."""
    mid = path_mid(np)
    paged = [(dh, h, "bfloat16") for dh, h in WIDE_DH] + [
        (256, 3, "float32")]
    timing = {
        # K1 and K2 on the wide builds (bf16) and on the any-dh kernel
        # (f32 at 3 heads of 256)
        **{f"dh{dh}{'' if dt == 'bfloat16' else '_f32'}_{kind}": fn(
            torch, pa, mid, h=h, dh=dh, dtype=dt,
            phase=f"timings/{pre}dh{dh}{'' if dt == 'bfloat16' else '_f32'}")
           for dh, h, dt in paged
           for kind, fn, pre in (("decode", phase_timings, ""),
                                 ("verify", phase_timings_verify,
                                  "verify_"))},
        "dh256": phase_timings_flash(torch, h=3, dh=256,
                                     phase="timings/flash_dh256"),
        "dh192": phase_timings_flash(torch, h=4, dh=192,
                                     phase="timings/flash_dh192"),
        # past 256: (d)'s 2 heads of 384, and 2 of 512
        "dh384": phase_timings_flash(torch, h=2, dh=384,
                                     phase="timings/flash_dh384"),
        "dh512": phase_timings_flash(torch, h=2, dh=512,
                                     phase="timings/flash_dh512"),
        # past 512, K3 and K4 alone on the cluster kernel: (g)'s one head
        # of 768, 2 heads of 576 (3 x 192 columns a cluster) and 4 of
        # 1024 (4 x 256)
        **{f"dh{dh}": phase_timings_flash(torch, h=h, dh=dh, bwd=False,
                                          phase=f"timings/flash_dh{dh}")
           for dh, h in CLUSTER_DH}}
    for dh, _ in CLUSTER_DH:
        got = {n: r["build"] for n, r in timing[f"dh{dh}"].items()}
        if set(got.values()) != {"cluster"}:
            raise AssertionError(f"wide/a: K3/K4 at dh {dh} took {got}, "
                                 "want the cluster build")
    for dh, _, dt in paged:
        for kind in ("decode", "verify"):
            want = ["wide" if dt == "bfloat16" else "any_dh"]
            key = f"dh{dh}{'' if dt == 'bfloat16' else '_f32'}_{kind}"
            if timing[key]["build"] != want:
                raise AssertionError(f"wide/a: paged {kind} at dh {dh} "
                                     f"({dt}) launched "
                                     f"{timing[key]['build']}, want {want}")
    try:
        card = card_line()
        counts = wide_parts(torch, np, "cuda", WIDE_CFG,
                            torch.cuda.synchronize, card)
        system, reqs = mixed_requests(np, WIDE_CFG["vocab"])
        for key in ("serve", "serve_wider"):
            counts[key] = wide_serve(torch, np, pa, "cuda", WIDE_CFG,
                                     torch.cuda.synchronize, card, system,
                                     reqs, key)
    finally:
        torch.cuda.empty_cache()
    return timing, counts


def wide_sub(timing):
    """A timing row's numbers as a sub-entry of a ``kernels`` row (a
    build past the path's head dim)."""
    keys = ("max_abs_err", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shapes")
    return {"ms": timing["kernel_ms"],
            **{k: timing[k] for k in keys if k in timing}}


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
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--dist-worker"]:
        return dist_worker(argv[1:])
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
        b_counts, b_timing, s_launches, r_counts = None, None, None, None
        i_counts, sd_launches, m_counts, d_counts = None, None, None, None
        p_counts, w_timing, wide_res, c_timing = None, None, None, None
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
        if "slo" in phases:
            s_launches = phase_slo(torch, np, pa)
        if "train" in phases:
            t_counts = phase_train(torch, np)
        if "resume" in phases:
            r_counts = phase_resume(torch, np)
        if "rnn" in phases:
            phase_rnn(torch, np, root)
        if "bert" in phases:
            b_counts = phase_bert(torch, np)
        if "resnet" in phases:
            phase_resnet(torch, np, root)
        if "infer" in phases:
            i_counts = phase_infer(torch, np)
        if "samediff" in phases:
            sd_launches = phase_samediff(torch, np)
        if "mesh" in phases:
            m_counts = phase_mesh(torch, np)
        if "dist" in phases:
            d_counts = phase_dist(torch, np)
        if "periphery" in phases:
            p_counts = phase_periphery(torch, np, root)
        if "timings" in phases:
            mid = path_mid(np)
            timing = phase_timings(torch, pa, mid)
            v_timing = phase_timings_verify(torch, pa, mid)
            f_timing = phase_timings_flash(torch)
            b_timing = phase_timings_bert(torch, np)
            # K3-K6 at infer (g)'s shapes: 2 heads of 320 (K3/K4 on the
            # 64-row wgmma kernel, K5/K6 on the panel kernels), b 16,
            # t 1024 (K3, K5, K6) and t 512 (K4)
            w_timing = phase_timings_flash(
                torch, h=INFER_CFG["wide_heads"], dh=INFER_CFG["wide_head"],
                phase=f"timings/flash_dh{INFER_CFG['wide_head']}",
                b=INFER_CFG["wide_b"],
                ts=(INFER_CFG["attn_t_long"], INFER_CFG["attn_t"]),
                causal=False)
        elif "kbert" in phases:
            phase_timings_bert(torch, np)
        if "profile" in phases:
            phase_profile(torch, np)
        if "bertops" in phases:
            phase_bert_ops(torch, np)
        for which in SOLO_SHAPES:
            if which in phases:
                phase_solo(torch, which)
        if "k2" in phases:
            phase_solo_verify(torch, pa, path_mid(np))
        if "chunked" in phases:
            c_timing = phase_chunked(torch)
        if "wide" in phases:
            wide_res = phase_wide(torch, np, pa)
        if None not in (launches, timing, v_launches, v_timing, t_counts,
                        f_timing, b_counts, b_timing):
            rows = [
                kernel_row("paged_decode_attention", "paged_decode.cu",
                           "paged_attention.py:110", launches,
                           timing["max_abs_err"], timing),
                kernel_row("paged_verify_attention", "paged_verify.cu",
                           "paged_attention.py:228", v_launches,
                           v_timing["max_abs_err"], v_timing)]
            if s_launches is not None:
                # the same kernels on the SLO phase's burst (phase 6b)
                rows[0]["slo"] = {"launches": s_launches["k1"]}
                rows[1]["slo"] = {"launches": s_launches["k2"]}
            if m_counts is not None and "serve" in m_counts:
                # the same kernels on the tp = 2 replica (phase 9d (a)),
                # both shards' launches, by part
                for i, name in ((0, "paged_decode_attention"),
                                (1, "paged_verify_attention")):
                    by = {p: c[name] for p, c in m_counts["serve"].items()
                          if name in c}
                    rows[i]["mesh"] = {"launches": sum(by.values()),
                                       "by_part": by}
            if d_counts is not None and "serve" in d_counts:
                # K1 and K2 on the data 2 x tp 2 replica of phase 9f (e)
                for i, name in ((0, "paged_decode_attention"),
                                (1, "paged_verify_attention")):
                    rows[i]["dist"] = {"launches": d_counts["serve"][name]}
            if wide_res is not None:
                # K1 and K2 past head dim 128 (phase 10b): the wide builds
                # timed in (a) at every bf16 width of WIDE_DH — launched
                # by (e)'s Gpt(n_heads=3) server at 256 and (f)'s
                # Gpt(n_heads=2) at 384 (both windows of each), timed only
                # at 192, 160 and 512 — and the any-dh kernel in f32 at 3
                # heads of 256 (timed only).  ``build``: the kernel of the
                # build each timed call launched (``<wrapper>.builds``);
                # the ``gpu`` test
                # test_cuda_wide_builds_launch_the_wide_kernels holds each
                # build to that kernel by torch.profiler
                w_time, w_cnt = wide_res
                served = {"dh256": "serve", "dh384": "serve_wider"}
                for i, name, kind, src in (
                        (0, "paged_decode_attention", "decode",
                         "paged_decode.cu"),
                        (1, "paged_verify_attention", "verify",
                         "paged_verify.cu")):
                    for tag in [f"dh{dh}" for dh, _ in WIDE_DH] + [
                            "dh256_f32"]:
                        build = w_time[f"{tag}_{kind}"]["build"][0]
                        rows[i][tag] = {
                            "launches": (sum(c[name] for c in
                                             w_cnt[served[tag]].values())
                                         if tag in served else None),
                            "build": {
                                "wide": f"paged_{kind}_wide_kernel",
                                "any_dh": "paged_any_dh_kernel"}[build],
                            "source": "deeplearning4j_torch/kernels/csrc/"
                            + (src if build == "wide"
                               else "paged_any_dh.cuh"),
                            **wide_sub(w_time[f"{tag}_{kind}"])}
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
                if r_counts is not None and t == 2048:
                    # the same kernel on the resumed run (phase 7b)
                    rows[-1]["resume"] = {"launches": r_counts[name]}
                if i_counts is not None:
                    # the same kernel on the infer phase's attention
                    # classifier (phase 9b (f)), by window
                    by = {w: c[name] for w, c in i_counts.items()}
                    rows[-1]["infer"] = {"launches": sum(by.values()),
                                         "by_window": by}
                if m_counts is not None and "train" in m_counts:
                    # the same kernel under the mesh trainer (phase 9d
                    # (b)): data, model and pipeline axes
                    by = {p: c[name] for p, c in m_counts["train"].items()}
                    rows[-1]["mesh"] = {"launches": sum(by.values()),
                                        "by_part": by}
                if d_counts is not None:
                    # the same kernel in the cross-process workers of
                    # phase 9f, summed over the workers of each part
                    by = {p: c[name] for p, c in d_counts.items()
                          if name in c}
                    rows[-1]["dist"] = {"launches": sum(by.values()),
                                        "by_part": by}
                if p_counts is not None:
                    # the same kernel under the ui listeners on Gpt()
                    # (phase 9e (e))
                    rows[-1]["periphery"] = {"launches": p_counts[name]}
                if w_timing is not None and name in w_timing:
                    # the builds past head dim 256 (phase 9b (g)), timed
                    # at its shapes
                    wide = f"dh{INFER_CFG['wide_head']}_"
                    rows[-1][f"dh{INFER_CFG['wide_head']}"] = {
                        "launches": (sum(c[name] for w, c in i_counts.items()
                                         if w.startswith(wide))
                                     if i_counts is not None else None),
                        **wide_sub(w_timing[name])}
                if wide_res is not None:
                    # the builds at head dims 256 and 192 (phase 10b):
                    # timed in (a), launched on Gpt(n_heads=3)'s forward
                    # and fit steps in (b) and Gpt(n_heads=4)'s in (c);
                    # those at 384 on Gpt(n_heads=2)'s in (d), and at
                    # 512 (timed only, no path runs them)
                    w_time, w_cnt = wide_res
                    for dh, windows in (("dh256", ("fwd", "fwd_single",
                                                   "fit")),
                                        ("dh192", ("narrow",
                                                   "narrow_fit")),
                                        ("dh384", ("wider", "wider_single",
                                                   "wider_fit")),
                                        ("dh512", None),
                                        # the cluster kernel: at 768 on
                                        # Gpt(n_heads=1)'s forward in (g)
                                        ("dh768", ("widest",
                                                   "widest_single")),
                                        ("dh576", None), ("dh1024", None)):
                        if name not in w_time[dh]:
                            continue
                        rows[-1][dh] = {
                            "launches": (None if windows is None else
                                         sum(w_cnt[w][name]
                                             for w in windows)),
                            **wide_sub(w_time[dh][name])}
                        if "build" in w_time[dh][name]:
                            rows[-1][dh]["build"] = {
                                "cluster": "flash_fwd_bf16_cluster_kernel"
                            }.get(w_time[dh][name]["build"],
                                  w_time[dh][name]["build"])
                if c_timing is not None:
                    # the chunked FMA build (extra phase ``chunked``):
                    # timed only, no path runs it
                    for tag, ct in c_timing.items():
                        rows[-1][f"chunked_{tag}"] = {
                            "launches": None, **wide_sub(ct[name])}
                if sd_launches is not None:
                    # the same kernel on the imported graphs (phase 9c):
                    # BERT-base's counted fine-tune and gpt_toy's
                    by = {w: c[name] for w, c in sd_launches.items()}
                    rows[-1]["samediff"] = {"launches": sum(by.values()),
                                            "by_part": by}
                if name in b_timing:
                    # the same kernel on the BERT main path (phase 8) at
                    # its training shape (timings/bert)
                    bt = b_timing[name]
                    rows[-1]["bert"] = {
                        "launches": b_counts[name], "ms": bt["kernel_ms"],
                        "plain_ms": bt["plain_ms"],
                        "bound_ms": bt["bound_ms"],
                        "bound_by": bt["bound_by"],
                        "library_ms": bt["library_ms"],
                        "max_abs_err": bt["max_abs_err"],
                        "shapes": bt["shapes"]}
            if wide_res is not None:
                # the cluster kernel (bf16 K3 and K4 past head dim 512) in
                # rows of its own: launched on (g)'s Gpt(n_heads=1)
                # forward, timed in (a) at that shape (b 8, one head of
                # 768, t 2048 causal; K4 t 512)
                w_time, w_cnt = wide_res
                for name, tpu, window in (
                        ("flash_fwd", "flash_attention.py:95", "widest"),
                        ("flash_fwd_single", "flash_attention.py:164",
                         "widest_single")):
                    ct = w_time["dh768"][name]
                    rows.append({**kernel_row(
                        f"{name}/cluster", "flash_fwd.cu", tpu,
                        w_cnt[window][name], ct["max_abs_err"], ct),
                        "build": "flash_fwd_bf16_cluster_kernel",
                        "shapes": ct["shapes"]})
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
