"""KV-cache incremental decoding (port of
``deeplearning4j_tpu/models/generation.py``).

The prompt prefills in ONE batched causal forward; decode then runs one
token per tick against per-layer K/V caches.  Where the reference scans
a stacked ``[n_layers]`` parameter axis with ``lax.scan``, the port loops
over the layers in Python; where the reference threads immutable caches
through ``dynamic_update_slice``/``.at[].set``, the port writes its cache
tensors IN PLACE.

Two cache layouts share the block math:

* the STRIPE layout of offline ``generate()`` — caches [n_layers, b, h,
  L, dh], written at the tick's position (``_block_decode_step``);
* the PAGED layout of the generation server — a global block pool
  [n_layers, n_blocks, h, block_size, dh] addressed through per-slot
  block tables (``_block_decode_step_paged``), attention through
  ``kernels.paged_decode_attention`` (the CUDA kernel on the card, its
  plain version on the CPU).  The speculative verification pass
  (``_verify_rows_paged``) runs W tokens per slot through the same
  block body on flat [B*W, d] rows, attention through
  ``kernels.paged_verify_attention``.

Numerics mirror the reference op for op (f32 scores, -1e9 masks, f32
softmax cast to V's dtype, f32 layer norms, f32 head), which is what the
cross-framework parity tests hold the port to.  Works over any
``MultiLayerNetwork`` whose stack is ``EmbeddingSequenceLayer -> N x
TransformerEncoderBlock(causal=True) -> (Rnn)OutputLayer`` (``zoo.Gpt``).

Sampling draws are a pure function of (seed, stream, position, token id)
(``_gumbel_rows``, Gumbel-max over the filtered logits), so a request's
sampled stream is reproducible per seed and does not depend on how many
ticks a dispatch fuses or which slot it rides in.  ``jax.random`` streams
cannot be reproduced in torch; sampled output is compared across the two
packages by distribution only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch import telemetry
from deeplearning4j_torch.kernels.paged_attention import (
    paged_decode_attention, paged_verify_attention)
from deeplearning4j_torch.nn.activations import get_activation
from deeplearning4j_torch.nn.conf.layers_core import OutputLayer
from deeplearning4j_torch.nn.conf.layers_transformer import (
    EmbeddingSequenceLayer, TransformerEncoderBlock, _layer_norm)
from deeplearning4j_torch.runtime.backend import resolve_device
from deeplearning4j_torch.runtime.dtype import canonical_dtype


def _embed_token(ly: EmbeddingSequenceLayer, params, tok, pos):
    """[b] int token -> [b, d].  ``pos`` is an int (one shared position,
    offline decode) or a [b] int tensor (per-row positions, the server's
    slots)."""
    y = params["W"][tok.long()]
    if ly.add_positional:
        p = pos if isinstance(pos, int) else pos.long()
        y = y + params["P"][p]
    if ly.layer_norm:
        y = _layer_norm(y, params["g"], params["b"], ly.eps)
    return y


def _ffn_and_norms(ly: TransformerEncoderBlock, params, x, att):
    """The block's tail after attention: ``att @ Wo``, residual + LN1,
    the feed-forward (``self.activation or "gelu"``), residual + LN2."""
    cast = lambda w: w.to(x.dtype)
    att = att @ cast(params["Wo"]) + cast(params["bo"])
    hdn = _layer_norm(x + att, params["ln1_g"], params["ln1_b"], ly.eps)
    act = get_activation(ly.activation or "gelu")
    ffn = act(hdn @ cast(params["W1"]) + cast(params["b1"]))
    ffn = ffn @ cast(params["W2"]) + cast(params["b2"])
    return _layer_norm(hdn + ffn, params["ln2_g"], params["ln2_b"], ly.eps)


def _qkv(ly: TransformerEncoderBlock, params, x):
    """Fused q|k|v projection of [..., d] -> three [..., d] views."""
    d = x.shape[-1]
    qkv = x @ params["Wqkv"].to(x.dtype) + params["bqkv"].to(x.dtype)
    return torch.split(qkv, d, dim=-1)


def _block_decode_step(ly: TransformerEncoderBlock, params, kcache,
                       vcache, x, pos):
    """One cached decoder step.  x: [b, d] new-token hidden; caches
    [b, h, L, dh], written IN PLACE at ``pos``; attends over <= pos.
    ``pos`` is an int (whole batch at one position) or a [b] tensor.
    Returns (y [b, d], kcache, vcache)."""
    b, d = x.shape
    h, dh = ly.n_heads, d // ly.n_heads
    L = kcache.shape[2]
    q, k, v = _qkv(ly, params, x)
    q = q.reshape(b, h, 1, dh)
    k, v = k.reshape(b, h, dh), v.reshape(b, h, dh)
    ar = torch.arange(L, device=x.device)
    if isinstance(pos, int):
        kcache[:, :, pos] = k
        vcache[:, :, pos] = v
        valid = (ar <= pos)[None, None, None, :]
    else:
        rows = torch.arange(b, device=x.device)
        kcache[rows, :, pos.long()] = k
        vcache[rows, :, pos.long()] = v
        valid = (ar[None, :] <= pos.long()[:, None])[:, None, None, :]
    scale = 1.0 / (dh ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kcache).float()
    s = s * scale
    s = torch.where(valid, s, -1e9)
    p = torch.softmax(s, dim=-1).to(vcache.dtype)
    att = torch.einsum("bhqk,bhkd->bhqd", p, vcache)
    att = att.transpose(1, 2).reshape(b, d)
    return _ffn_and_norms(ly, params, x, att), kcache, vcache


def _block_decode_step_paged(ly: TransformerEncoderBlock, params, kpool,
                             vpool, x, pos, table, wblk, woff):
    """Paged-cache variant of ``_block_decode_step``: x [b, d]; pools
    [n_blocks, h, block_size, dh]; ``table`` [b, max_blocks] int32; the
    new K/V row lands at (``wblk``, ``woff``) per slot — the caller masks
    inactive slots to the scratch block 0, offset 0 — and attention reads
    THROUGH the table.  Returns (y [b, d], kpool, vpool)."""
    b, d = x.shape
    h, dh = ly.n_heads, d // ly.n_heads
    q, k, v = _qkv(ly, params, x)
    q = q.reshape(b, h, dh).contiguous()
    # in-place pool write (the reference's kpool.at[wblk, :, woff, :]
    # .set(k)); masked slots all write block 0 offset 0 — duplicate
    # indices there are harmless because block 0 is never read
    wb, wo = wblk.long(), woff.long()
    kpool[wb, :, wo, :] = k.reshape(b, h, dh)
    vpool[wb, :, wo, :] = v.reshape(b, h, dh)
    att = paged_decode_attention(q, kpool, vpool, table, pos,
                                 scale=1.0 / (dh ** 0.5))
    return (_ffn_and_norms(ly, params, x, att.reshape(b, d)), kpool,
            vpool)


def _block_verify_step_paged(ly: TransformerEncoderBlock, params, kpool,
                             vpool, x, table, wblk, woff, pos0):
    """W-token verification step for speculative decode: one block's
    forward over a chunk of W tokens per slot.  ``x`` is FLAT [B*W, d] —
    the matmuls and layer norms run on 2-D rows as in the decode step —
    K/V are written through the block table at (``wblk``, ``woff``)
    [B, W] (masked rows at the scratch block 0) and attention reads back
    through ``paged_verify_attention`` with query row j at position
    ``pos0 + j``.  Returns (y [B*W, d], kpool, vpool)."""
    BW, d = x.shape
    B, W = wblk.shape
    h, dh = ly.n_heads, d // ly.n_heads
    q, k, v = _qkv(ly, params, x)
    q = q.reshape(B, W, h, dh).contiguous()
    wb, wo = wblk.long(), woff.long()
    kpool[wb, :, wo, :] = k.reshape(B, W, h, dh)
    vpool[wb, :, wo, :] = v.reshape(B, W, h, dh)
    att = paged_verify_attention(q, kpool, vpool, table, pos0,
                                 scale=1.0 / (dh ** 0.5))
    return (_ffn_and_norms(ly, params, x, att.reshape(BW, d)), kpool,
            vpool)


def _embed_prompt(ly: EmbeddingSequenceLayer, params, ids):
    """[b, t0] int prompt -> [b, t0, d] (positions 0..t0-1)."""
    y = params["W"][ids.long()]
    if ly.add_positional:
        y = y + params["P"][: ids.shape[1]][None]
    if ly.layer_norm:
        y = _layer_norm(y, params["g"], params["b"], ly.eps)
    return y


def _causal_block(ly: TransformerEncoderBlock, params, x, kk, vv, q, mask):
    """Attention of ``q`` [b, h, s, dh] over ``kk``/``vv`` [b, h, T, dh]
    under ``mask`` [s, T], then the block tail — the prefill math
    (f32 scores, -1e9 mask, f32 softmax cast to V's dtype)."""
    b, s_len, d = x.shape
    dh = d // ly.n_heads
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk).float() * (1.0 / (dh ** 0.5))
    s = torch.where(mask[None, None], s, -1e9)
    p = torch.softmax(s, dim=-1).to(vv.dtype)
    att = torch.einsum("bhqk,bhkd->bhqd", p, vv)
    att = att.transpose(1, 2).reshape(b, s_len, d)
    return _ffn_and_norms(ly, params, x, att)


def _block_prefill(ly: TransformerEncoderBlock, params, x):
    """Whole-prompt causal forward for one block: x [b, t, d] ->
    (y [b, t, d], k [b, h, t, dh], v) — ONE batched pass instead of t
    cached single-token steps."""
    b, t, d = x.shape
    h, dh = ly.n_heads, d // ly.n_heads
    split = lambda z: z.reshape(b, t, h, dh).transpose(1, 2)
    q, k, v = (split(z) for z in _qkv(ly, params, x))
    ar = torch.arange(t, device=x.device)
    mask = ar[None, :] <= ar[:, None]
    return _causal_block(ly, params, x, k, v, q, mask), k, v


def _block_prefill_chunked(ly: TransformerEncoderBlock, params, x, pk, pv,
                           p0: int):
    """Chunked (suffix) causal forward for one block: the query rows are
    the UNCACHED prompt suffix at global positions p0..p0+s-1 and the key
    set is [cached prefix K/V ; suffix K/V].  x: [b, s, d]; ``pk``/``pv``
    [b, h, P, dh] gathered prefix rows (valid cols < ``p0``).  Returns
    (y, k, v) with k/v the SUFFIX rows only."""
    b, s_len, d = x.shape
    h, dh = ly.n_heads, d // ly.n_heads
    split = lambda z: z.reshape(b, s_len, h, dh).transpose(1, 2)
    q, k, v = (split(z) for z in _qkv(ly, params, x))
    P = pk.shape[2]
    kk = torch.cat([pk, k], dim=2)              # [b, h, P+s, dh]
    vv = torch.cat([pv, v], dim=2)
    cols = torch.arange(P + s_len, device=x.device)
    col_g = torch.where(cols < P, cols, p0 + cols - P)   # global key pos
    col_ok = torch.where(cols < P, cols < p0, torch.ones_like(cols,
                                                              dtype=bool))
    rows_g = p0 + torch.arange(s_len, device=x.device)
    mask = col_ok[None, :] & (col_g[None, :] <= rows_g[:, None])
    return _causal_block(ly, params, x, kk, vv, q, mask), k, v


# Decode telemetry under the reference's names: tokens are THE serving
# unit for a causal decoder; steps/s is the per-row tick rate.
_GEN_REQS = telemetry.counter(
    "generation_requests_total", "generate() calls")
_GEN_TOKENS = telemetry.counter(
    "generation_tokens_total", "new tokens emitted (rows x n_new)")
_GEN_RATE = telemetry.gauge(
    "generation_decode_steps_per_sec",
    "decode ticks/sec over the last generate() (per-row token rate)")
_GEN_TIME = telemetry.histogram(
    "generation_seconds",
    "wall time per generate() call incl. prefill, decode loop and the "
    "host read of the ids")

_INF = float("inf")


def _filter_logits_rows(logits, top_k, top_p):
    """Per-row top-k/top-p filter: ``top_k`` is a [b] int VECTOR (k ==
    vocab disables filtering for that row) and ``top_p`` a [b] float
    VECTOR (p >= 1 disables the cut), so requests with different settings
    ride one batch.  Filtered entries go to -inf."""
    V = logits.shape[-1]
    srt = torch.sort(logits, dim=-1).values               # ascending
    kth = srt.gather(-1, (V - top_k.long())[:, None])
    logits = torch.where(logits < kth, -_INF, logits)
    srt_d = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(srt_d, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    # drop tokens whose preceding cumulative mass already covers p (the
    # top token always survives); the p >= 1 guard keeps "off" rows
    # EXACTLY unfiltered even when the float cumsum rounds past 1
    cut = ((csum - probs) >= top_p[:, None]) & (top_p[:, None] < 1.0)
    srt_d = torch.where(cut, _INF, srt_d)
    thresh = srt_d.min(dim=-1, keepdim=True).values
    return torch.where(logits < thresh, -_INF, logits)


def _filtered_logprobs_rows(logits, temp, top_k, top_p):
    """Log-probabilities of each row's ACTUAL sampling distribution:
    temperature-scale (rows with temp <= 0 are greedy — scaled by 1 so
    the row stays finite; callers mask them out), filter with
    ``_filter_logits_rows``, then log-softmax (-inf stays on filtered-out
    tokens).  The speculative accept / residual math needs this density
    on both sides of the rejection test."""
    safe = torch.where(temp > 0.0, temp, torch.ones_like(temp))
    lg = _filter_logits_rows(logits / safe[:, None], top_k, top_p)
    return torch.log_softmax(lg, dim=-1)


def _filter_logits(logits, top_k, top_p):
    """Nucleus/top-k filtering on [b, V] logits (already
    temperature-scaled) with one k / p for every row."""
    if top_k is not None:
        kth = torch.sort(logits, dim=-1).values[:, -int(top_k)][:, None]
        logits = torch.where(logits < kth, -_INF, logits)
    if top_p is not None:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        cut = (csum - probs) >= float(top_p)
        srt = torch.where(cut, _INF, srt)
        thresh = srt.min(dim=-1, keepdim=True).values
        logits = torch.where(logits < thresh, -_INF, logits)
    return logits


_M32 = 0xFFFFFFFF


def _mix32(x):
    """32-bit integer hash on int64 tensors holding values < 2**32 (both
    multipliers are < 2**31, so no product leaves int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def _key_rows(seed, stream, pos):
    """[b] int64 (seed, stream, position) -> [b] 32-bit hash keys."""
    h = _mix32((seed & _M32) ^ ((seed >> 32) & _M32) ^ 0x243F6A88)
    h = _mix32(h ^ (stream & _M32))
    return _mix32(h ^ (pos & _M32))


def _unit(x):
    """32-bit hashes -> uniforms in (0, 1) (24 bits)."""
    return ((x >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _gumbel_rows(seed, stream, pos, V: int):
    """[b] int64 ``seed``/``stream``/``pos`` -> [b, V] Gumbel(0, 1) noise,
    a pure function of (seed, stream, position, token id): argmax(logits
    + noise) draws one categorical sample per row (Gumbel-max), and the
    draw for a position never depends on batching or scheduling."""
    tok = _mix32(torch.arange(V, device=seed.device, dtype=torch.int64)
                 + 0x3C6EF372)
    x = _mix32(_key_rows(seed, stream, pos)[:, None] ^ tok[None, :])
    return -torch.log(-torch.log(_unit(x)))


def _uniform_rows(seed, stream, pos):
    """[b] int64 ``seed``/``stream``/``pos`` -> [b] uniforms in (0, 1), a
    pure function of (seed, stream, position) like ``_gumbel_rows``."""
    return _unit(_mix32(_key_rows(seed, stream, pos) ^ 0x1B873593))


class TransformerGenerator:
    """Greedy / temperature / top-k / nucleus sampling with KV caches
    over a decoder MLN, on ``device`` (default ``"cuda"``).

    >>> gen = TransformerGenerator(net, device="cuda")
    >>> out = gen.generate(prompt_ids, n_new=64)      # [b, t0+64]
    >>> out = gen.generate(prompt_ids, n_new=64, temperature=0.8,
    ...                    top_k=40, top_p=0.95)
    """

    def __init__(self, net, compute_dtype: Optional[str] = None,
                 device="cuda"):
        layers = list(net.layers)
        if not isinstance(layers[0], EmbeddingSequenceLayer):
            raise ValueError("generator expects EmbeddingSequenceLayer "
                             f"first, got {type(layers[0]).__name__}")
        if not all(isinstance(l, TransformerEncoderBlock)
                   for l in layers[1:-1]):
            raise ValueError("generator expects a pure "
                             "TransformerEncoderBlock stack")
        for l in layers[1:-1]:
            if not l.causal:
                raise ValueError("generation requires causal=True blocks")
        ref = dataclasses.asdict(layers[1])
        if any(dataclasses.asdict(l) != ref for l in layers[2:-1]):
            # kept from the reference (its decode tick scans stacked block
            # params): one block conf serves every layer of the loop
            raise ValueError("generator requires conf-identical "
                             "TransformerEncoderBlocks (the decode "
                             "tick scans stacked block params)")
        self.net = net
        self.emb = layers[0]
        self.blocks = layers[1:-1]
        self.head = layers[-1]
        if not isinstance(self.head, OutputLayer):
            raise ValueError("generator expects an (Rnn)OutputLayer "
                             f"head, got {type(self.head).__name__}")
        self.device = resolve_device(device)
        self.compute_dtype = (canonical_dtype(compute_dtype)
                              if compute_dtype else torch.float32)

    def _params(self):
        self.net._check_init()
        pt = self.net.params_tree
        n = len(self.net.layers)
        return (pt["layer_0"],
                [pt[f"layer_{i}"] for i in range(1, n - 1)],
                pt[f"layer_{n - 1}"])

    def _serving_params(self):
        """(emb_p, [block params], head_p) on this generator's device,
        floating leaves cast ONCE to the compute dtype — the decode tick
        re-reads every parameter, and streaming f32-stored weights would
        cost 2x the bytes of the bf16 math performed.  The head runs in
        f32 on the cast values (the reference's f32 @ bf16 promotion)."""
        emb_p, blk_ps, head_p = self._params()
        cd, dev = self.compute_dtype, self.device

        def cast(p, dtype):
            return {k: (v.to(dev, dtype) if v.is_floating_point()
                        else v.to(dev)) for k, v in p.items()}

        head = {k: v.float() for k, v in cast(head_p, cd).items()}
        return cast(emb_p, cd), [cast(p, cd) for p in blk_ps], head

    def _head(self, head_p, x):
        return x.float() @ head_p["W"] + head_p["b"]

    def _step(self, emb_p, blk_ps, head_p, kc, vc, tok, pos):
        """One decode tick over stripe caches [n_layers, b, h, L, dh]
        (written in place).  Returns (logits [b, V], kc, vc)."""
        x = _embed_token(self.emb, emb_p, tok, pos).to(self.compute_dtype)
        ly = self.blocks[0]          # conf-identical (checked in init)
        for i, p in enumerate(blk_ps):
            x, _, _ = _block_decode_step(ly, p, kc[i], vc[i], x, pos)
        return self._head(head_p, x), kc, vc

    def _step_paged(self, emb_p, blk_ps, head_p, kc, vc, tok, pos, table,
                    wblk, woff):
        """Paged-pool decode tick: ``kc``/``vc`` are the global block
        pools [n_layers, n_blocks, h, block_size, dh] (written in place),
        ``table`` [b, max_blocks] the per-slot block tables, and the new
        row lands at (``wblk``, ``woff``) per slot.  Attention routes
        through ``kernels.paged_decode_attention``."""
        x = _embed_token(self.emb, emb_p, tok, pos).to(self.compute_dtype)
        ly = self.blocks[0]
        for i, p in enumerate(blk_ps):
            x, _, _ = _block_decode_step_paged(ly, p, kc[i], vc[i], x, pos,
                                               table, wblk, woff)
        return self._head(head_p, x), kc, vc

    def _verify_rows_paged(self, emb_p, blk_ps, head_p, kc, vc, toks,
                           pos0, epos, table, wblk, woff):
        """Speculative verification forward: ONE pass over a chunk of W
        tokens per slot — ``toks`` [B, W] (the anchor + the draft's
        proposals, masked rows 0), ``pos0`` [B] the chunk's base position,
        ``epos`` [B, W] the embed positions (masked rows clamped to 0 so
        the positional lookup stays in range), ``wblk``/``woff`` [B, W]
        the per-token write targets through ``table`` (masked rows at the
        scratch block 0).  Returns (logits [B, W, V], kc, vc): G_j, the
        target's logits after consuming tokens 0..j, at every chunk
        position."""
        B, W = toks.shape
        y = emb_p["W"][toks.reshape(B * W).long()]
        if self.emb.add_positional:
            y = y + emb_p["P"][epos.reshape(B * W).long()]
        if self.emb.layer_norm:
            y = _layer_norm(y, emb_p["g"], emb_p["b"], self.emb.eps)
        x = y.to(self.compute_dtype)
        ly = self.blocks[0]
        for i, p in enumerate(blk_ps):
            x, _, _ = _block_verify_step_paged(ly, p, kc[i], vc[i], x,
                                               table, wblk, woff, pos0)
        return self._head(head_p, x).reshape(B, W, -1), kc, vc

    def _prefill_rows(self, emb_p, blk_ps, head_p, prompt, t0=None):
        """Batched prompt pass over the layers.  Returns (logits [b, V],
        ks, vs [n_layers, b, h, t, dh]) — the raw per-layer K/V rows for
        the caller to place.  ``t0`` picks the logits position for prompts
        PADDED past their real length (causal masking makes position t0-1
        independent of the pad tail); default is the last column."""
        cd = self.compute_dtype
        ly = self.blocks[0]
        x = _embed_prompt(self.emb, emb_p, prompt).to(cd)
        ks, vs = [], []
        for p in blk_ps:
            x, k, v = _block_prefill(ly, p, x)
            ks.append(k.to(cd))
            vs.append(v.to(cd))
        last = x[:, -1] if t0 is None else x[:, t0 - 1]
        return self._head(head_p, last), torch.stack(ks), torch.stack(vs)

    def _prefill_rows_chunked(self, emb_p, blk_ps, head_p, suffix, pk, pv,
                              p0: int, last_ix: int):
        """Chunked-prefill counterpart of ``_prefill_rows`` for prefix-
        cache HITS: ``suffix`` [b, s] are the uncached prompt tokens at
        global positions p0..p0+s-1 (pad tail beyond the real suffix),
        ``pk``/``pv`` [n_layers, b, h, P, dh] the cached prefix K/V.
        Returns (logits [b, V] at local row ``last_ix``, ks, vs [n_layers,
        b, h, s, dh]) — the SUFFIX rows only."""
        cd = self.compute_dtype
        ly = self.blocks[0]
        y = emb_p["W"][suffix.long()]
        if self.emb.add_positional:
            # the pad tail may run past the positional table: clamp (the
            # reference's take clamps too; those rows are never read)
            pos = (p0 + torch.arange(suffix.shape[1], device=suffix.device)
                   ).clamp(max=emb_p["P"].shape[0] - 1)
            y = y + emb_p["P"][pos]
        if self.emb.layer_norm:
            y = _layer_norm(y, emb_p["g"], emb_p["b"], self.emb.eps)
        x = y.to(cd)
        ks, vs = [], []
        for i, p in enumerate(blk_ps):
            x, k, v = _block_prefill_chunked(ly, p, x, pk[i], pv[i], p0)
            ks.append(k.to(cd))
            vs.append(v.to(cd))
        return (self._head(head_p, x[:, last_ix]), torch.stack(ks),
                torch.stack(vs))

    @torch.no_grad()
    def generate(self, prompt_ids, n_new: int, temperature: float = 0.0,
                 seed: int = 0, max_len: Optional[int] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None) -> np.ndarray:
        """[b, t0] int prompt -> [b, t0 + n_new] int32.  temperature == 0
        is greedy argmax; > 0 samples logits/temperature, optionally
        filtered to the top-k tokens and/or the top-p nucleus (row ``i``
        draws from stream ``i`` of ``seed``)."""
        prompt_np = np.asarray(prompt_ids, np.int64)
        b, t0 = prompt_np.shape
        total = t0 + n_new
        L = max_len or total
        if L < total:
            raise ValueError(f"max_len {L} < prompt+new {total}")
        if self.emb.add_positional and L > self.emb.max_len:
            raise ValueError(
                f"generation length {L} exceeds the model's positional "
                f"table ({self.emb.max_len} rows); re-configure "
                "EmbeddingSequenceLayer.max_len or shorten the request")
        if (top_k is not None or top_p is not None) and temperature <= 0:
            raise ValueError("top_k/top_p need temperature > 0 "
                             "(greedy ignores the filtered tail)")
        emb_p, blk_ps, head_p = self._serving_params()
        vocab = int(head_p["W"].shape[-1])
        if top_k is not None and not 1 <= int(top_k) <= vocab:
            raise ValueError(f"top_k={top_k} out of range [1, {vocab}] "
                             "(vocab size)")
        t_start = time.perf_counter()
        with telemetry.span("generate", batch=b, prompt=t0, new=n_new):
            out = self._generate_rows(emb_p, blk_ps, head_p, prompt_np,
                                      n_new, L, temperature, seed, top_k,
                                      top_p, vocab)
        dt = time.perf_counter() - t_start
        _GEN_REQS.inc()
        _GEN_TOKENS.inc(b * n_new)
        _GEN_TIME.observe(dt)
        if dt > 0:
            _GEN_RATE.set(n_new / dt)
        return out

    def _generate_rows(self, emb_p, blk_ps, head_p, prompt_np, n_new, L,
                       temperature, seed, top_k, top_p, vocab) -> np.ndarray:
        """The body of :meth:`generate`: prefill, the decode loop and the
        host read of the ids."""
        b, t0 = prompt_np.shape
        total = t0 + n_new
        dev, cd = self.device, self.compute_dtype
        prompt = torch.as_tensor(prompt_np, device=dev)
        logits, ks, vs = self._prefill_rows(emb_p, blk_ps, head_p, prompt)
        h = self.blocks[0].n_heads
        dh = self.emb.n_out // h
        shape = (len(self.blocks), b, h, L, dh)
        kc = torch.zeros(shape, dtype=cd, device=dev)
        vc = torch.zeros(shape, dtype=cd, device=dev)
        kc[:, :, :, :t0] = ks
        vc[:, :, :, :t0] = vs
        ids = torch.zeros((b, total), dtype=torch.int64, device=dev)
        ids[:, :t0] = prompt
        seeds = torch.full((b,), int(seed), dtype=torch.int64, device=dev)
        streams = torch.arange(b, dtype=torch.int64, device=dev)
        for i in range(n_new):
            pos = t0 + i
            if temperature > 0.0:
                lg = _filter_logits(logits / temperature, top_k, top_p)
                noise = _gumbel_rows(seeds, streams,
                                     torch.full_like(seeds, pos), vocab)
                nxt = torch.argmax(lg + noise, dim=-1)
            else:
                nxt = torch.argmax(logits, dim=-1)
            ids[:, pos] = nxt
            if i + 1 < n_new:     # the last token's logits are unused
                logits, kc, vc = self._step(emb_p, blk_ps, head_p, kc, vc,
                                            nxt, pos)
        return ids.cpu().numpy().astype(np.int32)
