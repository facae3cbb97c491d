"""Speculative multi-token decode — draft construction + acceptance (port
of ``deeplearning4j_tpu/parallel/speculative.py``).

A speculative round of ``GenerationServer(speculative=...)``:

1. **anchor** — the slot's next token from its held target logits
   (argmax for greedy slots; a draw from the filtered distribution, or
   from a held rejection residual, for sampled ones);
2. **draft** — starting from the anchor, the draft model runs W = K+1
   single-token steps through ITS OWN paged KV (the slot's ``dtable``
   blocks, ordinary pool blocks holding the draft's first
   ``draft.n_layers`` layers), proposing p_1..p_K.  The last step's
   proposal is discarded; its K/V write keeps the draft context whole;
3. **verify** — ONE W-token target pass over [anchor, p_1..p_K] at
   positions pos..pos+K (``TransformerGenerator._verify_rows_paged``),
   giving target logits G_0..G_K;
4. **accept** — :func:`accept_greedy` for greedy slots (p_i commits iff
   it equals the target's argmax after p_{i-1} and every earlier
   proposal matched), :func:`accept_sampled` for sampled ones (rejection
   sampling with the residual ``max(0, p - q)`` held for the next
   anchor).  Both cut at a committed EOS and clamp to the budget.
   Rejected rows roll back by ``pos`` not advancing over them.

Every committed greedy token is the target's argmax over the committed
prefix, so speculative greedy decode gives non-speculative greedy's
tokens at every acceptance pattern; the draft decides only how many
tokens a round commits.  The default draft is a SELF-DRAFT, the target's
first ``draft_layers`` blocks with its own embedding and head
(:func:`make_self_draft`); ``draft_net=`` brings an independent draft
whose geometry fits the pool (:func:`make_draft`).

Everything here is plain tensor math or host Python; the device work of
a round is in ``GenerationServer._spec_rounds``.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import torch

from deeplearning4j_torch.models.generation import TransformerGenerator


class DraftModel:
    """The draft side of a speculative server: ``gen`` supplies the layer
    math, ``n_layers`` is the draft depth — the slice of the pool's layer
    axis its KV occupies — and :meth:`params` derives the draft's (emb,
    [block params], head) from the server's serving params."""

    def __init__(self, gen: TransformerGenerator, n_layers: int,
                 params_fn):
        self.gen = gen
        self.n_layers = int(n_layers)
        self._params_fn = params_fn

    def params(self, target_params):
        """(emb_p, [block params] of the draft's layers, head_p), from the
        target's CURRENT serving params — called from
        ``GenerationServer.refresh_params``, so a weight refresh refreshes
        the draft too."""
        return self._params_fn(target_params)

    def check_tp(self, tp: int) -> None:
        """The draft's K/V share the target's head-sharded pool leaves:
        its head count must split over ``tp`` the same way."""
        h = self.gen.blocks[0].n_heads
        if h % int(tp):
            raise ValueError(
                f"draft n_heads={h} must divide by tp={tp} (its K/V rows "
                "land in the head-sharded pool)")


def make_self_draft(gen: TransformerGenerator,
                    draft_layers: Optional[int] = None) -> DraftModel:
    """Truncated-target self-draft: the first ``draft_layers`` blocks of
    the target (default: half the stack, min 1) with the target's own
    embedding and head.  Its params are the target's tensors themselves
    (a list slice), so it costs no device memory."""
    n = len(gen.blocks)
    d = max(1, n // 2) if draft_layers is None else int(draft_layers)
    if not 1 <= d <= n:
        raise ValueError(
            f"draft_layers={d} out of range [1, {n}] (the self-draft "
            "truncates the target's own stack)")

    def params_fn(target_params):
        emb_p, blk_ps, head_p = target_params
        return emb_p, blk_ps[:d], head_p

    return DraftModel(gen, d, params_fn)


def make_draft(gen: TransformerGenerator, draft_net) -> DraftModel:
    """External draft model (an independently trained small decoder), on
    the target's device and compute dtype.  Geometry must fit the
    target's pool: same vocab (proposals index target logits), same head
    count and d_model (draft K/V rows land in the same pool), and depth
    <= the target's (the draft occupies the first ``n_layers`` pool
    layers)."""
    dgen = TransformerGenerator(draft_net, compute_dtype=gen.compute_dtype,
                                device=gen.device)
    d = len(dgen.blocks)
    if d > len(gen.blocks):
        raise ValueError(
            f"draft depth {d} exceeds the target's {len(gen.blocks)} "
            "(draft KV lives in the first layers of the target's pool)")
    if dgen.blocks[0].n_heads != gen.blocks[0].n_heads:
        raise ValueError(
            f"draft n_heads {dgen.blocks[0].n_heads} != target "
            f"{gen.blocks[0].n_heads} (pool K/V layout is per-head)")
    if dgen.emb.n_out != gen.emb.n_out:
        raise ValueError(
            f"draft d_model {dgen.emb.n_out} != target {gen.emb.n_out} "
            "(pool K/V rows are [h, dh])")
    v_t = int(gen._params()[2]["W"].shape[-1])
    v_d = int(dgen._params()[2]["W"].shape[-1])
    if v_d != v_t:
        raise ValueError(f"draft vocab {v_d} != target vocab {v_t} "
                         "(proposals must index target logits)")

    def params_fn(_target_params):
        return dgen._serving_params()

    return DraftModel(dgen, d, params_fn)


class SpecConfig:
    """Parsed ``GenerationServer(speculative={...})`` config: ``k`` draft
    proposals per round (the verification width is k+1), ``rounds`` — the
    most rounds fused into one dispatch (the ``tick_batch`` analogue;
    adaptive, pow2-quantized), the :class:`DraftModel`, and the adaptive
    knobs: ``adaptive=True`` lets the :class:`AcceptanceController` pick
    each slot's draft depth within ``[1, k_max]`` (``k_max`` defaults to
    ``k``; ``k`` stays the fixed depth when adaptive is off)."""

    def __init__(self, k: int, rounds: int, draft: DraftModel,
                 adaptive: bool = False, k_max: Optional[int] = None):
        self.k = int(k)
        self.rounds = int(rounds)
        self.draft = draft
        self.adaptive = bool(adaptive)
        self.k_max = self.k if k_max is None else int(k_max)
        if self.k < 1:
            raise ValueError("speculative k must be >= 1")
        if self.rounds < 1:
            raise ValueError("speculative rounds must be >= 1")
        if self.k_max < self.k:
            raise ValueError(
                f"speculative k_max={self.k_max} must be >= k={self.k} "
                "(k is the fixed/startup depth; the controller adapts "
                "within [1, k_max])")

    @classmethod
    def build(cls, gen: TransformerGenerator,
              spec: dict) -> "SpecConfig":
        spec = dict(spec)
        unknown = set(spec) - {"k", "rounds", "draft_layers",
                               "draft_net", "adaptive", "k_max"}
        if unknown:
            raise ValueError(
                f"unknown speculative key(s) {sorted(unknown)} "
                "(expected k / rounds / draft_layers / draft_net / "
                "adaptive / k_max)")
        draft_net = spec.get("draft_net")
        if draft_net is not None:
            if spec.get("draft_layers") is not None:
                raise ValueError("draft_layers applies to the "
                                 "self-draft; draft_net brings its "
                                 "own depth")
            draft = make_draft(gen, draft_net)
        else:
            draft = make_self_draft(gen, spec.get("draft_layers"))
        return cls(spec.get("k", 4), spec.get("rounds", 2), draft,
                   adaptive=spec.get("adaptive", False),
                   k_max=spec.get("k_max"))


def _eos_cut(v, c, remaining, eos):
    """Cut each row's commit count ``c`` at its first committed EOS.
    Returns (c, any_hit, remaining_after)."""
    W = v.shape[1]
    idx = torch.arange(W, device=v.device)[None, :]
    hit = ((v == eos[:, None]) & (eos[:, None] >= 0)
           & (idx < c[:, None]))
    any_hit = hit.any(dim=1)
    first = torch.argmax(hit.to(torch.int32), dim=1)  # first True
    c = torch.where(any_hit, first + 1, c)
    rem_after = torch.where(any_hit, torch.zeros_like(remaining),
                            remaining - c)
    return c, any_hit, rem_after


def n_evaluable(remaining, K: int, kcap=None):
    """[B] proposals of a K-deep chunk that could commit: at most
    remaining - 1 beyond the anchor, and none past a slot's ``kcap``."""
    n = torch.clamp(torch.clamp(remaining - 1, max=K), 0, K)
    if kcap is not None:
        n = torch.minimum(n, torch.clamp(kcap.to(n.dtype), 0, K))
    return n


def accept_greedy(v, g, active, remaining, eos, kcap=None):
    """The greedy acceptance rule on one verified chunk.

    ``v`` [B, W] — the verified tokens (anchor + K proposals); ``g``
    [B, W] — the target's own argmax after each of them; ``active`` [B]
    bool; ``remaining`` [B] int32 budgets; ``eos`` [B] int32 (-1
    disables); ``kcap`` [B] int32 (optional) — a per-slot draft-depth
    cap: proposals at index >= kcap[b] were never drafted for slot b and
    can never commit.

    Returns ``(commit, remaining_after)``: the anchor always commits,
    proposal p_i commits iff it matches g_{i-1} and every earlier
    proposal matched, the count is clamped to the remaining budget, and a
    committed EOS cuts the run (``remaining_after`` drops to 0)."""
    W = v.shape[1]
    match = (v[:, 1:] == g[:, :-1]).to(torch.int64)          # [B, K]
    if kcap is not None:
        keep = (torch.arange(W - 1, device=v.device)[None, :]
                < kcap[:, None])
        match = torch.where(keep, match, torch.zeros_like(match))
    a = torch.cumprod(match, dim=1).sum(dim=1)               # leading 1s
    c = torch.minimum(1 + a, remaining.to(torch.int64))
    c, _, rem_after = _eos_cut(v, c, remaining.to(torch.int64), eos)
    c = torch.where(active, c, torch.zeros_like(c))
    rem_after = torch.where(active, rem_after, remaining.to(torch.int64))
    return c.to(torch.int32), rem_after.to(torch.int32)


def accept_sampled(v, logp, logq, u, active, remaining, eos,
                   kcap=None):
    """Rejection-sampling acceptance (Leviathan et al. / Chen et al.) on
    one verified chunk — the sampled-slot analogue of
    :func:`accept_greedy`, preserving the target's sampling distribution.

    ``logp`` / ``logq`` [B, K] — log-probability of proposal p_{i+1}
    under the TARGET's and the DRAFT's filtered distributions at its
    position; ``u`` [B, K] — the slot's uniforms; the rest as in
    :func:`accept_greedy`.  Proposal i is accepted iff ``u_i <
    exp(min(0, logp_i - logq_i))`` and every earlier proposal was.

    Returns ``(commit, remaining_after, n_eval, rejected)``: ``n_eval``
    counts the proposals actually evaluated per slot (capped by kcap and
    the budget), ``rejected`` marks slots whose run ended at a genuine
    rejection — their NEXT token must come from the residual
    (:func:`residual_logits`)."""
    B, W = v.shape
    K = W - 1
    rem = remaining.to(torch.int64)
    n_eval = n_evaluable(rem, K, kcap)
    idx = torch.arange(K, device=v.device)[None, :]
    ok = u < torch.exp(torch.clamp(logp - logq, max=0.0))
    ok = ok & (idx < n_eval[:, None])
    a = torch.cumprod(ok.to(torch.int64), dim=1).sum(dim=1)
    rejected = a < n_eval
    c = torch.minimum(1 + a, rem)
    c, any_hit, rem_after = _eos_cut(v, c, rem, eos)
    rejected = rejected & ~any_hit & (rem_after > 0) & active
    c = torch.where(active, c, torch.zeros_like(c))
    rem_after = torch.where(active, rem_after, rem)
    n_eval = torch.where(active, n_eval, torch.zeros_like(n_eval))
    return (c.to(torch.int32), rem_after.to(torch.int32),
            n_eval.to(torch.int32), rejected)


def accept_mixed(greedy_row, v, g, logp, logq, u, active, remaining,
                 eos, kcap=None):
    """Per-row choice between the two rules for a MIXED pool: rows where
    ``greedy_row`` [B] is True commit by :func:`accept_greedy` (so they
    give non-speculative greedy's tokens whatever the sampled rows do),
    the others by :func:`accept_sampled`.  Returns ``(commit,
    remaining_after, n_eval, rejected)``; ``rejected`` is always False on
    greedy rows (a greedy mismatch is corrected by the next argmax)."""
    cg, rg = accept_greedy(v, g, active, remaining, eos, kcap=kcap)
    cs, rs, n_eval, rej = accept_sampled(
        v, logp, logq, u, active, remaining, eos, kcap=kcap)
    c = torch.where(greedy_row, cg, cs)
    rem_after = torch.where(greedy_row, rg, rs)
    return c, rem_after, n_eval, rej & ~greedy_row


def residual_logits(logp_t, logq_d):
    """Log of the normalized rejection residual ``max(0, p_target -
    p_draft)`` from the two FILTERED log-distributions [..., V], as
    UNNORMALIZED log-weights (-inf where the residual is zero).  Where
    p_target <= p_draft everywhere (only when the two coincide) it falls
    back to the target distribution."""
    diff = torch.exp(logp_t) - torch.exp(logq_d)
    pos = diff > 0.0
    res = torch.where(pos, torch.log(torch.where(pos, diff,
                                                 torch.ones_like(diff))),
                      torch.full_like(diff, -float("inf")))
    return torch.where(pos.any(dim=-1, keepdim=True), res, logp_t)


class AcceptanceController:
    """Self-tuning draft depth from observed acceptance.

    Keeps a per-key EWMA of the per-proposal acceptance probability
    ``alpha`` (key = tenant + leading prefix block in the server) plus a
    global aggregate, and picks the draft depth k in ``[1, k_max]``
    maximizing the expected speedup of a round,

        E(tokens | k) / cost(k)  with  E = (1 - a^(k+1)) / (1 - a),
        cost = k * draft_cost + 1

    (draft_cost = a draft step's cost as a fraction of a target step,
    e.g. ``draft_layers / n_layers`` for a self-draft; the +1 is the
    verify pass).  Cold keys fall back to the global EWMA; a cold GLOBAL
    seeds itself from a history store when one is attached — any object
    with ``.rate(series, t0, t1)`` over the
    ``generation_server_spec_{proposed,accepted}_total`` counters — and
    otherwise starts at ``k_max``.  Purely host-side: observations come
    from the dispatch's host sync, decisions feed the next dispatch."""

    SERIES_PROPOSED = "generation_server_spec_proposed_total"
    SERIES_ACCEPTED = "generation_server_spec_accepted_total"

    def __init__(self, k_max: int, draft_cost: float,
                 ewma: float = 0.2, min_obs: int = 32,
                 store=None, window_s: float = 120.0):
        if not 1 <= int(k_max):
            raise ValueError("k_max must be >= 1")
        self.k_max = int(k_max)
        self.draft_cost = max(1e-3, float(draft_cost))
        self.ewma = float(ewma)
        self.min_obs = int(min_obs)
        self.window_s = float(window_s)
        self._store = store
        self._keys = {}          # key -> [alpha, n_proposed]
        self._global = None      # alpha
        self._global_n = 0
        self._lock = threading.Lock()

    def attach_store(self, store) -> None:
        with self._lock:
            self._store = store

    def reset(self) -> None:
        """Drop all acceptance state, returning every key to the
        optimistic cold start."""
        with self._lock:
            self._keys.clear()
            self._global = None
            self._global_n = 0

    def observe(self, key, proposed: int, accepted: int) -> None:
        """Fold one slot-round observation in.  ``proposed`` counts only
        evaluated proposals, so budget/EOS truncation never reads as
        rejection."""
        proposed = int(proposed)
        if proposed <= 0:
            return
        r = min(1.0, max(0.0, int(accepted) / proposed))
        with self._lock:
            ent = self._keys.get(key)
            if ent is None:
                self._keys[key] = [r, proposed]
            else:
                ent[0] += self.ewma * (r - ent[0])
                ent[1] += proposed
            if self._global is None:
                self._global = r
            else:
                self._global += self.ewma * (r - self._global)
            self._global_n += proposed

    def rate(self, key) -> Optional[float]:
        """Best current acceptance estimate for ``key`` (per-key when
        warm, else global, else store-seeded, else None)."""
        with self._lock:
            ent = self._keys.get(key)
            if ent is not None and ent[1] >= self.min_obs:
                return ent[0]
            if self._global_n >= self.min_obs:
                return self._global
            store = self._store
        seeded = self._store_rate(store)
        if seeded is not None:
            return seeded
        with self._lock:
            if ent is not None:
                return ent[0]
            return self._global

    def k_for(self, key, cap: Optional[int] = None) -> int:
        """Draft depth for the next round touching ``key``, within
        ``[1, min(k_max, cap)]``."""
        hi = self.k_max if cap is None else max(1, min(self.k_max,
                                                       int(cap)))
        a = self.rate(key)
        if a is None:
            return hi
        return self._best_k(a, hi)

    def _best_k(self, alpha: float, hi: int) -> int:
        a = min(0.98, max(0.0, float(alpha)))
        best_k, best_s = 1, -1.0
        for k in range(1, hi + 1):
            e = (1.0 - a ** (k + 1)) / (1.0 - a)
            s = e / (k * self.draft_cost + 1.0)
            if s > best_s + 1e-12:
                best_k, best_s = k, s
        return best_k

    def _store_rate(self, store) -> Optional[float]:
        if store is None:
            return None
        try:
            now = time.time()
            rp = store.rate(self.SERIES_PROPOSED,
                            now - self.window_s, now)
            ra = store.rate(self.SERIES_ACCEPTED,
                            now - self.window_s, now)
        except Exception:
            return None
        if not rp or ra is None:
            return None
        return min(1.0, max(0.0, ra / rp))

    def snapshot(self) -> dict:
        """Controller introspection for ``stats()`` / debugging."""
        with self._lock:
            return {
                "keys": len(self._keys),
                "global_rate": self._global,
                "global_proposed": self._global_n,
            }
