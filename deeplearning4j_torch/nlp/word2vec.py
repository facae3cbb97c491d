"""Word2Vec / ParagraphVectors — batched skip-gram (port of
``deeplearning4j_tpu/nlp/word2vec.py``).

Parity surface (``org.deeplearning4j.models.word2vec.Word2Vec`` builder):
``vector_size`` (layerSize), ``window_size``, ``negative``,
``min_word_frequency``, ``iterations``/``epochs``, ``learning_rate``,
``seed``; API ``fit``, ``get_word_vector``, ``words_nearest``,
``similarity``, ``vocab``.

Training: every (center, context) pair of an epoch is made on the host
(:meth:`Word2Vec._pairs`, vectorised with numpy and equal to the
reference's loop), shuffled by the same numpy generator (one gather by
a permutation: the same order as ``rng.shuffle``), moved to the
device once per epoch, and consumed by one update per batch on
``device`` (default the card): gathers of the touched rows, the
analytic negative-sampling (:func:`ns_update`) or hierarchical-softmax
(:func:`hs_update`) gradients, and ``index_add_`` scatter-adds — no
locks, no per-token launches.  The negatives are drawn apart from the
update (:func:`sample_negatives`, inverse CDF of the unigram^0.75 table
by ``searchsorted``, from an explicit ``torch.Generator``), so a test
can hand both packages the same negatives; the draws themselves differ
from ``jax.random``'s.  The updates are in place on ``syn0``/``syn1``:
that is what the reference's buffer donation bought (``analysis/
sanitize.py``'s ``donation`` mode has nothing to check here).  Losses
stay on the device until the run ends, so a step does not wait for the
host.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_torch.nlp.tokenizer import DefaultTokenizerFactory
from deeplearning4j_torch.runtime.backend import resolve_device


def build_huffman(counts: Sequence[int]):
    """Huffman tree over word counts (word2vec.c / DL4J
    ``useHierarchicSoftmax`` semantics): returns (points, codes, mask)
    arrays [n, D] — per-word inner-node path, binary code, and
    valid-depth mask, padded to the max depth D."""
    import heapq
    n = len(counts)
    if n < 2:
        raise ValueError("Huffman tree needs a vocabulary of >= 2 words")
    heap = [(int(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent: Dict[int, int] = {}
    branch: Dict[int, int] = {}
    nxt = n
    while len(heap) > 1:
        c1, a = heapq.heappop(heap)
        c2, b = heapq.heappop(heap)
        parent[a], branch[a] = nxt, 0
        parent[b], branch[b] = nxt, 1
        heapq.heappush(heap, (c1 + c2, nxt))
        nxt += 1
    root = heap[0][1]
    paths, codes = [], []
    for w in range(n):
        p, cd, node = [], [], w
        while node != root:
            cd.append(branch[node])
            node = parent[node]
            p.append(node - n)        # inner-node id in [0, n-1)
        paths.append(p[::-1])
        codes.append(cd[::-1])
    depth = max(len(p) for p in paths)
    points = np.zeros((n, depth), np.int32)
    code_a = np.zeros((n, depth), np.float32)
    mask = np.zeros((n, depth), np.float32)
    for w in range(n):
        k = len(paths[w])
        points[w, :k] = paths[w]
        code_a[w, :k] = codes[w]
        mask[w, :k] = 1.0
    return points, code_a, mask


def _shuffle_rows(a: np.ndarray, rng: np.random.Generator):
    """``rng.shuffle(a)`` (rows, in place) as one gather: a permutation of
    the row indices takes the same draws in the same order, and is ~30x
    faster than shuffling [n, 2] rows at millions of pairs."""
    a[...] = a[rng.permutation(len(a))]


def sample_negatives(cdf: Optional[torch.Tensor], n_vocab: int, neg: int,
                     b: int, gen: torch.Generator, device) -> torch.Tensor:
    """[b, neg] negative word ids: uniform when ``cdf`` is None, else the
    inverse CDF of the unigram^power table (``searchsorted``, left side,
    as ``jnp.searchsorted``) at uniform draws from ``gen``."""
    if cdf is None:
        return torch.randint(0, n_vocab, (b, neg), generator=gen,
                             device=device)
    u = torch.rand((b, neg), generator=gen, device=device)
    return torch.clamp(torch.searchsorted(cdf, u), 0, n_vocab - 1)


def _scatter(table, rows, upd):
    """table[rows] += upd (rows may repeat; the adds accumulate)."""
    table.index_add_(0, rows.reshape(-1), upd.reshape(-1, upd.shape[-1]))


def _ns_grads(v_c, u_pos, u_neg):
    """(loss, d_vc, d_upos, d_uneg) of the negative-sampling objective
    for centre vectors ``v_c`` [b, d], context rows [b, d] and negative
    rows [b, neg, d] — the reference's analytic gradients."""
    pos_score = torch.sum(v_c * u_pos, -1)
    neg_score = torch.einsum("bd,bnd->bn", v_c, u_neg)
    loss = -(torch.mean(F.logsigmoid(pos_score))
             + torch.mean(torch.sum(F.logsigmoid(-neg_score), -1)))
    g_pos = torch.sigmoid(pos_score) - 1.0                  # [b]
    g_neg = torch.sigmoid(neg_score)                        # [b, neg]
    d_vc = g_pos[:, None] * u_pos + torch.einsum("bn,bnd->bd", g_neg, u_neg)
    d_upos = g_pos[:, None] * v_c
    d_uneg = g_neg[..., None] * v_c[:, None, :]
    return loss, d_vc, d_upos, d_uneg


def ns_update(syn0, syn1, centers, contexts, negs, lr: float):
    """One negative-sampling update of ``syn0``/``syn1`` IN PLACE on a
    pair batch with the given negatives [b, neg]; returns the loss (a
    0-d tensor).  Updates are MEAN-scaled (``-lr * grad / b``), as the
    reference's: a batched scatter-add of hundreds of stale per-pair
    gradients diverges on small vocabularies otherwise."""
    b = centers.shape[0]
    v_c, u_pos, u_neg = syn0[centers], syn1[contexts], syn1[negs]
    loss, d_vc, d_upos, d_uneg = _ns_grads(v_c, u_pos, u_neg)
    _scatter(syn0, centers, -lr * d_vc / b)
    _scatter(syn1, contexts, -lr * d_upos / b)
    _scatter(syn1, negs, -lr * d_uneg / b)
    return loss


def hs_update(syn0, syn1, centers, contexts, points, codes, mask,
              lr: float):
    """One hierarchical-softmax update IN PLACE (``useHierarchicSoftmax``):
    the context word's Huffman path (``points``/``codes``/``mask`` [n,
    D] tensors of :func:`build_huffman`) replaces negative samples;
    ``syn1`` holds the n_vocab - 1 inner-node vectors.  Returns the
    loss."""
    b = centers.shape[0]
    pts, cds, msk = points[contexts], codes[contexts], mask[contexts]
    v_c = syn0[centers]                                    # [b, d]
    u = syn1[pts]                                          # [b, D, d]
    score = torch.einsum("bd,bkd->bk", v_c, u)
    sgn = 1.0 - 2.0 * cds                   # code 0 -> +1, 1 -> -1
    loss = -torch.sum(F.logsigmoid(sgn * score) * msk) / b
    # word2vec.c HS gradient: g = (sigmoid(score) - (1 - code))
    g = (torch.sigmoid(score) - (1.0 - cds)) * msk
    d_vc = torch.einsum("bk,bkd->bd", g, u)
    d_u = g[..., None] * v_c[:, None, :]
    _scatter(syn0, centers, -lr * d_vc / b)
    _scatter(syn1, pts, -lr * d_u / b)
    return loss


@dataclasses.dataclass
class Word2Vec:
    vector_size: int = 64
    window_size: int = 5
    negative: int = 5
    min_word_frequency: int = 1
    epochs: int = 1
    batch_size: int = 512
    learning_rate: float = 0.5
    min_learning_rate: float = 1e-3
    seed: int = 42
    tokenizer_factory: object = None
    # word2vec.c fidelity knobs:
    negative_table_power: float = 0.75  # unigram^0.75 sampling; 0=uniform
    use_hierarchic_softmax: bool = False  # Huffman-tree HS instead of NS
    sampling: float = 0.0               # frequent-word subsample t (0=off)
    device: object = "cuda"             # where the tables train

    def __post_init__(self):
        self.tokenizer_factory = (self.tokenizer_factory
                                  or DefaultTokenizerFactory())
        self.vocab: Dict[str, int] = {}
        self.index2word: List[str] = []
        self.counts: Counter = Counter()
        self.syn0: Optional[np.ndarray] = None  # input embeddings
        self.syn1: Optional[np.ndarray] = None  # output embeddings

    # ------------------------------------------------------------------
    def _build_vocab(self, token_lists: List[List[str]]):
        self.counts = Counter(t for toks in token_lists for t in toks)
        words = sorted(w for w, c in self.counts.items()
                       if c >= self.min_word_frequency)
        self.index2word = words
        self.vocab = {w: i for i, w in enumerate(words)}

    def _keep_prob(self) -> Optional[np.ndarray]:
        """word2vec.c frequent-word subsampling: keep word w with prob
        (sqrt(f/t) + 1) * t/f where f is the corpus frequency."""
        if not self.sampling:
            return None
        total = sum(self.counts[w] for w in self.index2word)
        f = np.asarray([self.counts[w] / total for w in self.index2word])
        keep = (np.sqrt(f / self.sampling) + 1) * self.sampling / f
        return np.minimum(keep, 1.0)

    def _pairs(self, token_lists: List[List[str]], rng: np.random.Generator
               ) -> np.ndarray:
        """All in-window (center, context) id pairs, shuffled; frequent
        words are subsampled first when ``sampling`` is set.  The
        reference's nested loop, vectorised: the same pairs in the same
        order (sentence by sentence, centre by centre, contexts left to
        right) and the same draws from ``rng`` (one ``random()`` per
        in-vocabulary token, in order).  Sentences of one length are
        windowed together and their pairs placed back in sentence
        order."""
        keep = self._keep_prob()
        ids = [np.asarray([self.vocab[t] for t in toks if t in self.vocab],
                          np.int32) for toks in token_lists]
        if keep is not None:
            flat = np.concatenate(ids) if ids else np.zeros(0, np.int32)
            kept = rng.random(len(flat)) < keep[flat]
            cuts = np.cumsum([len(a) for a in ids])[:-1]
            ids = [a[k] for a, k in zip(ids, np.split(kept, cuts))]
        w = self.window_size
        offs = np.concatenate([np.arange(-w, 0), np.arange(1, w + 1)])
        lens = np.asarray([len(a) for a in ids], np.int64)
        i = np.arange(lens.max() if len(lens) else 0)
        per_len = np.zeros(len(i) + 1, np.int64)    # pairs of a sentence
        for n in range(2, len(per_len)):
            per_len[n] = (np.minimum(n, i[:n] + w + 1)
                          - np.maximum(0, i[:n] - w) - 1).sum()
        counts = per_len[lens]
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pairs = np.zeros((int(counts.sum()), 2), np.int32)
        for n in np.unique(lens[lens >= 2]):
            rows = np.flatnonzero(lens == n)
            grp = np.stack([ids[r] for r in rows])             # [m, n]
            j = np.arange(n)[:, None] + offs[None, :]
            ok = (j >= 0) & (j < n)                            # [n, 2w]
            cen = np.broadcast_to(grp[:, :, None], grp.shape + (len(offs),))
            ctx = grp[:, np.clip(j, 0, n - 1)]
            block = np.stack([cen[:, ok], ctx[:, ok]], -1)     # [m, P, 2]
            dest = start[rows][:, None] + np.arange(per_len[n])[None, :]
            pairs[dest.ravel()] = block.reshape(-1, 2)
        if not len(pairs):
            pairs = np.zeros((0,), np.int32)
        _shuffle_rows(pairs, rng)
        return pairs

    # ------------------------------------------------------------------
    def _unigram_cdf(self, n_vocab: int) -> Optional[torch.Tensor]:
        """CDF of the unigram^power negative-sampling distribution
        (word2vec.c's table; inverse-CDF via searchsorted needs no giant
        table), f32 on the training device.  None => uniform (power ==
        0 or no counts available)."""
        if not self.negative_table_power or not self.counts:
            return None
        c = np.asarray([self.counts[w] for w in self.index2word],
                       np.float64) ** self.negative_table_power
        return torch.as_tensor((np.cumsum(c) / c.sum()).astype(np.float32),
                               device=resolve_device(self.device))

    def _make_step(self, n_vocab: int):
        """``step(syn0, syn1, centers, contexts, lr, gen) -> loss``: draw
        the negatives from ``gen``, then :func:`ns_update`."""
        neg = self.negative
        cdf = self._unigram_cdf(n_vocab)

        def step(syn0, syn1, centers, contexts, lr, gen):
            negs = sample_negatives(cdf, n_vocab, neg, centers.shape[0], gen,
                                    syn0.device)
            return ns_update(syn0, syn1, centers, contexts, negs, lr)

        return step

    def _huffman_tensors(self, device):
        counts = [self.counts[w] for w in self.index2word]
        points, codes, mask = build_huffman(counts)
        return (torch.as_tensor(points.astype(np.int64), device=device),
                torch.as_tensor(codes, device=device),
                torch.as_tensor(mask, device=device))

    def _make_hs_step(self, n_vocab: int):
        """Hierarchical-softmax step (``useHierarchicSoftmax``)."""
        tables = self._huffman_tensors(resolve_device(self.device))

        def step(syn0, syn1, centers, contexts, lr, gen):
            return hs_update(syn0, syn1, centers, contexts, *tables, lr)

        return step

    def _train_pairs(self, pairs_all: np.ndarray, n_vocab: int,
                     n_rows: int, rng: np.random.Generator):
        """The shared SGD loop (NS or HS): epochs x shuffled batches
        with linear LR decay.  ``n_rows`` sizes syn0 (== n_vocab for
        Word2Vec; + n_docs for ParagraphVectors; + buckets for FastText).
        Returns (syn0, syn1, losses) on the host."""
        dev = resolve_device(self.device)
        d = self.vector_size
        syn0 = torch.as_tensor(
            ((rng.random((n_rows, d)) - 0.5) / d).astype(np.float32),
            device=dev)
        if self.use_hierarchic_softmax:
            syn1 = torch.zeros((max(n_vocab - 1, 1), d), device=dev)
            step = self._make_hs_step(n_vocab)
        else:
            syn1 = torch.zeros((n_vocab, d), device=dev)
            step = self._make_step(n_vocab)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        losses: List[torch.Tensor] = []
        n_batches_total = max(
            1, self.epochs * ((len(pairs_all) + self.batch_size - 1)
                              // self.batch_size))
        t = 0
        for _ in range(self.epochs):
            _shuffle_rows(pairs_all, rng)
            pairs = torch.as_tensor(pairs_all.astype(np.int64), device=dev)
            for k in range(0, len(pairs_all), self.batch_size):
                batch = pairs[k:k + self.batch_size]
                if len(batch) < 2:
                    continue
                # linear LR decay, as upstream (f32, as the reference's)
                lr = float(np.float32(max(
                    self.min_learning_rate,
                    self.learning_rate * (1 - t / n_batches_total))))
                losses.append(step(syn0, syn1, batch[:, 0], batch[:, 1], lr,
                                   gen))
                t += 1
        out = torch.stack(losses).tolist() if losses else []
        return syn0.cpu().numpy(), syn1.cpu().numpy(), out

    def fit(self, sentences: Sequence[str]) -> List[float]:
        token_lists = [self.tokenizer_factory.tokenize(s)
                       for s in sentences]
        self._build_vocab(token_lists)
        n_vocab = len(self.vocab)
        if n_vocab == 0:
            raise ValueError("Empty vocabulary (check min_word_frequency)")
        rng = np.random.default_rng(self.seed)
        pairs_all = self._pairs(token_lists, rng)
        self.syn0, self.syn1, losses = self._train_pairs(
            pairs_all, n_vocab, n_vocab, rng)
        return losses

    # ------------------------------------------------------------------
    def has_word(self, w: str) -> bool:
        return w in self.vocab

    def get_word_vector(self, w: str) -> np.ndarray:
        return self.syn0[self.vocab[w]]

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)
                                + 1e-12))

    def words_nearest(self, w: str, n: int = 10) -> List[str]:
        v = self.get_word_vector(w)
        norms = np.linalg.norm(self.syn0, axis=1) + 1e-12
        sims = self.syn0 @ v / (norms * (np.linalg.norm(v) + 1e-12))
        order = np.argsort(-sims)
        out = [self.index2word[i] for i in order
               if self.index2word[i] != w]
        return out[:n]


@dataclasses.dataclass
class ParagraphVectors(Word2Vec):
    """PV-DBOW (``ParagraphVectors`` with dm=0): a learned vector per
    document predicts the document's words with the same NS loss; word
    vectors co-train as in Word2Vec."""

    def __post_init__(self):
        super().__post_init__()
        self.doc_vectors: Optional[np.ndarray] = None

    def fit(self, documents: Sequence[str]) -> List[float]:
        token_lists = [self.tokenizer_factory.tokenize(s)
                       for s in documents]
        self._build_vocab(token_lists)
        n_vocab, n_docs = len(self.vocab), len(documents)
        rng = np.random.default_rng(self.seed)
        # Doc ids live in the same embedding table after the words, so
        # (doc_id + n_vocab, word) pairs reuse the word2vec step; the
        # word-window pairs are ALSO included so word vectors co-train
        # (DL4J trainWordVectors=true default).
        doc_pairs = [(n_vocab + di, self.vocab[t])
                     for di, toks in enumerate(token_lists)
                     for t in toks if t in self.vocab]
        word_pairs = self._pairs(token_lists, rng)
        pairs_all = np.concatenate(
            [word_pairs.reshape(-1, 2),
             np.asarray(doc_pairs, np.int32).reshape(-1, 2)])
        full, self.syn1, losses = self._train_pairs(
            pairs_all, n_vocab, n_vocab + n_docs, rng)
        self.syn0 = full[:n_vocab]
        self.doc_vectors = full[n_vocab:]
        return losses

    def get_doc_vector(self, i: int) -> np.ndarray:
        return self.doc_vectors[i]
