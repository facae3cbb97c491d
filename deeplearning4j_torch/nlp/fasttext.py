"""FastText — subword-enriched skip-gram embeddings (port of
``deeplearning4j_tpu/nlp/fasttext.py``).

Parity surface: ``org.deeplearning4j.models.fasttext.FastText``
[UNVERIFIED] (wrapping facebookresearch/fastText semantics): each word
vector is the MEAN of its word row and its character n-gram (3..6,
word wrapped in ``< >``) bucket rows, FNV-1a-hashed into ``bucket``
slots; OOV words get vectors from their n-grams alone — the FastText
hallmark.

Training: the per-word subword id lists are precomputed host side into
one padded [n_vocab, S] table on the training device; the
negative-sampling update (:func:`subword_ns_update`) gathers and
mean-combines rows in one batched computation and scatter-adds the
distributed gradients in place with ``index_add_`` — Word2Vec's loop
(``Word2Vec._train_pairs``), no per-token host loop.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_torch.nlp.word2vec import (Word2Vec, _ns_grads, _scatter,
                                               sample_negatives)
from deeplearning4j_torch.runtime.backend import resolve_device

def fnv1a(s: str) -> int:
    """FNV-1a 32-bit (the hash fastText uses for n-gram buckets)."""
    h = 2166136261
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


def word_ngrams(word: str, min_n: int = 3, max_n: int = 6) -> List[str]:
    w = f"<{word}>"
    out = []
    for n in range(min_n, max_n + 1):
        for i in range(len(w) - n + 1):
            g = w[i:i + n]
            if g != w:           # the full token is the word row itself
                out.append(g)
    return out


def subword_ns_update(syn0, syn1, centers, contexts, negs, sub_t, sub_m,
                      lr: float):
    """One negative-sampling update IN PLACE where a centre word's vector
    is the mean of its word row and its n-gram rows (``sub_t`` [n_vocab,
    S] bucket-row ids, ``sub_m`` their mask); the centre gradient is
    spread over those rows.  Returns the loss."""
    b = centers.shape[0]
    subs = sub_t[centers]                # [b, S]
    smask = sub_m[centers]               # [b, S]
    counts = 1.0 + smask.sum(-1)         # word row + n-grams
    v_c = (syn0[centers] + torch.einsum("bsd,bs->bd", syn0[subs], smask)
           ) / counts[:, None]
    loss, d_vc, d_upos, d_uneg = _ns_grads(v_c, syn1[contexts], syn1[negs])
    # distribute the center gradient over word + subword rows
    d_rows = d_vc / counts[:, None]
    _scatter(syn0, centers, -lr * d_rows / b)
    d_sub = d_rows[:, None, :] * smask[..., None]  # [b, S, d]
    _scatter(syn0, subs, -lr * d_sub / b)
    _scatter(syn1, contexts, -lr * d_upos / b)
    _scatter(syn1, negs, -lr * d_uneg / b)
    return loss


@dataclasses.dataclass
class FastText(Word2Vec):
    bucket: int = 50000            # n-gram hash buckets (fastText: 2M)
    min_n: int = 3
    max_n: int = 6

    def __post_init__(self):
        super().__post_init__()
        self.subword_table: Optional[np.ndarray] = None  # [n_vocab, S]
        self.subword_mask: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def _ngram_ids(self, word: str) -> List[int]:
        return [fnv1a(g) % self.bucket
                for g in word_ngrams(word, self.min_n, self.max_n)]

    def _build_subword_table(self):
        """Padded per-word subword bucket ids (offset by n_vocab — the
        bucket rows live after the word rows in syn0)."""
        n_vocab = len(self.vocab)
        lists = [self._ngram_ids(w) for w in self.index2word]
        s_max = max(1, max(len(l) for l in lists))
        table = np.zeros((n_vocab, s_max), np.int32)
        mask = np.zeros((n_vocab, s_max), np.float32)
        for i, l in enumerate(lists):
            table[i, :len(l)] = [n_vocab + g for g in l]
            mask[i, :len(l)] = 1.0
        self.subword_table, self.subword_mask = table, mask

    # ------------------------------------------------------------------
    def _make_step(self, n_vocab: int):
        neg = self.negative
        cdf = self._unigram_cdf(n_vocab)
        dev = resolve_device(self.device)
        sub_t = torch.as_tensor(self.subword_table.astype(np.int64),
                                device=dev)
        sub_m = torch.as_tensor(self.subword_mask, device=dev)

        def step(syn0, syn1, centers, contexts, lr, gen):
            negs = sample_negatives(cdf, n_vocab, neg, centers.shape[0], gen,
                                    syn0.device)
            return subword_ns_update(syn0, syn1, centers, contexts, negs,
                                     sub_t, sub_m, lr)

        return step

    # ------------------------------------------------------------------
    def fit(self, sentences: Sequence[str]) -> List[float]:
        token_lists = [self.tokenizer_factory.tokenize(s)
                       for s in sentences]
        self._build_vocab(token_lists)
        n_vocab = len(self.vocab)
        if n_vocab == 0:
            raise ValueError("Empty vocabulary (check min_word_frequency)")
        if self.use_hierarchic_softmax:
            raise NotImplementedError(
                "FastText here trains with negative sampling "
                "(fastText's own default); use Word2Vec for HS")
        self._build_subword_table()
        rng = np.random.default_rng(self.seed)
        pairs_all = self._pairs(token_lists, rng)
        self.syn0, self.syn1, losses = self._train_pairs(
            pairs_all, n_vocab, n_vocab + self.bucket, rng)
        return losses

    # ------------------------------------------------------------------
    def get_word_vector(self, w: str) -> np.ndarray:
        """In-vocab: mean of word row + n-gram rows.  OOV: mean of the
        n-gram rows alone (never raises — the FastText contract)."""
        n_vocab = len(self.vocab)
        grams = [n_vocab + g for g in self._ngram_ids(w)]
        if w in self.vocab:
            rows = [self.syn0[self.vocab[w]]] + [self.syn0[g]
                                                 for g in grams]
        elif grams:
            rows = [self.syn0[g] for g in grams]
        else:
            return np.zeros(self.vector_size, np.float32)
        return np.mean(rows, axis=0)

    def has_word(self, w: str) -> bool:   # OOV still has a vector
        return True

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)
                                + 1e-12))

    def words_nearest(self, w: str, n: int = 10) -> List[str]:
        # full subword-composed vectors, NOT raw syn0 rows (those
        # include the n-gram bucket rows past the vocabulary)
        v = self.get_word_vector(w)
        mat = np.stack([self.get_word_vector(x) for x in self.index2word])
        norms = np.linalg.norm(mat, axis=1) + 1e-12
        sims = mat @ v / (norms * (np.linalg.norm(v) + 1e-12))
        order = np.argsort(-sims)
        return [self.index2word[i] for i in order
                if self.index2word[i] != w][:n]
