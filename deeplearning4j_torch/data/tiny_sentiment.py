"""Tiny hand-written sentiment corpus — the egress-free stand-in for
SST-2 in BASELINE config 4's fine-tune quality proof (VERDICT r4 item
3: "no run anywhere shows held-out accuracy improving on a real
labeled text task").

318 hand-authored English review sentences (159 positive / 159
negative, ``corpora/tiny_sentiment.tsv``) spanning film, food,
product, travel and service registers.  Train and held-out sentences
are DISJOINT but share a sentiment lexicon, so a model that learns the
lexical task (rather than memorizing training rows) generalizes —
exactly the property the quality artifact needs to demonstrate.

Parity role: the data side of the reference's BERT fine-tune examples
(``deeplearning4j-examples`` BertIterator + SST-2 style CSVs
[UNVERIFIED]); the corpus itself replaces the undownloadable dataset.

Port of ``deeplearning4j_tpu/data/tiny_sentiment.py``: the same code, with
its own byte-for-byte copy of the corpus, so both packages give the same
splits and vocabulary ids.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

from deeplearning4j_torch.nlp.wordpiece import (BertWordPieceTokenizerFactory,
                                              _basic_tokens)

_TSV = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "corpora", "tiny_sentiment.tsv")

SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def load_tiny_sentiment() -> List[Tuple[str, int]]:
    """All (sentence, label) pairs in file order (balanced 159/159)."""
    out = []
    with open(_TSV, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            label, text = line.split("\t", 1)
            out.append((text, int(label)))
    return out


def train_test_split(k: int = 4) -> Tuple[List[Tuple[str, int]],
                                          List[Tuple[str, int]]]:
    """Deterministic PAIR-AWARE split (k=4 -> 238 train / 80 test,
    label-balanced).

    The corpus is written as parallel pairs: positive sentence i and
    negative sentence 159+i share their scaffolding ("the film was
    ...delight" / "the film was ...slog").  Both members of a pair must
    land on the same side of the split: with a naive interleaved split
    a scaffold word ("film") appears in TRAIN with exactly one label —
    a perfectly predictive memorization feature — while its held-out
    twin carries the OPPOSITE label, so a scaffold-keying model scores
    systematically BELOW chance (observed: 0.35-0.39 held-out with
    train loss -> 0).  Splitting by pair puts each scaffold in train
    with both labels (useless for memorization) or only in test
    (unseen), leaving the corpus-wide sentiment lexicon as the only
    signal that generalizes — which is exactly the property the
    config-4 quality artifact must demonstrate."""
    data = load_tiny_sentiment()
    half = len(data) // 2
    pos, neg = data[:half], data[half:]
    train: List[Tuple[str, int]] = []
    test: List[Tuple[str, int]] = []
    for i in range(half):
        dst = test if i % k == 0 else train
        dst.append(pos[i])
        dst.append(neg[i])
    return train, test


def build_vocab() -> Dict[str, int]:
    """WordPiece vocab covering the corpus: specials + every basic
    token (the corpus is lowercase English, so whole words suffice —
    encode() never falls back to [UNK])."""
    vocab: Dict[str, int] = {s: i for i, s in enumerate(SPECIALS)}
    for text, _ in load_tiny_sentiment():
        for tok in _basic_tokens(text, lower=True, strip_accents=True):
            if tok not in vocab:
                vocab[tok] = len(vocab)
    return vocab


def make_tokenizer() -> BertWordPieceTokenizerFactory:
    return BertWordPieceTokenizerFactory(build_vocab())
