"""BertIterator (``org.deeplearning4j.iterator.BertIterator``
[UNVERIFIED]) — sentence (pairs) -> (ids, mask, segment[, labels])
MultiDataSets through the WordPiece tokenizer, for both supervised
sequence classification and unsupervised MLM pretraining.

Feed order matches the imported frozen-BERT placeholders
(``i``/``m``/``t``), so
``BertIterator -> import_frozen_pb(...).fit(...)`` is the full
BASELINE-config-4 pipeline end to end.

Port of ``deeplearning4j_tpu/data/bert_iterator.py``: the same code (and
``set_epoch``, which resumed MLM training needs), numpy and
the standard library only (the port keeps its own copy).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_torch.data.dataset import MultiDataSet
from deeplearning4j_torch.nlp.wordpiece import BertWordPieceTokenizerFactory


class BertIterator:
    """Tasks: ``"seq_classification"`` (labels are int classes) and
    ``"unsupervised"`` (BERT MLM: 15% of positions selected; of those
    80% -> [MASK], 10% -> random id, 10% unchanged; label mapping is
    (masked_target_ids, selection_mask))."""

    def __init__(self, tokenizer: BertWordPieceTokenizerFactory,
                 sentences: Sequence, batch_size: int, max_len: int,
                 task: str = "seq_classification",
                 mask_prob: float = 0.15, seed: int = 0):
        if task not in ("seq_classification", "unsupervised"):
            raise ValueError(f"unknown task {task!r}")
        self.tok = tokenizer
        self.sentences = list(sentences)
        self.batch = int(batch_size)
        self.max_len = int(max_len)
        self.task = task
        self.mask_prob = float(mask_prob)
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._mask_id = tokenizer.vocab.get("[MASK]")
        if task == "unsupervised" and self._mask_id is None:
            raise ValueError("MLM task needs [MASK] in the vocab")

    def _encode_batch(self, texts: List) -> Tuple[np.ndarray, ...]:
        ids, mask, tt = [], [], []
        for t in texts:
            pair = None
            if isinstance(t, (tuple, list)):
                t, pair = t[0], t[1]
            i, m, s = self.tok.encode(t, pair=pair, max_len=self.max_len)
            ids.append(i)
            mask.append(m)
            tt.append(s)
        return (np.asarray(ids, np.int32), np.asarray(mask, np.int32),
                np.asarray(tt, np.int32))

    def __iter__(self):
        for lo in range(0, len(self.sentences), self.batch):
            chunk = self.sentences[lo:lo + self.batch]
            if self.task == "seq_classification":
                texts = [c[0] for c in chunk]
                labels = np.asarray([c[1] for c in chunk], np.int32)
                ids, mask, tt = self._encode_batch(texts)
                yield MultiDataSet([ids, mask, tt], [labels])
            else:
                ids, mask, tt = self._encode_batch(list(chunk))
                tgt = ids.copy()
                special = np.isin(
                    ids, [self.tok.vocab["[CLS]"],
                          self.tok.vocab["[SEP]"],
                          self.tok.vocab["[PAD]"]])
                candidates = (mask == 1) & ~special
                sel = (self._rng.random(ids.shape) < self.mask_prob) \
                    & candidates
                # canonical BERT data gen guarantees >=1 prediction per
                # example: a zero-selection row would NaN any consumer
                # normalizing by sum(sel)
                for r in np.nonzero(~sel.any(axis=1)
                                    & candidates.any(axis=1))[0]:
                    sel[r, self._rng.choice(
                        np.nonzero(candidates[r])[0])] = True
                r = self._rng.random(ids.shape)
                ids = np.where(sel & (r < 0.8), self._mask_id, ids)
                rand_ids = self._rng.integers(
                    0, len(self.tok.vocab), ids.shape).astype(np.int32)
                ids = np.where(sel & (r >= 0.8) & (r < 0.9), rand_ids,
                               ids)
                yield MultiDataSet([ids, mask, tt],
                                   [tgt, sel.astype(np.int32)])

    def reset(self):
        pass

    def set_epoch(self, epoch: int):
        """Draw what the ``epoch``-th pass (from 0) of an uninterrupted
        iterator draws: re-seed, then replay the masks of the passes
        before it (``fit(resume=True)`` calls this on a fresh iterator;
        the MLM masks come from one rolling RNG)."""
        self._rng = np.random.default_rng(self.seed)
        if self.task == "unsupervised":
            for _ in range(int(epoch)):
                for _ in self:
                    pass
