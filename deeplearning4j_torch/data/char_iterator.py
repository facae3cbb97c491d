"""Character iterator for char-RNN language modelling (port of
``deeplearning4j_tpu/data/char_iterator.py``; numpy only, the same numpy
RNG draws as the reference, so both packages yield the same batches).

Parity with the dl4j-examples ``CharacterIterator`` of
``LSTMCharModellingExample`` (the GravesLSTM char-RNN baseline): one-hot
[b, t, vocab] features, labels the next character, random example
offsets drawn afresh every epoch; and ``sample_characters``, its
``sampleCharactersFromNetwork`` loop over ``rnn_time_step``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.data.iterator import DataSetIterator


class CharacterIterator(DataSetIterator):
    def __init__(self, text: str, seq_length: int = 64, batch: int = 32,
                 valid_chars: Optional[Sequence[str]] = None,
                 seed: int = 12345):
        if valid_chars is None:
            valid_chars = sorted(set(text))
        self.chars: List[str] = list(valid_chars)
        self.char_to_idx = {c: i for i, c in enumerate(self.chars)}
        self.data = np.asarray(
            [self.char_to_idx[c] for c in text if c in self.char_to_idx],
            np.int32)
        if len(self.data) <= seq_length + 1:
            raise ValueError("Text shorter than one sequence")
        self.seq_length = seq_length
        self.batch = batch
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    @property
    def vocab_size(self) -> int:
        return len(self.chars)

    def total_outcomes(self):
        return self.vocab_size

    def batch_size(self):
        return self.batch

    def _n_examples(self) -> int:
        return (len(self.data) - 1) // self.seq_length

    def __iter__(self):
        starts = self._rng.permutation(self._n_examples()) * self.seq_length
        eye = np.eye(self.vocab_size, dtype=np.float32)
        for i in range(0, len(starts) - self.batch + 1, self.batch):
            xs, ys = [], []
            for s in starts[i:i + self.batch]:
                window = self.data[s:s + self.seq_length + 1]
                xs.append(eye[window[:-1]])
                ys.append(eye[window[1:]])
            yield DataSet(np.stack(xs), np.stack(ys))

    def reset(self):
        # the RNG keeps rolling: each epoch draws a FRESH permutation of
        # example offsets (re-seeding would replay epoch 1's order)
        pass

    def set_epoch(self, epoch: int):
        """Make the next ``iter()`` yield epoch ``epoch``'s order (counted
        from 0 since construction): re-seed and draw the permutations of
        the epochs before it.  ``fit(resume=True)`` calls it, so a run
        resumed in a later epoch does not replay the first epoch's
        order."""
        self._rng = np.random.default_rng(self.seed)
        for _ in range(int(epoch)):
            self._rng.permutation(self._n_examples())

    def encode(self, s: str) -> np.ndarray:
        eye = np.eye(self.vocab_size, dtype=np.float32)
        return eye[[self.char_to_idx[c] for c in s]][None]

    def decode(self, indices) -> str:
        return "".join(self.chars[int(i)] for i in np.asarray(indices))


def _host(t) -> np.ndarray:
    """A network output as a host float32 array."""
    return t.detach().float().cpu().numpy()


def sample_characters(model, iterator: CharacterIterator, init: str,
                      n_chars: int = 200, temperature: float = 1.0,
                      seed: int = 0) -> str:
    """Generate text with ``rnn_time_step``: prime with ``init``, then feed
    each sampled character back one step at a time (one host read of the
    probabilities per character: the draw is numpy's, as the
    reference's)."""
    rng = np.random.default_rng(seed)
    model.rnn_clear_previous_state()
    probs = _host(model.rnn_time_step(iterator.encode(init)))[0, -1]
    out = list(init)
    eye = np.eye(iterator.vocab_size, dtype=np.float32)
    for _ in range(n_chars):
        logits = np.log(np.maximum(probs, 1e-12)) / temperature
        p = np.exp(logits - logits.max())
        p /= p.sum()
        idx = int(rng.choice(iterator.vocab_size, p=p))
        out.append(iterator.chars[idx])
        probs = _host(model.rnn_time_step(eye[idx][None]))[0]
    model.rnn_clear_previous_state()
    return "".join(out)
