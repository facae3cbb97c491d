"""BERT WordPiece tokenization (``org.deeplearning4j.text.tokenization
.tokenizerfactory.BertWordPieceTokenizerFactory`` [UNVERIFIED]) — the
tokenizer side of BASELINE config 4's SST-2 fine-tune pipeline.

Algorithm parity target is the canonical BERT basic+wordpiece pass
(whitespace clean, punctuation split, optional lowercase + accent
strip, then greedy longest-match-first subwords with the ``##``
continuation prefix and per-token UNK on failure); goldens in
``tests/test_wordpiece.py`` come from the installed ``transformers``
``BertTokenizer`` over a locally-written vocab file (no egress).

Port of ``deeplearning4j_tpu/nlp/wordpiece.py``: the same code, numpy and
the standard library only (the port keeps its own copy).
"""
from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Union


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _basic_tokens(text: str, lower: bool, strip_accents: bool
                  ) -> List[str]:
    out: List[str] = []
    for tok in text.strip().split():
        if lower:
            tok = tok.lower()
        if strip_accents:
            tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                          if unicodedata.category(c) != "Mn")
        cur = ""
        for ch in tok:
            if _is_punct(ch):
                if cur:
                    out.append(cur)
                    cur = ""
                out.append(ch)
            else:
                cur += ch
        if cur:
            out.append(cur)
    return out


class BertWordPieceTokenizerFactory:
    """Greedy longest-match-first WordPiece over a BERT vocab.

    ``vocab`` is a path to a one-token-per-line vocab.txt (HF layout:
    line number == id) or an explicit token->id dict.
    """

    def __init__(self, vocab: Union[str, Dict[str, int]],
                 lower_case: bool = True, strip_accents: bool = True,
                 unk_token: str = "[UNK]", max_input_chars: int = 100):
        if isinstance(vocab, str):
            with open(vocab, encoding="utf-8") as f:
                tokens = [ln.rstrip("\n") for ln in f]
            vocab = {t: i for i, t in enumerate(tokens)}
        self.vocab: Dict[str, int] = dict(vocab)
        self.inv: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.lower_case = lower_case
        self.strip_accents = strip_accents
        self.unk = unk_token
        self.max_input_chars = max_input_chars
        for special in ("[PAD]", "[CLS]", "[SEP]", unk_token):
            if special not in self.vocab:
                raise ValueError(f"vocab is missing {special!r}")

    def _wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_input_chars:
            return [self.unk]
        pieces, start = [], 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk]       # whole-token UNK, not partial
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in _basic_tokens(text, self.lower_case,
                                 self.strip_accents):
            out.extend(self._wordpiece(tok))
        return out

    def encode(self, text: str, pair: Optional[str] = None,
               max_len: Optional[int] = None):
        """-> (ids, attention_mask, token_type_ids) with [CLS]/[SEP]
        framing, truncated (HF ``longest_first``: pop from the end of
        the LONGER segment, the PAIR on ties) and padded to
        ``max_len`` when given."""
        v = self.vocab
        if max_len is not None:
            floor = 2 if pair is None else 3
            if max_len < floor:
                raise ValueError(
                    f"max_len={max_len} cannot fit the special tokens "
                    f"([CLS]/[SEP] framing needs >= {floor} positions "
                    f"{'with a pair' if pair else ''})")
        conv = lambda toks: [v[t] for t in toks]
        a = self.tokenize(text)
        if pair is None:
            if max_len is not None and len(a) > max_len - 2:
                a = a[:max_len - 2]
            ids = [v["[CLS]"]] + conv(a) + [v["[SEP]"]]
            tt = [0] * len(ids)
        else:
            b = self.tokenize(pair)
            if max_len is not None:
                while len(a) + len(b) > max_len - 3:
                    (a if len(a) > len(b) else b).pop()
            ids = ([v["[CLS]"]] + conv(a) + [v["[SEP]"]]
                   + conv(b) + [v["[SEP]"]])
            tt = [0] * (len(a) + 2) + [1] * (len(b) + 1)
        if max_len is not None:
            pad = max_len - len(ids)
            mask = [1] * len(ids) + [0] * pad
            ids += [v["[PAD]"]] * pad
            tt += [0] * pad
        else:
            mask = [1] * len(ids)
        return ids, mask, tt

    def decode(self, ids: Iterable[int]) -> str:
        toks = [self.inv.get(int(i), self.unk) for i in ids]
        out = ""
        for t in toks:
            if t in ("[CLS]", "[SEP]", "[PAD]"):
                continue
            if t.startswith("##"):
                out += t[2:]
            else:
                out += (" " if out else "") + t
        return out
