"""Tokenizer factories (``org.deeplearning4j.text.tokenization
.tokenizerfactory.{DefaultTokenizerFactory,…}`` + the
``CommonPreprocessor`` lowercase/strip-punctuation step).

Port of ``deeplearning4j_tpu/nlp/tokenizer.py``: the same code, numpy and
the standard library only (the port keeps its own copy).
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional

_PUNCT = re.compile(r"[^\w\s]", re.UNICODE)


def common_preprocessor(token: str) -> str:
    """``CommonPreprocessor``: lowercase + strip punctuation."""
    return _PUNCT.sub("", token.lower())


class DefaultTokenizerFactory:
    """Whitespace tokenization + optional token preprocessor."""

    def __init__(self, preprocessor: Optional[Callable[[str], str]]
                 = common_preprocessor):
        self.preprocessor = preprocessor

    def tokenize(self, sentence: str) -> List[str]:
        toks = sentence.split()
        if self.preprocessor:
            toks = [self.preprocessor(t) for t in toks]
        return [t for t in toks if t]


class RegexTokenizerFactory(DefaultTokenizerFactory):
    """Tokens = regex matches (``NGramTokenizerFactory`` relative:
    the reference's regex tokenizer family)."""

    def __init__(self, pattern: str = r"\w+", preprocessor=None):
        super().__init__(preprocessor)
        self.pattern = re.compile(pattern)

    def tokenize(self, sentence: str) -> List[str]:
        toks = self.pattern.findall(sentence)
        if self.preprocessor:
            toks = [self.preprocessor(t) for t in toks]
        return [t for t in toks if t]
