"""NLP: Word2Vec / ParagraphVectors, FastText, tokenizers, vector
serialization (port of ``deeplearning4j_tpu.nlp``).

Reference: ``deeplearning4j-nlp-parent`` —
``org.deeplearning4j.models.word2vec.Word2Vec`` (skip-gram, hierarchical
softmax + negative sampling), ``models.paragraphvectors.ParagraphVectors``,
``text.tokenization.tokenizerfactory.*``, ``WordVectorSerializer``.
Training is batched skip-gram: pairs made on the host, one update per
batch on the device (gathers, analytic gradients, ``index_add_``).
"""
from deeplearning4j_torch.nlp.tokenizer import (DefaultTokenizerFactory,
                                                RegexTokenizerFactory)
from deeplearning4j_torch.nlp.word2vec import ParagraphVectors, Word2Vec
from deeplearning4j_torch.nlp.fasttext import FastText
from deeplearning4j_torch.nlp.serializer import WordVectorSerializer
from deeplearning4j_torch.nlp.wordpiece import BertWordPieceTokenizerFactory

__all__ = ["Word2Vec", "ParagraphVectors", "FastText",
           "BertWordPieceTokenizerFactory", "DefaultTokenizerFactory",
           "RegexTokenizerFactory", "WordVectorSerializer"]
