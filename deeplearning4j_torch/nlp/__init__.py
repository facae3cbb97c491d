"""NLP tokenizers (port of ``deeplearning4j_tpu.nlp``, its tokenizer
factories and BERT WordPiece so far; Word2Vec, FastText and the vector
serializer come with the periphery)."""
from deeplearning4j_torch.nlp.tokenizer import (DefaultTokenizerFactory,
                                                RegexTokenizerFactory)
from deeplearning4j_torch.nlp.wordpiece import BertWordPieceTokenizerFactory

__all__ = ["BertWordPieceTokenizerFactory", "DefaultTokenizerFactory",
           "RegexTokenizerFactory"]
