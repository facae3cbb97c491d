"""Data containers and iterators (port of ``deeplearning4j_tpu.data``)."""
from deeplearning4j_torch.data.bert_iterator import BertIterator
from deeplearning4j_torch.data.builtin import (Cifar10DataSetIterator,
                                               IrisDataSetIterator)
from deeplearning4j_torch.data.char_iterator import (CharacterIterator,
                                                     sample_characters)
from deeplearning4j_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_torch.data.iterator import (ArrayDataSetIterator,
                                                AsyncDataSetIterator,
                                                DataSetIterator,
                                                ExistingDataSetIterator,
                                                ListDataSetIterator)
from deeplearning4j_torch.data.mnist import MnistDataSetIterator
from deeplearning4j_torch.data.normalization import (
    ImagePreProcessingScaler, NormalizerMinMaxScaler, NormalizerStandardize)

__all__ = ["BertIterator", "CharacterIterator", "sample_characters",
           "DataSet", "MultiDataSet", "DataSetIterator",
           "ListDataSetIterator", "ArrayDataSetIterator",
           "AsyncDataSetIterator", "ExistingDataSetIterator",
           "MnistDataSetIterator",
           "Cifar10DataSetIterator", "IrisDataSetIterator",
           "NormalizerStandardize", "NormalizerMinMaxScaler",
           "ImagePreProcessingScaler"]
