"""Data containers and iterators (port of ``deeplearning4j_tpu.data``)."""
from deeplearning4j_torch.data.bert_iterator import BertIterator
from deeplearning4j_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_torch.data.iterator import (ArrayDataSetIterator,
                                                AsyncDataSetIterator,
                                                DataSetIterator,
                                                ListDataSetIterator)

__all__ = ["BertIterator", "DataSet", "MultiDataSet", "DataSetIterator",
           "ListDataSetIterator", "ArrayDataSetIterator",
           "AsyncDataSetIterator"]
