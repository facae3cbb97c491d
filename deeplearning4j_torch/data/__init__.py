"""Data containers and iterators (port of ``deeplearning4j_tpu.data``)."""
from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.data.iterator import (ArrayDataSetIterator,
                                                AsyncDataSetIterator,
                                                DataSetIterator,
                                                ListDataSetIterator)

__all__ = ["DataSet", "DataSetIterator", "ListDataSetIterator",
           "ArrayDataSetIterator", "AsyncDataSetIterator"]
