"""DataVec-equivalent ETL (port of ``deeplearning4j_tpu/datavec``): record
readers, schema transforms, image pipeline.

Reference: ``datavec/datavec-api org.datavec.api.**`` (RecordReader zoo,
``TransformProcess`` schema-based column transforms) and
``datavec-data-image org.datavec.image.recordreader.ImageRecordReader``
(JavaCV native decode).  Everything here is HOST-side numpy ETL feeding
the device through the async-prefetch iterator; a batch reaches the card
as one contiguous array per slot (one copy at the step boundary), never
element-wise.  The image reader's decode needs OpenCV, imported inside
the decode only.
"""
from deeplearning4j_torch.datavec.records import (
    CollectionRecordReader, CSVRecordReader, CSVSequenceRecordReader,
    LineRecordReader, RecordReader)
from deeplearning4j_torch.datavec.schema import Schema
from deeplearning4j_torch.datavec.transform import TransformProcess
from deeplearning4j_torch.datavec.image import ImageRecordReader
from deeplearning4j_torch.datavec.iterator import (
    RecordReaderDataSetIterator, SequenceRecordReaderDataSetIterator)

__all__ = [
    "RecordReader", "CSVRecordReader", "CSVSequenceRecordReader",
    "LineRecordReader", "CollectionRecordReader", "Schema",
    "TransformProcess", "ImageRecordReader", "RecordReaderDataSetIterator",
    "SequenceRecordReaderDataSetIterator",
]
