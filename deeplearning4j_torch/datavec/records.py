"""Record readers (port of ``deeplearning4j_tpu/datavec/records.py``: ``org.datavec.api.records.reader.RecordReader`` and the
impls in ``org.datavec.api.records.reader.impl.**``: CSVRecordReader,
LineRecordReader, CollectionRecordReader, CSVSequenceRecordReader).

A record is a list of values (strings/numbers); a sequence record is a
list of records.  Readers are plain Python iterators — DL4J's
InputSplit/Configuration plumbing collapses to constructor args.
"""
from __future__ import annotations

import csv
import io
import os
from typing import Iterable, Iterator, List, Optional, Sequence


class RecordReader:
    """Iterable over records, resettable (``RecordReader.next/hasNext/
    reset``)."""

    def __iter__(self) -> Iterator[List]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class LineRecordReader(RecordReader):
    """One record per line (``impl.LineRecordReader``)."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self):
        with open(self.path) as f:
            for line in f:
                yield [line.rstrip("\n")]


class CSVRecordReader(RecordReader):
    """CSV rows as records (``impl.csv.CSVRecordReader``): optional
    skipped header lines and custom delimiter, numeric auto-parsing."""

    def __init__(self, path: Optional[str] = None, skip_lines: int = 0,
                 delimiter: str = ",", text: Optional[str] = None,
                 parse_numbers: bool = True):
        if (path is None) == (text is None):
            raise ValueError("Give exactly one of path= or text=")
        self.path, self.text = path, text
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self.parse_numbers = parse_numbers

    @staticmethod
    def _parse(v: str):
        try:
            return int(v)
        except ValueError:
            try:
                return float(v)
            except ValueError:
                return v

    def __iter__(self):
        f = open(self.path) if self.path else io.StringIO(self.text)
        try:
            rd = csv.reader(f, delimiter=self.delimiter)
            for i, row in enumerate(rd):
                if i < self.skip_lines or not row:
                    continue
                yield ([self._parse(v) for v in row] if self.parse_numbers
                       else list(row))
        finally:
            f.close()


class CollectionRecordReader(RecordReader):
    """In-memory records (``impl.collection.CollectionRecordReader``) —
    the fixture/mock reader the reference test suites lean on."""

    def __init__(self, records: Sequence[Sequence]):
        self.records = [list(r) for r in records]

    def __iter__(self):
        return iter(self.records)


class CSVSequenceRecordReader(RecordReader):
    """One sequence per FILE of CSV rows
    (``impl.csv.CSVSequenceRecordReader``): yields [timesteps][columns]."""

    def __init__(self, paths: Sequence[str], skip_lines: int = 0,
                 delimiter: str = ","):
        self.paths = list(paths)
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def __iter__(self):
        for p in self.paths:
            rd = CSVRecordReader(p, self.skip_lines, self.delimiter)
            yield list(rd)
