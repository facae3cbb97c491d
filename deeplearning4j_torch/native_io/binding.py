"""ctypes loader + typed wrappers for libdl4j_tpu_native (port of
``deeplearning4j_tpu/native_io/binding.py``): the same library, built
from the repository's ``native/`` CMake project as it is, loaded the
same way; host only."""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from deeplearning4j_torch.datavec.records import RecordReader

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_NAMES = ("libdl4j_tpu_native.so", "libdl4j_tpu_native.dylib")

_lib: Optional[ctypes.CDLL] = None


def _find_lib() -> Optional[str]:
    cands = [os.path.join(_NATIVE_DIR, "build", n) for n in _LIB_NAMES]
    env = os.environ.get("DL4J_TPU_NATIVE_LIB")
    if env:
        cands.insert(0, env)
    for c in cands:
        if os.path.exists(c):
            return c
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = _find_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.dl4j_csv_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.dl4j_csv_dims.restype = ctypes.c_int
    lib.dl4j_csv_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int]
    lib.dl4j_csv_parse.restype = ctypes.c_int
    lib.dl4j_u8_to_f32_scaled.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_float]
    lib.dl4j_u8_to_f32_scaled.restype = None
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def build_native(quiet: bool = True) -> str:
    """Build the CMake project in-tree; returns the library path."""
    build_dir = os.path.join(_NATIVE_DIR, "build")
    kw = dict(capture_output=quiet, check=True)
    subprocess.run(["cmake", "-B", build_dir, "-S", _NATIVE_DIR], **kw)
    subprocess.run(["cmake", "--build", build_dir, "-j"], **kw)
    path = _find_lib()
    if path is None:
        raise RuntimeError("native build produced no library")
    global _lib
    _lib = None  # force reload
    return path


def load_csv_native(path: str, skip_lines: int = 0, delimiter: str = ",",
                    n_threads: int = 0) -> np.ndarray:
    """Whole CSV -> float32 [rows, cols] through the native parser.
    Raises RuntimeError when the library isn't built (callers that want
    the fallback use NativeCSVRecordReader)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native library not built — run "
            "deeplearning4j_torch.native_io.build_native()")
    n_threads = n_threads or (os.cpu_count() or 1)
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.dl4j_csv_dims(path.encode(), skip_lines,
                           delimiter.encode()[0:1] or b",",
                           ctypes.byref(rows), ctypes.byref(cols))
    if rc:
        raise IOError(f"dl4j_csv_dims({path!r}) failed rc={rc}")
    out = np.empty((rows.value, cols.value), np.float32)
    rc = lib.dl4j_csv_parse(
        path.encode(), skip_lines, delimiter.encode()[0:1] or b",",
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows.value, cols.value, int(n_threads))
    if rc:
        raise ValueError(
            f"dl4j_csv_parse({path!r}) failed rc={rc} (non-numeric cell "
            "or ragged row?)")
    return out


def u8_to_f32_scaled(arr: np.ndarray, scale: float = 1.0 / 255.0
                     ) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(arr, np.uint8)
    if lib is None:
        return src.astype(np.float32) * scale  # fallback
    dst = np.empty(src.shape, np.float32)
    lib.dl4j_u8_to_f32_scaled(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.size, ctypes.c_float(scale))
    return dst


class NativeCSVRecordReader(RecordReader):
    """Drop-in for ``CSVRecordReader`` on NUMERIC CSVs: parses the whole
    file natively, yields rows as float lists.  Falls back to the Python
    reader when the native library isn't available."""

    def __init__(self, path: str, skip_lines: int = 0,
                 delimiter: str = ",", n_threads: int = 0):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self.n_threads = n_threads
        self._matrix: Optional[np.ndarray] = None

    def matrix(self) -> np.ndarray:
        if self._matrix is None:
            if native_available():
                self._matrix = load_csv_native(
                    self.path, self.skip_lines, self.delimiter,
                    self.n_threads)
            else:
                from deeplearning4j_torch.datavec.records import \
                    CSVRecordReader
                rows = list(CSVRecordReader(self.path, self.skip_lines,
                                            self.delimiter))
                self._matrix = np.asarray(rows, np.float32)
        return self._matrix

    def __iter__(self):
        for row in self.matrix():
            yield row.tolist()

    def reset(self):
        pass
