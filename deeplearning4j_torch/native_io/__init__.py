"""ctypes binding for the native IO core (``native/``; port of
``deeplearning4j_tpu.native_io``).

The JavaCPP/JNI analogue, minus codegen: a plain C ABI
(``dl4j_csv_dims``/``dl4j_csv_parse``/``dl4j_u8_to_f32_scaled``) loaded
with ctypes.  Everything degrades gracefully to the pure-Python
``datavec`` path when the shared library hasn't been built —
``build_native()`` builds it with the repo's CMake project.
"""
from deeplearning4j_torch.native_io.binding import (NativeCSVRecordReader,
                                                  build_native,
                                                  load_csv_native,
                                                  native_available,
                                                  u8_to_f32_scaled)

__all__ = ["native_available", "build_native", "load_csv_native",
           "NativeCSVRecordReader", "u8_to_f32_scaled"]
