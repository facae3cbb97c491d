"""Build the port's CUDA sources into plain-C shared libraries at first use.

Each ``kernels/csrc/*.cu`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into
``kernels/_build/lib<name>-<hash>.so`` (a directory git ignores), keyed
by a hash of the source and the flags, and is loaded with ``ctypes``.
Nothing is built when a module is imported: the first launch builds, or
``build_all()`` builds every library at once — one ``nvcc`` per source,
all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

#: library name -> source file under csrc/
SOURCES = {"paged_decode": "paged_decode.cu",
           "paged_verify": "paged_verify.cu",
           "flash_fwd": "flash_fwd.cu",
           "flash_bwd": "flash_bwd.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"),
                 os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels build on a machine with the CUDA toolkit")


def lib_path(name: str) -> str:
    """Where library ``name`` lives once built (content-addressed: the
    source, every shared header under csrc/, and the flags)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for fname in [SOURCES[name]] + headers:
        with open(os.path.join(_CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all(names: Optional[Iterable[str]] = None,
              verbose: bool = False) -> Dict[str, str]:
    """Compile every library in ``names`` (default: all) that is not built
    yet — one ``nvcc`` per source, all running at once.  Returns
    {name: path}; raises with nvcc's output on a failed build.  With
    ``verbose`` each build adds ``-Xptxas -v`` and the compiler's report
    is printed."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", tmp, os.path.join(_CSRC, SOURCES[name])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} ({proc.returncode}):\n"
                          f"{log}")
            continue
        if verbose and log:
            print(f"[{name}] {log.strip()}")
        os.replace(tmp, out)     # atomic: a reader never sees half a .so
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(build_all([name])[name])
        return lib
