"""The native batch assembler: the port of ``triplegan_tpu/data/native.py``.

``csrc/batch_gather.cpp`` (the port's own copy of the JAX package's
``csrc/batch_gather.cpp``) gathers rows of a uint8 array into one
contiguous buffer with a tight ``memcpy`` loop, fanned out over threads for
large batches. It compiles with ``g++`` at first use into
``<build dir>/libbatch_gather-<hash>.so`` (the hash over the source and the
flags; the directory ``ops/build.py::build_dir`` gives, as for a ``.cu``)
and loads with ``ctypes``.

Unlike the JAX module there is no silent numpy path: a failed build
raises, with the compiler's output. The numpy gather is the plain twin,
``reference_gather_rows``, which the tests hold the native one to. Both
keep the JAX module's strict contract: an index out of range raises
``IndexError`` (the C++ clamps only as a memory-safety backstop).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from triplegan_tpu_torch.ops import build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "batch_gather.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

# Bytes a gather moves for each thread it starts: starting and joining a
# thread costs more than copying less (one gather of 100 rows of 32x32x3
# uint8, 300 KB, took 0.057 ms on one thread and 2.48 ms on eight, on the
# host of an H100 machine: PERF.md).
BYTES_A_THREAD = 4 << 20

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build.build_shared(SOURCE, "libbatch_gather", ["g++", *CXX_FLAGS]))
            lib.gather_rows_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
            ]
            lib.gather_rows_u8.restype = None
            _lib = lib
        return _lib


def native_available() -> bool:
    """True once the native library is loaded, that is once a gather has
    run through it (the first one builds it)."""
    return _lib is not None


def _check_index(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= src.shape[0]):
        raise IndexError(f"gather_rows: index out of bounds for axis 0 with size {src.shape[0]}")
    return idx


def reference_gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Plain version of ``gather_rows``: numpy fancy indexing."""
    return src[_check_index(src, idx)]


def default_threads(nbytes: int) -> int:
    """Threads of a gather that moves ``nbytes``: one per
    ``BYTES_A_THREAD``, at least one, at most min(CPUs, 8)."""
    return max(1, min(os.cpu_count() or 1, 8, nbytes // BYTES_A_THREAD))


def gather_rows(src: np.ndarray, idx: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """dst[i] = src[idx[i]] over axis 0 through the native library; ``src``
    must be C-contiguous (any dtype: rows are copied as bytes). Raises
    ``IndexError`` for an index outside [0, len(src)). ``n_threads`` <= 0
    takes ``default_threads`` of the bytes moved."""
    idx = _check_index(src, idx)
    if not src.flags.c_contiguous:
        raise ValueError("gather_rows needs a C-contiguous source array")
    lib = _load()
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    if n_threads <= 0:
        n_threads = default_threads(len(idx) * row_bytes)
    dst = np.empty((len(idx),) + src.shape[1:], dtype=src.dtype)
    lib.gather_rows_u8(src.ctypes.data_as(ctypes.c_void_p), src.shape[0], row_bytes,
                       idx.ctypes.data_as(ctypes.c_void_p), len(idx),
                       dst.ctypes.data_as(ctypes.c_void_p), n_threads)
    return dst
