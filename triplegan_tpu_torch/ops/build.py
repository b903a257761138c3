"""Build the port's CUDA kernels from the sources in ``ops/csrc`` and load
them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for Hopper (``sm_90a``) into ``triplegan_tpu_torch/_build/lib<name>-<hash>.so``
at first use, where ``<hash>`` covers the source and the flags, so an edited
source builds anew. Nothing is built at import time: the CPU-only test
environment has no ``nvcc`` and imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source on the machine with the card"
    )


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless this source and these flags are
    already built; return the shared library's path."""
    return build_shared(source_path(name), f"lib{name}", [_nvcc(), *NVCC_FLAGS])


def build_shared(src: str, stem: str, compiler: list) -> str:
    """Compile ``src`` with ``compiler`` (the command and its flags, which
    must make a shared library) into ``_build/<stem>-<hash>.so``, the hash
    over the source and the command's flags, unless that file exists;
    return its path. The compiler writes a temporary file that is renamed
    into place, so a concurrent loader sees all or nothing; a failed build
    raises with the compiler's output."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(compiler[1:]).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{stem}-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([*compiler, "-o", tmp, src], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{os.path.basename(compiler[0])} failed ({proc.returncode}) building {src}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(build(name))
        return lib
