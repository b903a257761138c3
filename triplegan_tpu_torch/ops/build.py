"""Build the port's CUDA kernels from the sources in ``ops/csrc`` and load
them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for Hopper (``sm_90a``) into ``<build dir>/lib<name>-<hash>.so`` at first
use, where ``<hash>`` covers the source and the flags, so an edited source
builds anew. Nothing is built at import time: the CPU-only test
environment has no ``nvcc`` and imports every module.

The build directory is read at each build (``build_dir``): the one that
``utils/cache.py::enable_build_cache`` set, else the package's own
``_build/`` when it can be written (a checkout), else
``~/.cache/triplegan_tpu_torch_build`` (a read-only install).
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
PKG_BUILD_DIR = os.path.join(_PKG, "_build")
USER_BUILD_DIR = os.path.join("~", ".cache", "triplegan_tpu_torch_build")
# set by utils/cache.py::enable_build_cache; None: resolve_build_dir(None)
BUILD_DIR = None
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


def _writable(path: str) -> bool:
    """True if ``path`` can be written, or, where it does not exist yet,
    created in its nearest existing parent."""
    while not os.path.exists(path):
        parent = os.path.dirname(path)
        if parent == path:
            return False
        path = parent
    return os.access(path, os.W_OK)


def resolve_build_dir(path=None) -> str:
    """``path`` if given; else the package's ``_build/`` when it can be
    written; else ``~/.cache/triplegan_tpu_torch_build``."""
    if path:
        return os.path.abspath(os.path.expanduser(path))
    if _writable(PKG_BUILD_DIR):
        return PKG_BUILD_DIR
    return os.path.expanduser(USER_BUILD_DIR)


def build_dir() -> str:
    """Where the next build goes: ``BUILD_DIR`` when set, else
    ``resolve_build_dir()``, decided now."""
    return BUILD_DIR or resolve_build_dir()


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless this source and these flags are
    already built; return the shared library's path."""
    return build_shared(source_path(name), f"lib{name}", [_nvcc(), *NVCC_FLAGS])


def build_shared(src: str, stem: str, compiler: list) -> str:
    """Compile ``src`` with ``compiler`` (the command and its flags, which
    must make a shared library) into ``<build_dir()>/<stem>-<hash>.so``, the
    hash over the source and the command's flags, unless that file exists;
    return its path. The compiler writes a temporary file that is renamed
    into place, so a concurrent loader sees all or nothing; a failed build
    raises with the compiler's output."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(compiler[1:]).encode()).hexdigest()[:16]
    where = build_dir()
    out = os.path.join(where, f"{stem}-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(where, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=where)
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
