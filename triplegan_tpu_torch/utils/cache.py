"""Where the port keeps the kernels it builds: the counterpart of
``triplegan_tpu/utils/cache.py``, which points XLA's compilation cache at a
directory so that each program compiles once.

The port compiles its kernels itself (``ops/build.py``: the three ``.cu``
sources with ``nvcc``, ``data/csrc/batch_gather.cpp`` with ``g++``), each
into a library named by a hash of its source and flags, built at first use
and found again by every later process that looks in the same directory.
"""

from __future__ import annotations

from typing import Optional

from triplegan_tpu_torch.ops import build


def enable_build_cache(path: Optional[str] = None) -> str:
    """Send every later build to ``path``; without one, to the package's
    ``_build/`` when it can be written, else to
    ``~/.cache/triplegan_tpu_torch_build``. Returns the directory."""
    build.BUILD_DIR = build.resolve_build_dir(path)
    return build.BUILD_DIR
