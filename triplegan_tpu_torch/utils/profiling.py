"""Tracing and step timing: the port of ``triplegan_tpu/utils/profiling.py``.

``trace`` records a window with ``torch.profiler`` (the host's operators,
and the card's kernels and copies when there is a card) into a Chrome
trace, which chrome://tracing, Perfetto or TensorBoard's profile plugin
reads. ``step_timer`` wall-clocks a block with the card synchronized at
both ends, so that asynchronous launches cannot hide device time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[str]:
    """``with trace('/tmp/tb') as path: run_steps()`` writes the window's
    Chrome trace to ``path`` (``<logdir>/trace_<pid>_<ns>.json``), after
    the card has finished the window's work."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    _sync()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield path
    finally:
        _sync()
        prof.stop()
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def step_timer(result: dict, key: str = "seconds") -> Iterator[None]:
    """``result[key]`` = the block's wall seconds, read after the current
    CUDA device has finished all queued work (and started from a finished
    one), the counterpart of JAX's ``block_until_ready`` fence."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    result[key] = time.perf_counter() - t0
