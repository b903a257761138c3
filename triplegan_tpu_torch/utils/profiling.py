"""Tracing and step timing: the port of ``triplegan_tpu/utils/profiling.py``.

``trace`` records a window with ``torch.profiler`` (the host's operators,
and the card's kernels and copies when there is a card) into a Chrome
trace, which chrome://tracing, Perfetto or TensorBoard's profile plugin
reads; ``start_trace`` and ``stop_trace`` are its two halves, for a window
that opens and closes in different places. ``step_timer`` wall-clocks a
block with the card synchronized at both ends, so that asynchronous
launches cannot hide device time.

``span(name)`` names a block of host work ``tg::<name>`` in such a trace,
on the clock of the card's records; with no profiler recording it costs
one check. ``phase(name, device)`` opens a phase of the training step
where it is called, which lasts until the next opens: the span
``phase.<name>`` in a trace and, on the card, one launch of the phase's
mark kernel (``ops/csrc/phase_marks.cu``, ``tg_phase_<name>``) on the
current stream. A CUDA graph captures the marks with the step, so every
replay carries them: a mark's start in the trace is where its phase
begins on the card, which no host span of a replay can show. The marks
are always launched, profiler or not, since a graph is captured before
any window opens.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import time
from typing import Iterator

import torch

_mark_fns: dict = {}  # the mark kernels' launchers by phase, bound at their first mark


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def span(name: str):
    """A context manager that records its block as the host span
    ``tg::<name>`` when a profiler records this thread, and does nothing
    otherwise. The span is an operator's record, not a user annotation
    (``torch.profiler.record_function``), for which the profiler would add
    a device record spanning every kernel the block launched: a replay's
    span would then count the card as busy through the replay's idle
    gaps."""
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch._C._profiler._RecordFunctionFast("tg::" + name)


def _mark(name: str):
    """The bound launcher ``tg_phase_<name>_mark(stream)``, the mark kernels
    built and loaded at the first mark."""
    fn = _mark_fns.get(name)
    if fn is None:
        from triplegan_tpu_torch.ops import build

        fn = getattr(build.load("phase_marks"), f"tg_phase_{name}_mark")
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _mark_fns[name] = fn
    return fn


def phase(name: str, device: torch.device) -> None:
    """Open the phase ``name`` here: the span ``phase.<name>`` around, on a
    CUDA ``device`` (on the CPU nothing), one launch of the phase's mark
    kernel on the device's current stream. The eager step opens seven a
    step, so the launch reads the raw stream handle and switches device
    only where the current one is another (a kernel goes to the current
    device's streams)."""
    with span("phase." + name):
        if device.type == "cuda":
            index = device.index if device.index is not None else torch.cuda.current_device()
            switch = index != torch.cuda.current_device()
            with torch.cuda.device(index) if switch else contextlib.nullcontext():
                rc = _mark(name)(torch._C._cuda_getCurrentRawStream(index))
            if rc != 0:
                raise RuntimeError(f"the mark kernel of phase {name!r} failed to launch: cudaError {rc}")


def start_trace() -> torch.profiler.profile:
    """A profiler recording the host and, where there is one, the card,
    started after the card has finished its queued work."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _sync()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, path: str) -> None:
    """Stop ``prof`` once the card has finished the window's work and write
    its Chrome trace to ``path``."""
    _sync()
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[str]:
    """``with trace('/tmp/tb') as path: run_steps()`` writes the window's
    Chrome trace to ``path`` (``<logdir>/trace_<pid>_<ns>.json``), after
    the card has finished the window's work."""
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof = start_trace()
    try:
        yield path
    finally:
        stop_trace(prof, path)


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
