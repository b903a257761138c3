"""A NaN/Inf-checking debug mode: the port of ``triplegan_tpu/utils/debug.py``,
whose ``checkify_step`` wraps a jitted step in ``jax.experimental.checkify``
with ``float_checks``.

Usage:
    step = checkify_step(make_train_step(...))   # debug runs only
    state, metrics = step(state, batch)          # raises on NaN/Inf

While the wrapped step runs, a ``TorchDispatchMode`` sees every operator
that reaches PyTorch's dispatcher below autograd: the forward's, the
backward's (autograd hands the mode to the threads that run a backward on
the card) and the port's kernels, which are operators
(``triplegan_torch::scale_bias_act``, ``conv3x3_fwd``). For each floating
output of an operator that computes one (not an allocation, not a view) it
queues ``isfinite(out).all()`` on the output's device, and notes
the operator and the Python line that issued it (the innermost frame
outside torch); for a backward operator, the autograd node it belongs to
and the line of the forward that made that node, which autograd's anomaly
mode records (``check_nan=False``: the mode's own NaN check stays off),
the only Python line there is on the card's backward threads. After the
step (or when it raises) one read of those flags finds the first operator whose
output held a NaN or an Inf, and ``NonFiniteError`` names it, as
checkify's error names the first failing primitive after the computation
has run. The flags cost two small launches an operator and one
synchronization a step; a checked step is for debugging, not production.

A ``ScanChunk`` (several steps as one CUDA graph) is refused: a graph
replays its kernels without the dispatcher, so nothing could be checked
operator by operator.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Callable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_THIS = os.path.abspath(__file__)
# outputs that hold no computed value yet (uninitialized memory)
_UNWRITTEN = frozenset({"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                        "resize_", "set_"})


class NonFiniteError(FloatingPointError):
    """An operator of a checked step produced a NaN or an Inf."""


_FRAME = re.compile(r'File "(.+)", line (\d+), in (\S+)')


def _outside_torch(path: str) -> bool:
    return not (path.startswith(_TORCH_DIR) or os.path.abspath(path) == _THIS or path.startswith("<"))


def _forward_line(trace) -> Optional[Tuple[str, int, str]]:
    """(file, line, function) of the innermost frame outside torch in a
    stack that anomaly mode recorded (a list of ``format_stack`` lines)."""
    for entry in reversed(trace or []):
        m = _FRAME.search(entry)
        if m and _outside_torch(m.group(1)):
            return m.group(1), int(m.group(2)), m.group(3)
    return None


def _issuer() -> Optional[Tuple[str, int, str]]:
    """(file, line, function) of the innermost Python frame outside torch
    and this module: the line that issued the current operator; None on a
    thread that runs no Python of its own (autograd's device threads)."""
    f = sys._getframe(2)
    while f is not None:
        if _outside_torch(f.f_code.co_filename):
            return f.f_code.co_filename, f.f_lineno, f.f_code.co_name
        f = f.f_back
    return None


class _FloatCheck(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flags: List[torch.Tensor] = []
        self.sites: List[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # a view computes no value: its values were checked where they were
        # computed, or are memory not written yet (a slice of an ``empty``
        # that an in-place op fills next)
        if func.overloadpacket.__name__ in _UNWRITTEN or func.is_view:
            return out
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel():
                node = torch._C._current_autograd_node()
                self.flags.append(torch.isfinite(t).all())
                # the forward's recorded stack (a list of strings), parsed on error only
                self.sites.append((str(func), _issuer(), None if node is None else node.name(),
                                   None if node is None else node.metadata.get("traceback_")))
        return out

    def first_failure(self) -> Optional[int]:
        """Index of the first flag that is false: one read a device."""
        by_dev = {}
        for i, f in enumerate(self.flags):
            by_dev.setdefault(f.device, []).append(i)
        first = None
        for idx in by_dev.values():
            bad = torch.nonzero(~torch.stack([self.flags[i] for i in idx])).flatten().tolist()
            if bad and (first is None or idx[bad[0]] < first):
                first = idx[bad[0]]
        return first

    def error(self, i: int) -> NonFiniteError:
        op, where, node, trace = self.sites[i]
        parts = []
        if where is not None:
            parts.append(f"issued at {where[0]}:{where[1]} in {where[2]}")
        forward = _forward_line(trace)
        if forward is not None:
            parts.append(f"its forward at {forward[0]}:{forward[1]} in {forward[2]}")
        inside = f", in the backward of {node}" if node else ""
        return NonFiniteError(f"NaN or Inf in the output of {op} (operator {i + 1} of "
                              f"{len(self.flags)} checked{inside}), "
                              + ("; ".join(parts) or "no Python frame recorded"))


def checkify_step(step_fn: Callable) -> Callable:
    """Wrap a ``(state, batch) -> (state, metrics)`` step so that it raises
    ``NonFiniteError`` naming the first operator whose floating output held
    a NaN or an Inf (its aten name, the Python line that issued it, and for
    a backward operator its autograd node and the forward line that made
    it). ``TypeError`` for a ``ScanChunk``."""
    from triplegan_tpu_torch.train.step import ScanChunk

    if isinstance(step_fn, ScanChunk):
        raise TypeError(
            "checkify_step cannot check a ScanChunk: its steps replay as one CUDA graph, whose kernels "
            "run without PyTorch's dispatcher, so no operator's output can be checked. Check the "
            "single step it was built from (make_device_train_step) instead.")

    def run(state, batch):
        mode = _FloatCheck()
        try:
            with torch.autograd.set_detect_anomaly(True, check_nan=False), mode:
                out = step_fn(state, batch)
        except Exception as e:
            i = mode.first_failure()
            if i is not None:
                raise mode.error(i) from e
            raise
        i = mode.first_failure()
        if i is not None:
            raise mode.error(i)
        return out

    return run
