"""A traced window on the card, and the arithmetic the per-layer readers
share: device busy time, idle gaps and what the host was doing in them,
device time by kernel name.

The window runs under ``torch.profiler`` (host and device activity). The
profiler has been seen to lose a window's first device records in some
states of a long process, so the window's work is bracketed by marker
kernels on each side; a trace that keeps none of the markers on one side
may have lost records of the work, and raises. The traced window on the
device runs from the end of the last leading marker to the start of the
first trailing one.
"""

from __future__ import annotations

import bisect
import collections
import re
import time
from typing import Callable, List, Optional, Sequence, Tuple

MARKERS = 256
MARKER = "spin_kernel"   # torch.cuda._sleep's kernel
MARGIN_S = 0.2           # host-side quiet before and after the window


class Trace:
    """Device records ``device`` and host records ``host``, each a sorted
    list of (start_ns, end_ns, name), and the device window (start_ns,
    end_ns)."""

    def __init__(self, device: List[Tuple[int, int, str]], host: List[Tuple[int, int, str]],
                 window: Tuple[int, int]):
        self.device, self.host, self.window = device, host, window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device records inside the window."""
        lo, hi = self.window
        out: List[List[int]] = []
        for s, e, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        lo, hi = self.window
        edges, at = [], lo
        for s, e in self.busy():
            if s > at:
                edges.append((at, s))
            at = max(at, e)
        if hi > at:
            edges.append((at, hi))
        return edges

    def matched_s(self, patterns: Sequence[str]) -> Tuple[float, int]:
        """Device seconds and records of the kernels whose names match any
        of ``patterns`` (regular expressions, searched)."""
        rx = [re.compile(p) for p in patterns]
        s, n = 0, 0
        for a, b, name in self.device:
            if any(r.search(name) for r in rx):
                s += b - a
                n += 1
        return s / 1e9, n

    def device_ops(self, top: int = 10) -> List[list]:
        by = collections.Counter()
        for a, b, name in self.device:
            by[name[:96]] += (b - a) / 1e9
        return [[n, s] for n, s in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle device time summed by what the host was doing: for each gap,
        the host record that covers most of it (the innermost on a tie),
        else "host: no recorded op"."""
        starts = [h[0] for h in self.host]
        by = collections.Counter()
        longest = max((e - s for s, e, _ in self.host), default=0)
        for g0, g1 in self.gaps():
            best, label = 0, "host: no recorded op"
            i = bisect.bisect_left(starts, g0 - longest)
            for s, e, name in self.host[i:]:
                if s >= g1:
                    break
                cover = min(e, g1) - max(s, g0)
                if cover > 0 and cover >= best:
                    best, label = cover, name[:96]
            by[label] += (g1 - g0) / 1e9
        return [[n, s] for n, s in by.most_common(top)]


def record(work: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """Run ``work`` under the profiler between two runs of marker kernels
    and return its ``Trace``. ``sync`` waits for the device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def markers():
        for _ in range(MARKERS):
            torch.cuda._sleep(100)

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(MARGIN_S)
        markers()
        work()
        markers()
        sync()
        time.sleep(MARGIN_S)
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.start_ns(), e.end_ns(), e.name())
        (device if e.device_type() == DeviceType.CUDA else host).append(rec)
    device.sort()
    host.sort()
    return from_records(device, host)


def from_records(device: List[Tuple[int, int, str]], host: List[Tuple[int, int, str]]) -> Trace:
    """The ``Trace`` of sorted records whose work lies between two runs of
    ``MARKERS`` marker kernels."""
    marks = [i for i, r in enumerate(device) if MARKER in r[2]]
    inner = [i for i, r in enumerate(device) if MARKER not in r[2]]
    if not inner:
        raise RuntimeError("the traced window holds no device record of its work")
    lead = [i for i in marks if i < inner[0]]
    trail = [i for i in marks if i > inner[-1]]
    if not lead or not trail:
        raise RuntimeError(f"the trace kept {len(lead)} marker kernels before the work and {len(trail)} after it "
                           f"(of {MARKERS} a side): it may have lost records of the work")
    window = (device[lead[-1]][1], device[trail[0]][0])
    work = [device[i] for i in inner]
    return Trace(work, host, window)


def patterns(folder: str) -> List[str]:
    """Every pattern of the ``*.txt`` files of ``folder``: one regular
    expression a line, blank lines and lines starting with # skipped."""
    import glob
    import os

    out: List[str] = []
    for path in sorted(glob.glob(os.path.join(folder, "*.txt"))):
        with open(path) as f:
            out += [ln.strip() for ln in f if ln.strip() and not ln.lstrip().startswith("#")]
    if not out:
        raise RuntimeError(f"no kernel-name pattern under {folder}")
    return out


def roofline(trace: Optional[Trace], folder: str, least_s_per_step: float, steps: int, what: str) -> Optional[float]:
    """100 · (the least time of ``steps`` steps' work) / (device time of the
    records the patterns of ``folder`` match); None without a trace. A
    trace in which no record matches raises: a share never reads 0."""
    if trace is None:
        return None
    s, n = trace.matched_s(patterns(folder))
    if n == 0:
        raise RuntimeError(f"{what}: the kernel-name patterns under {folder} match no device record of the "
                           f"traced window; add a pattern file naming the kernels that now do this work")
    return 100.0 * least_s_per_step * steps / s
