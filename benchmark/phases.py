"""The program's own marks in a traced window: device time a step by phase
of the train step, and the training call's host time outside its replay.

The program launches an empty mark kernel as each phase of a step opens
(``utils/profiling.py::phase``), and a CUDA graph replays them with the
step. A device record belongs to the phase of the latest mark that
started at or before it; records after an ``end`` mark, and before a
step's first mark, belong to none. The names live in
``metrics/phases.json``, so a renamed mark or span is a data edit.

A window that holds none of the program's marks and spans (a program
older than them) gives None: its readers report nothing. A window that
holds some of them but lacks those a reader needs, holds the marks out of
order or in another count than the steps traced, or whose phases leave
more than 3% of the marked steps' busy time unclaimed, raises: a phase
never reads 0.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
COVER = 0.97


def names() -> dict:
    with open(os.path.join(HERE, "metrics", "phases.json")) as f:
        return json.load(f)


def _none_of_the_programs(trace) -> bool:
    """True where the window holds no mark and no host span of the
    program's: it has none to record."""
    marks, spans = names()["prefixes"]["marks"], names()["prefixes"]["spans"]
    return (not any(r[2].startswith(marks) for r in trace.device)
            and not any(r[2].startswith(spans) for r in trace.host))


def _union(spans: List[Tuple[int, int]], lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] that the (start, end) intervals cover."""
    total, at = 0, lo
    for s, e in sorted(spans):
        s, e = max(s, at), min(e, hi)
        if e > s:
            total += e - s
            at = e
    return total


def phase_ns(trace, steps: int) -> Optional[Dict[str, float]]:
    """Device nanoseconds of each phase over the trace's ``steps`` steps
    (the phases' sum of their records' durations); None for a window with
    none of the program's marks and spans."""
    if trace is None:
        return None
    by_name = dict(names()["marks"])
    order = list(by_name.values())
    recs = trace.device
    marks = [(i, by_name[r[2]]) for i, r in enumerate(recs) if r[2] in by_name]
    if not marks:
        if _none_of_the_programs(trace):
            return None
        raise RuntimeError("the traced window holds no phase mark of the program's train step")
    seen = [p for _, p in marks]
    n = seen.count(order[0])
    if n != steps:
        raise RuntimeError(f"the traced window holds {n} {order[0]} marks for {steps} steps traced")
    if seen != order * n:
        raise RuntimeError(f"the phase marks are out of order or some are missing: {seen[:2 * len(order)]} ...")
    total = dict.fromkeys(order[:-1], 0)
    current = None
    at = {i: p for i, p in marks}
    for i in range(marks[0][0], marks[-1][0] + 1):
        current = at.get(i, current)
        if current in total:
            total[current] += recs[i][1] - recs[i][0]
    lo, hi = recs[marks[0][0]][0], recs[marks[-1][0]][1]
    busy = _union([(s, e) for s, e, _ in recs], lo, hi)
    if sum(total.values()) < COVER * busy:
        raise RuntimeError(f"the phases hold {sum(total.values()) / 1e6:.3f} ms of the marked steps' "
                           f"{busy / 1e6:.3f} ms of device time, under {COVER:.0%}: work runs outside them")
    return total


def phase_ms(ctx, *phases: str) -> Optional[float]:
    """Device ms a step of ``phases`` together, in a traced train run."""
    if ctx["kind"] != "train":
        return None
    total = phase_ns(ctx["trace"], ctx["trace_steps"])
    if total is None:
        return None
    return sum(total[p] for p in phases) / 1e6 / ctx["trace_steps"]


def call_self_ms(ctx) -> Optional[float]:
    """Host ms a step of the training call's spans outside the replay spans
    they hold, over the traced window's calls; None for a window with none
    of the program's marks and spans."""
    trace = ctx["trace"]
    if ctx["kind"] != "train" or trace is None:
        return None
    spans = names()["spans"]
    calls = [r for r in trace.host if r[2] == spans["call"]]
    if not calls:
        if _none_of_the_programs(trace):
            return None
        raise RuntimeError(f"the traced window holds no {spans['call']} span")
    if any(r[2] == spans["capture"] for r in trace.host):
        raise RuntimeError(f"a {spans['capture']} span lies in the traced window: the call captured its graph "
                           f"anew there")
    want = int(ctx["cell"].traffic["trace_calls"])
    if len(calls) != want:
        raise RuntimeError(f"the traced window holds {len(calls)} {spans['call']} spans for {want} calls")
    replays = [(s, e) for s, e, name in trace.host if name == spans["replay"]]
    own = sum((e - s) - _union(replays, s, e) for s, e, _ in calls)
    return own / 1e6 / ctx["trace_steps"]
