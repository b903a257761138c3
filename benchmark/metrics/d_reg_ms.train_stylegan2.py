"""d_reg_ms.train_stylegan2: device ms a traced step of D's lazy R1
update, from each of the program's ``tg_phase_d_reg`` marks to the next
``tg_phase_d_grad`` mark (the names in ``d_reg_ms.train_stylegan2/
marks.json``), summed over the window and divided by all the steps traced,
so the update's cost amortised over its interval. A record belongs there
if it starts at or after the ``d_reg`` mark and before the ``d_grad``
mark; the ``d_reg`` mark's own record counts, as ``phases.py`` counts a
phase's mark.

A window with no ``d_reg`` mark gives None (a program or a configuration
without it). One whose ``d_reg`` marks number other than the steps traced
over the configuration's ``r1_interval``, or one of whose ``d_reg`` marks
another ``d_reg`` mark or the window's end follows before a ``d_grad``
mark, raises."""

import json
import os


def marks():
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "d_reg_ms.train_stylegan2",
                           "marks.json")) as f:
        m = json.load(f)
    return m["from"], m["to"]


def reg_ns(trace, steps: int, interval: int):
    """Device ns of the records from each ``from`` mark to the next ``to``
    mark, summed over the window; None without a ``from`` mark."""
    if trace is None:
        return None
    first, last = marks()
    recs = trace.device
    starts = [i for i, r in enumerate(recs) if r[2] == first]
    if not starts:
        return None
    if interval <= 0 or len(starts) * interval != steps:
        raise RuntimeError(f"the traced window holds {len(starts)} {first} marks for {steps} steps traced "
                           f"at an R1 interval of {interval}")
    total = 0
    for i in starts:
        j = i
        while j < len(recs) and recs[j][2] != last:
            if j > i and recs[j][2] == first:
                break
            total += recs[j][1] - recs[j][0]
            j += 1
        if j == len(recs) or recs[j][2] != last:
            raise RuntimeError(f"a {first} mark is not followed by a {last} mark before the next {first} mark "
                               f"or the window's end")
    return total


def read(ctx):
    if ctx["kind"] != "train" or ctx["sizes"].get("arch") != "stylegan2":
        return None
    ns = reg_ns(ctx["trace"], ctx["trace_steps"], int(ctx["sizes"].get("r1_interval", 0)))
    return None if ns is None else ns / 1e6 / ctx["trace_steps"]
