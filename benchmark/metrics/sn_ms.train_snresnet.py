"""sn_ms.train_snresnet: device ms a traced step from each of the
program's ``tg_phase_sn`` marks to the next ``tg_phase_d_grad`` mark (the
names in ``sn_ms.train_snresnet/marks.json``): a spectrally normalised D's
power iterations at the start of D's update. A record belongs there if it
starts at or after the ``sn`` mark and before the ``d_grad`` mark; the
``sn`` mark's own record counts, as ``phases.py`` counts a phase's mark.

A window with no ``sn`` mark gives None (a program or a D without it). One
whose ``sn`` marks number other than the steps traced, or one of whose
``sn`` marks another ``sn`` mark or the window's end follows before a
``d_grad`` mark, raises."""

import json
import os


def marks():
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "sn_ms.train_snresnet", "marks.json")) as f:
        m = json.load(f)
    return m["from"], m["to"]


def sn_ns(trace, steps: int):
    """Device ns of the records from each ``from`` mark to the next ``to``
    mark, summed over the window; None without a ``from`` mark."""
    if trace is None:
        return None
    first, last = marks()
    recs = trace.device
    starts = [i for i, r in enumerate(recs) if r[2] == first]
    if not starts:
        return None
    if len(starts) != steps:
        raise RuntimeError(f"the traced window holds {len(starts)} {first} marks for {steps} steps traced")
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
    if ctx["kind"] != "train":
        return None
    ns = sn_ns(ctx["trace"], ctx["trace_steps"])
    return None if ns is None else ns / 1e6 / ctx["trace_steps"]
