"""epilogue_roofline.train_stylegan2: the least time of a step's
per-channel epilogues (``work_stylegan2.epilogue_least_s``: every forward
and backward of D's and C's conv epilogues, R1's amortised, bound by
their bytes) over the device time, a traced step, of the kernels that the
pattern files under ``epilogue_roofline.train_stylegan2/`` name, in %.
Nothing where the window holds none of those kernels or the cell's
networks are others."""

import os

import harness
import traced as trace
import work_stylegan2


def read(ctx):
    if ctx["kind"] != "train" or ctx["sizes"].get("arch") != "stylegan2" or ctx["trace"] is None:
        return None
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "epilogue_roofline.train_stylegan2")
    if ctx["trace"].matched_s(trace.patterns(folder))[1] == 0:
        return None
    least = work_stylegan2.epilogue_least_s(ctx["sizes"], harness.peaks(ctx["device_kind"]))
    return trace.roofline(ctx["trace"], folder, least, ctx["trace_steps"], "epilogue_roofline.train_stylegan2")
