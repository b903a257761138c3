"""epilogue_roofline.train: the least time of a step's act(x·k + b)
epilogues (``work.epilogue_least_s``: every forward and backward, bound by
its bytes) over the device time, a traced step, of the kernels that the
pattern files under ``epilogue_roofline.train/`` name, in %."""

import os

import harness
import traced as trace
import work


def read(ctx):
    if ctx["kind"] != "train":
        return None
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "epilogue_roofline.train")
    least = work.epilogue_least_s(ctx["sizes"], harness.peaks(ctx["device_kind"]))
    return trace.roofline(ctx["trace"], folder, least, ctx["trace_steps"], "epilogue_roofline.train")
