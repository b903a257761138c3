"""cbn_roofline.train_snresnet: the least time of a step's
class-conditional batch-norm epilogues (``work_snresnet.cbn_least_s``:
every forward and backward of the per-sample kernel, bound by its bytes)
over the device time, a traced step, of the kernels that the pattern
files under ``cbn_roofline.train_snresnet/`` name, in %. Nothing where
the window holds none of those kernels (a program without them) or the
cell's networks are others."""

import os

import harness
import traced as trace
import work_snresnet


def read(ctx):
    if ctx["kind"] != "train" or ctx["sizes"].get("arch") != "snresnet" or ctx["trace"] is None:
        return None
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cbn_roofline.train_snresnet")
    if ctx["trace"].matched_s(trace.patterns(folder))[1] == 0:
        return None
    least = work_snresnet.cbn_least_s(ctx["sizes"], harness.peaks(ctx["device_kind"]))
    return trace.roofline(ctx["trace"], folder, least, ctx["trace_steps"], "cbn_roofline.train_snresnet")
