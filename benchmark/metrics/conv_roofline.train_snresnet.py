"""conv_roofline.train_snresnet: the least time of a step's 3×3 stride-1
conv work with the SN-ResNet G and D (``work_snresnet.conv3x3_least_s``:
forward, input and filter gradients, each call bound by operations at the
dtype's peak or bytes at the memory's) over the device time, a traced
step, of the kernels that the pattern files under
``conv_roofline.train_snresnet/`` name, in %; nothing for a cell of other
networks."""

import os

import harness
import traced as trace
import work_snresnet


def read(ctx):
    if ctx["kind"] != "train" or ctx["sizes"].get("arch") != "snresnet":
        return None
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conv_roofline.train_snresnet")
    least = work_snresnet.conv3x3_least_s(ctx["sizes"], harness.peaks(ctx["device_kind"]))
    return trace.roofline(ctx["trace"], folder, least, ctx["trace_steps"], "conv_roofline.train_snresnet")
