"""conv_roofline.train_stylegan2: the least time of a step's 3×3 stride-1
conv work with the StyleGAN2 G and D (``work_stylegan2.conv3x3_least_s``:
forward, input and filter gradients, R1's first- and second-order convs
amortised over its interval, each call bound by operations at the dtype's
peak or bytes at the memory's) over the device time, a traced step, of the
kernels that the pattern files under ``conv_roofline.train_stylegan2/``
name, in %; nothing for a cell of other networks."""

import os

import harness
import traced as trace
import work_stylegan2


def read(ctx):
    if ctx["kind"] != "train" or ctx["sizes"].get("arch") != "stylegan2":
        return None
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conv_roofline.train_stylegan2")
    least = work_stylegan2.conv3x3_least_s(ctx["sizes"], harness.peaks(ctx["device_kind"]))
    return trace.roofline(ctx["trace"], folder, least, ctx["trace_steps"], "conv_roofline.train_stylegan2")
