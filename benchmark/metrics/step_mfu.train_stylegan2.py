"""step_mfu.train_stylegan2: the model FLOPs of every step in the measured
window (``work_stylegan2.step_flops``: each conv, transposed conv, dense
and ZCA product of the three updates with the StyleGAN2 G and D, forward
and backward, and D's R1 update amortised over its interval, nothing
recomputed) over the window's seconds times the compute dtype's peak, in
%; nothing for a cell of other networks."""

import harness
import work_stylegan2


def read(ctx):
    if ctx["kind"] != "train" or ctx["sizes"].get("arch") != "stylegan2":
        return None
    peak = harness.peaks(ctx["device_kind"])["flops_per_s"][ctx["sizes"]["compute_dtype"]]
    return 100.0 * work_stylegan2.step_flops(ctx["sizes"]) * ctx["steps"] / (ctx["window_s"] * peak)
