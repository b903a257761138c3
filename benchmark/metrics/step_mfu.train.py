"""step_mfu.train: the model FLOPs of every step in the measured window
(``work.step_flops``: each conv, transposed conv, dense and ZCA product the
three updates need, forward and backward, nothing recomputed) over the
window's seconds times the compute dtype's peak, in %."""

import harness
import work


def read(ctx):
    if ctx["kind"] != "train":
        return None
    peak = harness.peaks(ctx["device_kind"])["flops_per_s"][ctx["sizes"]["compute_dtype"]]
    return 100.0 * work.step_flops(ctx["sizes"]) * ctx["steps"] / (ctx["window_s"] * peak)
