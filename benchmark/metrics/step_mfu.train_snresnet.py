"""step_mfu.train_snresnet: the model FLOPs of every step in the measured
window (``work_snresnet.step_flops``: each conv, dense and ZCA product of
the three updates with the SN-ResNet G and D, forward and backward,
nothing recomputed) over the window's seconds times the compute dtype's
peak, in %; nothing for a cell of other networks."""

import harness
import work_snresnet


def read(ctx):
    if ctx["kind"] != "train" or ctx["sizes"].get("arch") != "snresnet":
        return None
    peak = harness.peaks(ctx["device_kind"])["flops_per_s"][ctx["sizes"]["compute_dtype"]]
    return 100.0 * work_snresnet.step_flops(ctx["sizes"]) * ctx["steps"] / (ctx["window_s"] * peak)
