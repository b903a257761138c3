"""The share of the traced window in which no kernel or copy ran on the
card (the union of the trace's device records, marker kernels left out),
in %."""


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
