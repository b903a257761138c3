"""call_host_ms.train: the host time the program's training call (a graph
replay of K steps) takes to return when made on an idle device, per step,
in ms. Read on calls made after the measured window: in the window a call
also waits for room in the launch queue, which this leaves out."""


def read(ctx):
    if ctx["kind"] != "train" or ctx["host_s"] is None:
        return None
    return 1e3 * ctx["host_s"] / ctx["host_steps"]
