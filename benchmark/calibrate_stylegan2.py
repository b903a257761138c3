"""The readings ``cifar10_stylegan2.train``'s limits are set from, on the
card at the cell's size: ``calibrate_snresnet.py``'s readings (loaded as
its own copy), on the StyleGAN2 kind (``kinds/train_stylegan2.py``), with
this configuration's planted faults.

    python benchmark/calibrate_stylegan2.py --workload cifar10_stylegan2.train --seeds 101,102,... \\
        --control-seeds 101,102,103 --fault-seeds 101,102,103

The control is the plain reference in TF32 (``calibrate.py``'s). The
faults, each planted in the program: ``no_r1``, D's R1 update dropped
from the steps that carry it; ``no_demod``, the modulated convs'
demodulation skipped (d = 1); ``no_noise``, their noise term left out;
``mixed_mbstd``, D's stddev groups taken across the three streams of its
3B rows. Prints one JSON line a reading, then one of each number's lower
reading (the largest of the sound runs) and upper readings (the smallest
of the control's, and of each fault's).
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import harness  # noqa: E402

calibrate = harness.load_module(os.path.join(HERE, "calibrate_snresnet.py"), "benchmark_calibrate_of_stylegan2")


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def no_r1():
    """No step carries D's R1 update."""
    from triplegan_tpu_torch.train.step import TrainStep

    return _patched(TrainStep, "regularises", lambda orig: lambda self, step: False)


def no_demod():
    """The modulated convs' epilogue takes k = √2 for every sample and
    channel: no demodulation."""
    from triplegan_tpu_torch.nn import layers

    return _patched(layers, "scale_bias_act_noise",
                    lambda orig: lambda x, k, b, q, *a, **kw: orig(x, k * 0 + layers.SQRT2, b, q, *a, **kw))


def no_noise():
    """The modulated convs' epilogue takes no noise term."""
    from triplegan_tpu_torch.nn import layers

    return _patched(layers, "scale_bias_act_noise",
                    lambda orig: lambda x, k, b, q, *a, **kw: orig(x, k, b, q * 0, *a, **kw))


def mixed_mbstd():
    """D's minibatch stddev groups the 3B rows as one stream."""
    from triplegan_tpu_torch.nn import layers

    return _patched(layers, "minibatch_stddev",
                    lambda orig: lambda x, group, channels=1, streams=1: orig(x, group, channels, 1))


@functools.lru_cache(maxsize=None)
def kind():
    return harness.load_module(os.path.join(HERE, "kinds", "train_stylegan2.py"), "benchmark_kind_train_stylegan2")


calibrate.FAULTS = {"fault_no_r1": no_r1, "fault_no_demod": no_demod, "fault_no_noise": no_noise,
                    "fault_mixed_mbstd": mixed_mbstd}
calibrate.kind = kind
FAULTS, main = calibrate.FAULTS, calibrate.main

if __name__ == "__main__":
    sys.exit(main())
