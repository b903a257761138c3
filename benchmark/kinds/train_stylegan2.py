"""Generator of training cells on the StyleGAN2 pair: ``kinds/train.py``'s
generator, loaded as its own copy, on ``reference/triplegan_stylegan2.py``'s
weights and reference. Its first step is rounded up to the next multiple
of the R1 interval, so that the check's first step carries D's R1 update.
The weights' statistics hold G's w_avg and EMA copy, which the reference
starts from as the program's state does."""

from __future__ import annotations

import os

import harness
from reference import triplegan_stylegan2 as reference

train = harness.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "train.py"),
                            "benchmark_kind_train_of_stylegan2")
train.reference = reference
_make_inputs = train.make_inputs


def make_inputs(cell, seed: int, dev):
    """``train.make_inputs`` with the start at the first step carrying R1."""
    ins = _make_inputs(cell, seed, dev)
    k = int(cell.sizes["r1_interval"])
    ins.start = -(-ins.start // k) * k
    return ins


def reference_readings(cell, seed: int, ins, tf32: bool = False):
    """The plain reference's readings of the first ``CHECK_STEPS`` steps
    from the same weights, statistics and images (``tf32``: the control)."""
    ref_zca = reference.fit_zca(ins.data["x_u"]) if cell.sizes["zca"] else None
    return reference.train_steps(ins.p0, ins.stats0, ins.data, ref_zca, cell.sizes, seed, ins.start,
                                 train.CHECK_STEPS, tf32)


train.make_inputs = make_inputs
train.reference_readings = reference_readings
build, first_calls, run = train.build, train.first_calls, train.run
