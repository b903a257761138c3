"""Generator of training cells on the SN-ResNet pair: ``kinds/train.py``'s
generator, loaded as its own copy, on ``reference/triplegan_snresnet.py``'s
weights and reference. The weights' statistics hold D's power-iteration
vectors u, which the reference needs besides the parameters: its readings
start from the same u as the program's state."""

from __future__ import annotations

import os

import harness
from reference import triplegan_snresnet as reference

train = harness.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "train.py"),
                            "benchmark_kind_train_of_snresnet")
train.reference = reference


def reference_readings(cell, seed: int, ins, tf32: bool = False):
    """The plain reference's readings of the first ``CHECK_STEPS`` steps
    from the same weights, u and images (``tf32``: the control)."""
    ref_zca = reference.fit_zca(ins.data["x_u"]) if cell.sizes["zca"] else None
    return reference.train_steps(ins.p0, ins.stats0, ins.data, ref_zca, cell.sizes, seed, ins.start,
                                 train.CHECK_STEPS, tf32)


train.reference_readings = reference_readings
make_inputs, build, first_calls, run = train.make_inputs, train.build, train.first_calls, train.run
