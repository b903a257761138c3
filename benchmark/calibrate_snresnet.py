"""The readings ``cifar10_snresnet.train``'s limits are set from, on the card
at the cell's size: ``calibrate.py``'s readings, on the SN-ResNet kind
(``kinds/train_snresnet.py``), with this configuration's planted faults.

    python benchmark/calibrate_snresnet.py --workload cifar10_snresnet.train --seeds 101,102,... \\
        --control-seeds 101,102,103 --fault-seeds 101,102,103

The control is the plain reference in TF32 (``calibrate.py``'s). The
faults, each planted in the program: ``frozen_u``, D's power-iteration
vectors never advanced (D's update returns the u it was given), and
``class0_cbn``, every row of the class-conditional batch norms given
class 0's γ and β. Prints one JSON line a reading, then one of each
number's lower reading (the largest of the sound runs) and upper readings
(the smallest of the control's, and of each fault's).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


@contextlib.contextmanager
def frozen_u():
    """The program's spectrally normalised D keeps the u it was given."""
    from triplegan_tpu_torch.nn.networks import SNResNetDiscriminator

    orig = SNResNetDiscriminator.apply

    def apply(self, params, stats, *args, **kwargs):
        return orig(self, params, stats, *args, **kwargs)[0], stats

    SNResNetDiscriminator.apply = apply
    try:
        yield
    finally:
        SNResNetDiscriminator.apply = orig


@contextlib.contextmanager
def class0_cbn():
    """The program's class-conditional batch norms read class 0's row of γ
    and β for every sample."""
    from triplegan_tpu_torch.nn import layers

    orig = layers.cond_batchnorm_act_apply
    layers.cond_batchnorm_act_apply = lambda p, s, x, y, **kw: orig(p, s, x, y * 0, **kw)
    try:
        yield
    finally:
        layers.cond_batchnorm_act_apply = orig


FAULTS = {"fault_frozen_u": frozen_u, "fault_class0_cbn": class0_cbn}


@functools.lru_cache(maxsize=None)
def kind():
    import harness

    return harness.load_module(os.path.join(HERE, "kinds", "train_snresnet.py"), "benchmark_kind_train_snresnet")


def train_readings(cell, seed: int, dev, control: bool, fault: bool):
    import compare
    from calibrate import _free

    k = kind()
    ins = k.make_inputs(cell, seed, dev)
    lr_d = float(cell.sizes["lr_d"])

    def program():
        state, call = k.build(cell, seed, dev, ins)
        _, got = k.first_calls(call, state, ins)
        del state, call
        _free()
        return got

    prog = program()
    ref = k.reference_readings(cell, seed, ins)
    out = [("program", compare.train_numbers(prog, ref, ins.p0, lr_d))]
    if control:
        ctl = k.reference_readings(cell, seed, ins, tf32=True)
        out.append(("control_tf32", compare.train_numbers(ctl, ref, ins.p0, lr_d)))
    if fault:
        for what, plant in FAULTS.items():
            with plant():
                bad = program()
            out.append((what, compare.train_numbers(bad, ref, ins.p0, lr_d)))
    return out


def main(argv=None) -> int:
    sys.path.insert(0, HERE)
    import run

    run.paths()
    run._cache_dirs()
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    import harness
    from triplegan_tpu_torch.utils.cache import enable_build_cache
    from triplegan_tpu_torch.utils.platform import resolve_device

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    enable_build_cache(os.path.join(run.CACHE, "build"))
    cell = harness.load_cell(run.ROOT, args.workload)
    dev = resolve_device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    flt = {int(s) for s in args.fault_seeds.split(",") if s}
    table = {}
    for seed in sorted(set(seeds) | ctl | flt):
        rows = train_readings(cell, seed, dev, seed in ctl, seed in flt)
        if seed not in seeds:
            rows = rows[1:]
        for what, (numbers, where) in rows:
            print(json.dumps({"seed": seed, "what": what, "numbers": numbers, "where": where}), flush=True)
            for n, v in numbers.items():
                table.setdefault(what, {}).setdefault(n, []).append(v)
    summary = {"workload": args.workload, "card": torch.cuda.get_device_name(0)}
    for what, nums in table.items():
        pick = max if what == "program" else min
        summary[what] = {n: pick(v) for n, v in nums.items()}
        summary[what + "_seeds"] = len(next(iter(nums.values())))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
