"""The readings a cell's limits are set from, on the card at the cell's own
size: the numbers the output check compares, for sound runs of the program
on many seeds, for the control, and for planted faults.

    python benchmark/calibrate.py --workload cifar10_4k.train --seeds 101,102,... \\
        --control-seeds 101,102,103 --fault-seeds 101,102,103

The control is the plain reference put in the program's place and computed
in TF32, the precision next below the float32 the configurations state
(float32 matmuls and convs with TF32 allowed: ``reference.precision``),
compared with the reference in float32 as a run compares the program. The
fault a training cell is read against here is half of the batch left out,
the mean taken over the rest (the program's sub-batch draw patched to half
the rows); a state left unchanged reads 1 on ``adam_mu`` and ``change``
and needs no run.

Prints one JSON line a reading, then one of each number's lower reading
(the largest of the sound runs) and upper readings (the smallest of the
control's, and of the fault's).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


@contextlib.contextmanager
def half_batch():
    """The program's sub-batch draw patched to half the rows a stream."""
    from triplegan_tpu_torch.train import step as step_mod

    orig = step_mod._make_batch_draw
    step_mod._make_batch_draw = lambda cfg, n_shards=1: orig(cfg, 2 * n_shards)
    try:
        yield
    finally:
        step_mod._make_batch_draw = orig


def _free():
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def train_readings(cell, seed: int, dev, control: bool, fault: bool):
    import compare
    from kinds import train

    ins = train.make_inputs(cell, seed, dev)
    lr_d = float(cell.sizes["lr_d"])
    out = []
    state, call = train.build(cell, seed, dev, ins)
    _, prog = train.first_calls(call, state, ins)
    del state, call
    _free()
    ref = train.reference_readings(cell, seed, ins)
    out.append(("program", compare.train_numbers(prog, ref, ins.p0, lr_d)))
    if control:
        ctl = train.reference_readings(cell, seed, ins, tf32=True)
        out.append(("control_tf32", compare.train_numbers(ctl, ref, ins.p0, lr_d)))
    if fault:
        with half_batch():
            state, call = train.build(cell, seed, dev, ins)
            _, bad = train.first_calls(call, state, ins)
        del state, call
        _free()
        out.append(("fault_half_batch", compare.train_numbers(bad, ref, ins.p0, lr_d)))
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
