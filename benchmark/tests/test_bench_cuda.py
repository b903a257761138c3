"""On the card only (marked ``cuda``; they skip without one): the control
(the plain reference in TF32, the precision next below the float32 the
configuration states) and a planted fault fail the training cell's
limits, while sound runs of the program pass them, at the cell's widths
on a small data set. Run on the card with

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_cuda.py
"""

import pytest

import tiny  # first: it puts the benchmark's folder on sys.path
import calibrate
import harness

SEEDS = (2_147_490_001, 2_147_490_013, 2_147_490_029)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the program's conv and epilogue kernels have no CPU mode")
    return torch.device("cuda")


def _fails(numbers, limits):
    return any(numbers[n] > lim for n, lim in limits.items())


@pytest.mark.cuda
def test_the_control_and_half_a_batch_fail_the_training_cell(card, tmp_path):
    cell = harness.load_cell(tiny.make_card_root(str(tmp_path)), "small.train")
    for seed in SEEDS:
        rows = {what: numbers for what, (numbers, _) in calibrate.train_readings(cell, seed, card, True, True)}
        assert not _fails(rows["program"], cell.limits), (seed, rows["program"])
        assert _fails(rows["control_tf32"], cell.limits), (seed, rows["control_tf32"])
        assert _fails(rows["fault_half_batch"], cell.limits), (seed, rows["fault_half_batch"])
