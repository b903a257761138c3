"""The classifier's test error: the port of
``triplegan_tpu/eval/metrics.py``."""

from __future__ import annotations

from typing import Callable, Iterable


def evaluate_error(eval_step: Callable, state, test_batches: Iterable) -> float:
    """Run ``eval_step`` (``train/step.py::make_eval_step``) over the test
    batches and return the error rate in [0, 1]. The correct and counted
    rows add up on the device; the host reads the two sums once, at the
    end. No batch (or no counted row) is an error of 1."""
    correct = count = None
    for batch in test_batches:
        out = eval_step(state, batch)
        correct = out["correct"] if correct is None else correct + out["correct"]
        count = out["count"] if count is None else count + out["count"]
    if count is None:
        return 1.0
    correct_f, count_f = float(correct), float(count)
    if count_f == 0:
        return 1.0
    return 1.0 - correct_f / count_f
