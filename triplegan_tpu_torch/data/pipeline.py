"""Host-side batches: the port of ``triplegan_tpu/data/pipeline.py``'s
``BatchSampler``, so far its test stream.

The training batches are drawn on the device by the train step itself
(``train/step.py::make_device_train_step``); the host streams of the JAX
sampler (its epoch shuffles, ``next_triple``, ``device_prefetch``) are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from triplegan_tpu_torch.data.datasets import SemiSupervisedData


class BatchSampler:
    """Batches of a ``SemiSupervisedData`` drawn on the host: so far the
    fixed-shape test batches of the JAX sampler."""

    def __init__(self, data: SemiSupervisedData, batch_size: int):
        self.data = data
        self.batch_size = batch_size

    def test_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """The test set in order, in batches of one shape: the last one is
        padded with copies of the last image and label, and ``mask`` marks
        the real rows (1.0) from the padding (0.0)."""
        b = self.batch_size
        x, y = self.data.x_test, self.data.y_test
        for start in range(0, len(x), b):
            xe, ye = x[start:start + b], y[start:start + b]
            valid = len(xe)
            if valid < b:
                pad = b - valid
                xe = np.concatenate([xe, np.repeat(xe[-1:], pad, axis=0)])
                ye = np.concatenate([ye, np.repeat(ye[-1:], pad, axis=0)])
            mask = np.zeros((b,), np.float32)
            mask[:valid] = 1.0
            yield {"x": xe, "y": ye, "mask": mask}
