"""Metrics logging: the port of ``triplegan_tpu/utils/logging.py``.

Scalars go to ``<run dir>/metrics.jsonl`` always, one JSON record a line
(``step``, ``time``, then the scalars), the records the JAX package writes;
and to TensorBoard when ``torch.utils.tensorboard`` imports (it needs the
``tensorboard`` package, which is optional), as do sample grids. The train
driver reads metrics to the host only at its log interval.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricsLogger:
    def __init__(self, workdir: str, use_tensorboard: bool = True):
        self._tb = None
        os.makedirs(workdir, exist_ok=True)
        self._jsonl = open(os.path.join(workdir, "metrics.jsonl"), "a", buffering=1)
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self._tb = SummaryWriter(os.path.join(workdir, "tb"))

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        for name, v in values.items():
            rec[name] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(name, float(v), int(step))
        self._jsonl.write(json.dumps(rec) + "\n")

    def image(self, step: int, name: str, image_uint8: np.ndarray) -> None:
        if self._tb is not None:
            img = image_uint8 if image_uint8.ndim == 3 else image_uint8[..., None]
            self._tb.add_image(name, img, int(step), dataformats="HWC")

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
