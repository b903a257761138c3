"""ZCA whitening at serve time: load the run dir's statistics and apply them
as one matmul. Mirrors ``triplegan_tpu/data/zca.py``; fitting stays with
the JAX package (it runs once, at prepare/train time, in float64 numpy)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ZCAStats:
    """mean: (D,) and whitening matrix W: (D, D), D = H*W*C."""

    mean: np.ndarray
    whiten: np.ndarray

    @staticmethod
    def load(path: str) -> "ZCAStats":
        with np.load(path, allow_pickle=False) as z:
            return ZCAStats(mean=z["mean"], whiten=z["whiten"])


def apply_zca(x: torch.Tensor, mean: torch.Tensor, whiten: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C) in [-1,1] → whitened (N,H,W,C): ``(flat − mean) @ whiten.T``
    in x's dtype."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    white = (flat - mean.to(flat.dtype)) @ whiten.to(flat.dtype).T
    return white.reshape(x.shape)
