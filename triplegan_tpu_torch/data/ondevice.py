"""On-device input transforms of the eval path: rescale, then ZCA.
Mirrors ``triplegan_tpu/data/ondevice.py``; the random translate and flip
of the train path come with the training slice."""

from __future__ import annotations

from typing import Optional

import torch

from triplegan_tpu_torch.data.zca import apply_zca


def rescale(x_uint8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [0,255] → dtype [-1, 1]."""
    return x_uint8.to(dtype) / 127.5 - 1.0


def standard_pipeline(
    x_uint8: torch.Tensor,
    *,
    zca_mean: Optional[torch.Tensor] = None,
    zca_whiten: Optional[torch.Tensor] = None,
    dtype=torch.float32,
    do_rescale: bool = True,
) -> torch.Tensor:
    """The eval branch: rescale → ZCA. At eval there is no augmentation
    between the two, so both ``aug_order``s give this same result and the
    order needs no argument here."""
    has_zca = zca_mean is not None and zca_whiten is not None
    if not do_rescale and has_zca:
        raise ValueError(
            "rescale=False is incompatible with zca=True: ZCA statistics are "
            "fit in [-1, 1] space"
        )
    x = rescale(x_uint8, dtype) if do_rescale else x_uint8.to(dtype)
    if has_zca:
        x = apply_zca(x, zca_mean, zca_whiten)
    return x
