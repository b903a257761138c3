"""On-device input transforms of the train and eval paths: rescale, random
translate and flip, ZCA. Mirrors ``triplegan_tpu/data/ondevice.py``.

Randomness comes from an explicit ``torch.Generator`` on the tensor's
device. The crop of ``translate_at`` is one gather whose source indices
already fold in the padding (reflect or zeros), so no padded copy is made;
it selects exactly what JAX's pad-then-crop selects.
"""

from __future__ import annotations

from typing import Optional

import torch

from triplegan_tpu_torch.data.zca import apply_zca


def rescale(x_uint8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [0,255] → dtype [-1, 1]."""
    return x_uint8.to(dtype) / 127.5 - 1.0


def random_flip(gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Per-example random horizontal flip, probability 1/2. x: (N, H, W, C)."""
    flip = torch.rand(x.shape[0], generator=gen, device=x.device) < 0.5
    return torch.where(flip[:, None, None, None], x.flip(2), x)


def random_translate(gen: torch.Generator, x: torch.Tensor, radius: int,
                     pad_mode: str = "reflect") -> torch.Tensor:
    """Per-example random translate by up to ±radius px (pad + crop)."""
    if radius <= 0:
        return x
    n = x.shape[0]
    off_y = torch.randint(0, 2 * radius + 1, (n,), generator=gen, device=x.device)
    off_x = torch.randint(0, 2 * radius + 1, (n,), generator=gen, device=x.device)
    return translate_at(x, off_y, off_x, radius, pad_mode)


def _source(off: torch.Tensor, size: int, radius: int, reflect: bool):
    """(N, size) source index along one axis of the crop at ``off`` of the
    ``radius``-padded axis, and where it falls inside the image. Reflect
    mirrors about the edge pixel (numpy/jnp ``mode="reflect"``)."""
    idx = off[:, None] - radius + torch.arange(size, device=off.device)[None, :]
    inside = (idx >= 0) & (idx < size)
    if reflect:
        idx = torch.where(idx < 0, -idx, idx)
        idx = torch.where(idx >= size, 2 * (size - 1) - idx, idx)
    return idx.clamp(0, size - 1), inside


def translate_at(x: torch.Tensor, off_y: torch.Tensor, off_x: torch.Tensor, radius: int,
                 pad_mode: str = "reflect") -> torch.Tensor:
    """Crop the ``radius``-padded x at per-example offsets (each in
    [0, 2·radius]): ``out[n, h, w] = pad(x)[n, off_y[n] + h, off_x[n] + w]``."""
    if pad_mode not in ("reflect", "zeros"):
        raise ValueError(f"pad_mode must be reflect|zeros, got {pad_mode!r}")
    n, h, w, _ = x.shape
    reflect = pad_mode == "reflect"
    rows, in_r = _source(off_y, h, radius, reflect)
    cols, in_c = _source(off_x, w, radius, reflect)
    ni = torch.arange(n, device=x.device)[:, None, None]
    out = x[ni, rows[:, :, None], cols[:, None, :]]
    if not reflect:
        out = out * (in_r[:, :, None] & in_c[:, None, :])[..., None].to(x.dtype)
    return out


def standard_pipeline(
    x_uint8: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    translate: int = 0,
    flip: bool = False,
    pad_mode: str = "reflect",
    zca_mean: Optional[torch.Tensor] = None,
    zca_whiten: Optional[torch.Tensor] = None,
    train: bool = False,
    dtype=torch.float32,
    zca_first: bool = True,
    do_rescale: bool = True,
) -> torch.Tensor:
    """rescale → ZCA and augmentation in the configured order.
    ``zca_first`` (``aug_order="zca_first"``, the default) augments the
    whitened images; otherwise raw pixels are augmented, then whitened.
    Augmentation runs only with ``train`` and a generator; at eval both
    orders give the same result."""
    has_zca = zca_mean is not None and zca_whiten is not None
    if not do_rescale and has_zca:
        raise ValueError(
            "rescale=False is incompatible with zca=True: ZCA statistics are "
            "fit in [-1, 1] space"
        )
    x = rescale(x_uint8, dtype) if do_rescale else x_uint8.to(dtype)
    if has_zca and zca_first:
        x = apply_zca(x, zca_mean, zca_whiten)
    if train and generator is not None:
        if translate > 0:
            x = random_translate(generator, x, translate, pad_mode)
        if flip:
            x = random_flip(generator, x)
    if has_zca and not zca_first:
        x = apply_zca(x, zca_mean, zca_whiten)
    return x.contiguous()
