"""Class-conditional sample grids: the port of
``triplegan_tpu/eval/sample.py``. One row per class, the same z across
each column, the Generator in eval mode, the images mapped from [-1, 1]
to uint8 pixels and written as a PNG.

The PNG is written with ``zlib`` and ``struct`` alone (8-bit gray or RGB,
filter 0), so sampling needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def make_sample_fn(cfg, nets):
    """``(state, z, labels) -> images`` in [-1, 1], NHWC: the Generator in
    eval mode (its batch-norm running statistics) without autograd, on the
    device of the state's weights."""
    gen = nets[0]

    def sample(state, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        dev = next(t for arrays in state.params["gen"].values() for t in arrays.values()).device
        with torch.no_grad():
            x, _ = gen.apply(state.params["gen"], state.bn["gen"], z.to(dev), labels.to(dev),
                             train=False)
        return x

    return sample


def class_grid_inputs(cfg, n_per_class: int, seed: int = 0):
    """(z, labels) of the grid: ``n_per_class`` float32 z rows drawn from a
    CPU ``torch.Generator`` seeded with ``seed`` (so the grid is the same on
    any device; the draws are PyTorch's, not the JAX package's threefry z),
    tiled once per class; labels 0, 0, …, 1, 1, … (int64)."""
    gen = torch.Generator().manual_seed(int(seed))
    z_row = torch.randn((n_per_class, cfg.z_dim), generator=gen, dtype=torch.float32)
    z = z_row.repeat(cfg.num_classes, 1)
    labels = torch.arange(cfg.num_classes).repeat_interleave(n_per_class)
    return z, labels


def to_uint8_grid(images, n_rows: int, n_cols: int) -> np.ndarray:
    """NHWC images in [-1, 1] (a tensor on any device, or an array) → one
    (rows·H, cols·W, C) uint8 image, row r holding images r·cols … r·cols
    + cols − 1."""
    if isinstance(images, torch.Tensor):
        images = images.detach().to("cpu", torch.float32).numpy()
    x = np.asarray(images, dtype=np.float32)
    x = np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8)
    n, h, w, c = x.shape
    if n < n_rows * n_cols:
        raise ValueError(f"{n} images cannot fill a {n_rows}×{n_cols} grid")
    x = x[: n_rows * n_cols].reshape(n_rows, n_cols, h, w, c)
    return x.transpose(0, 2, 1, 3, 4).reshape(n_rows * h, n_cols * w, c)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def save_png(grid_uint8: np.ndarray, path: str) -> None:
    """Write an (H, W) or (H, W, 1) array as 8-bit grayscale, or (H, W, 3)
    as 8-bit RGB, PNG: every scanline filter 0, one zlib stream."""
    arr = np.ascontiguousarray(grid_uint8, dtype=np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        color = 0
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        color = 2
    else:
        raise ValueError(f"save_png takes gray (H, W) or RGB (H, W, 3) pixels, got {arr.shape}")
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
