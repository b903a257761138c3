"""The inputs both sides get, made on the run's device from ``--seed``:
training images and labels. Weights come from
``reference/triplegan.py::make_weights``."""

from __future__ import annotations

from typing import Dict

import torch

DATA_STREAM = 0xDA7A


def _generator(device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 0x9E3779B1 + stream) % (1 << 63))


def train_images(sz: dict, data: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``data["n_train"]`` uint8 images, the first ``data["n_labeled"]`` of
    them labeled: {"x_l", "y_l", "x_u"} on ``device``."""
    g = _generator(device, seed, DATA_STREAM)
    s, ch = sz["image_size"], sz["channels"]
    x_u = torch.randint(0, 256, (data["n_train"], s, s, ch), generator=g, device=device, dtype=torch.uint8)
    y_l = torch.randint(0, sz["num_classes"], (data["n_labeled"],), generator=g, device=device)
    return {"x_l": x_u[:data["n_labeled"]].clone(), "y_l": y_l, "x_u": x_u}

