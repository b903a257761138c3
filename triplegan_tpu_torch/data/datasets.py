"""The labeled/unlabeled split, the synthetic no-network datasets and the
loader of prepared shards: numpy copies of
``triplegan_tpu/data/datasets.py``'s ``semi_split``, ``synthetic_dataset``,
``make_shapes``, ``shapes_dataset`` and ``load_dataset`` that give the same
arrays for the same inputs."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SemiSupervisedData:
    """Host-resident dataset: uint8 NHWC images, int32 labels."""

    x_label: np.ndarray
    y_label: np.ndarray
    x_unlabel: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int


def semi_split(images: np.ndarray, labels: np.ndarray, num_labeled: int, num_classes: int,
               seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Class-balanced labeled subset (num_labeled / num_classes per class,
    shuffled) and the whole training set as the unlabeled pool."""
    rng = np.random.RandomState(seed)
    per_class = num_labeled // num_classes
    idx_label = []
    for c in range(num_classes):
        cls_idx = np.flatnonzero(labels == c)
        rng.shuffle(cls_idx)
        idx_label.append(cls_idx[:per_class])
    idx_label = np.concatenate(idx_label)
    rng.shuffle(idx_label)
    return images[idx_label], labels[idx_label], images


def synthetic_dataset(image_size: int = 32, channels: int = 3, num_classes: int = 10,
                      n_train: int = 256, n_test: int = 128, num_labeled: int = 64,
                      seed: int = 0) -> SemiSupervisedData:
    """Class-dependent noisy blobs (mean shifted per class), so a
    classifier can learn; no network and no real data needed."""
    rng = np.random.RandomState(seed)

    def make(n):
        y = rng.randint(0, num_classes, size=n).astype(np.int32)
        base = (y[:, None, None, None].astype(np.float32) + 1.0) * (255.0 / (num_classes + 1))
        x = base + rng.normal(0, 24.0, size=(n, image_size, image_size, channels))
        return np.clip(x, 0, 255).astype(np.uint8), y

    x_tr, y_tr = make(n_train)
    x_te, y_te = make(n_test)
    x_l, y_l, x_u = semi_split(x_tr, y_tr, num_labeled, num_classes, seed)
    return SemiSupervisedData(x_l, y_l, x_u, x_te, y_te, num_classes)


def make_shapes(n: int, image_size: int = 32, channels: int = 3, num_classes: int = 10,
                amplitude: float = 60.0, noise_std: float = 20.0,
                rng: Optional[np.random.RandomState] = None,
                seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Structured synthetic images: class c is a cosine grating, vertical
    stripes for even c and horizontal for odd, at 2 + c // 2 cycles per
    image, with a uniform random phase per sample (the same in every
    channel) and Gaussian pixel noise per channel (SNR = amplitude /
    (noise_std·√2)). Every class has the same mean brightness, so a
    classifier must learn oriented frequency filters; a translation moves
    the phase and a horizontal flip maps it to its negative, both within
    the class. ``rng`` (else ``RandomState(seed)``) is drawn from in the JAX
    function's order: labels, phases, noise."""
    if rng is None:
        rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    orient = y % 2
    freq = 2.0 + (y // 2).astype(np.float64)
    phase = rng.uniform(0.0, 1.0, size=n)
    coord = np.arange(image_size, dtype=np.float64) / image_size
    prof = np.cos(2.0 * np.pi * (freq[:, None] * coord[None, :] + phase[:, None]))  # (n, image_size)
    img = np.where((orient == 0)[:, None, None], prof[:, None, :], prof[:, :, None]) * amplitude + 127.5
    img = img[..., None] + rng.normal(0.0, noise_std, size=(n, image_size, image_size, channels))
    return np.clip(img, 0, 255).astype(np.uint8), y


def shapes_dataset(image_size: int = 32, channels: int = 3, num_classes: int = 10,
                   n_train: int = 2000, n_test: int = 500, num_labeled: int = 200, seed: int = 0,
                   amplitude: float = 60.0, noise_std: float = 20.0) -> SemiSupervisedData:
    """``make_shapes`` as a ``SemiSupervisedData``: train and test drawn
    from one stream, so they are disjoint draws."""
    rng = np.random.RandomState(seed)
    x_tr, y_tr = make_shapes(n_train, image_size, channels, num_classes, amplitude, noise_std, rng)
    x_te, y_te = make_shapes(n_test, image_size, channels, num_classes, amplitude, noise_std, rng)
    x_l, y_l, x_u = semi_split(x_tr, y_tr, num_labeled, num_classes, seed)
    return SemiSupervisedData(x_l, y_l, x_u, x_te, y_te, num_classes)


def load_dataset(data_dir: str, dataset: str, num_labeled: int, num_classes: int = 10,
                 seed: int = 0) -> SemiSupervisedData:
    """Read the prepared shards ``{data_dir}/{dataset}/train.npz`` and
    ``test.npz`` (uint8 NHWC ``images``, integer ``labels``), as
    ``data/prepare.py`` (or the JAX package's) writes them, and split them
    with ``semi_split``: the same arrays as the JAX package's
    ``load_dataset``."""
    ddir = os.path.join(data_dir, dataset)
    if not os.path.exists(os.path.join(ddir, "train.npz")):
        raise FileNotFoundError(
            f"no prepared dataset at {ddir}/train.npz: run `python -m triplegan_tpu_torch.cli "
            f"prepare --dataset {dataset} --raw-dir <raw> --data-dir {data_dir}` first"
        )
    with np.load(os.path.join(ddir, "train.npz"), allow_pickle=False) as train, \
            np.load(os.path.join(ddir, "test.npz"), allow_pickle=False) as test:
        x_tr = np.ascontiguousarray(train["images"], dtype=np.uint8)
        y_tr = np.asarray(train["labels"], dtype=np.int32)
        x_te = np.ascontiguousarray(test["images"], dtype=np.uint8)
        y_te = np.asarray(test["labels"], dtype=np.int32)
    x_l, y_l, x_u = semi_split(x_tr, y_tr, num_labeled, num_classes, seed)
    return SemiSupervisedData(x_l, y_l, x_u, x_te, y_te, num_classes)
