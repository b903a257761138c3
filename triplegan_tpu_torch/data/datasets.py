"""The labeled/unlabeled split, the synthetic no-network dataset and the
loader of prepared shards: numpy copies of
``triplegan_tpu/data/datasets.py``'s ``semi_split``, ``synthetic_dataset``
and ``load_dataset`` that give the same arrays for the same inputs."""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

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


def load_dataset(data_dir: str, dataset: str, num_labeled: int, num_classes: int = 10,
                 seed: int = 0) -> SemiSupervisedData:
    """Read the prepared shards ``{data_dir}/{dataset}/train.npz`` and
    ``test.npz`` (uint8 NHWC ``images``, integer ``labels``), as the JAX
    package's ``prepare`` writes them, and split them with ``semi_split``:
    the same arrays as the JAX package's ``load_dataset``."""
    ddir = os.path.join(data_dir, dataset)
    if not os.path.exists(os.path.join(ddir, "train.npz")):
        raise FileNotFoundError(
            f"no prepared dataset at {ddir}/train.npz: run `python -m triplegan_tpu.cli "
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
