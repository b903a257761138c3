"""Dataset preparation: the port of ``triplegan_tpu/data/prepare.py``.

``prepare(name, raw_dir, out_dir)`` converts raw dataset files already on
disk, in their distribution formats (MNIST idx, CIFAR-10 python pickles,
SVHN .mat, STL-10 binaries), or data generated or bundled in-package
(digits, shapes, shapes16), into ``{out_dir}/{name}/train.npz`` and
``test.npz`` (uint8 NHWC ``images``, int32 ``labels``), plus ZCA statistics
(``zca_stats.npz``) for CIFAR-10 and shapes. The shards' arrays and the
ZCA statistics equal the JAX package's bitwise for the same raw files, so
either package trains on either's shards. The runtime data layer
(``data/datasets.py::load_dataset``) sees only the .npz files.

Downloading is a separate, opt-in step (``download=True``:
``data/download.py``).
"""

from __future__ import annotations

import gzip
import io
import os
import pickle
import struct
from typing import Tuple

import numpy as np


def _save(out_dir: str, name: str, split: str, images: np.ndarray, labels: np.ndarray):
    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    np.savez_compressed(os.path.join(d, f"{split}.npz"),
                        images=np.ascontiguousarray(images, dtype=np.uint8),
                        labels=np.asarray(labels, dtype=np.int32))


def _open_maybe_gz(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def _save_zca(images: np.ndarray, out_dir: str, name: str) -> None:
    from triplegan_tpu_torch.data.zca import fit_zca

    fit_zca(images).save(os.path.join(out_dir, name, "zca_stats.npz"))


# ---------------------------------------------------------------------------
# MNIST (idx format)
# ---------------------------------------------------------------------------


def _read_idx_images(path: str) -> np.ndarray:
    # A malformed raw file fails with the file named (a check that raises,
    # not an assert, which -O removes).
    with _open_maybe_gz(path) as f:
        header = f.read(16)
        if len(header) < 16:
            raise ValueError(f"{path}: truncated idx header ({len(header)} bytes)")
        magic, n, rows, cols = struct.unpack(">IIII", header)
        if magic != 2051:
            raise ValueError(f"{path}: bad idx image magic {magic} (want 2051)")
        data = np.frombuffer(f.read(), dtype=np.uint8)
    if data.size != n * rows * cols:
        raise ValueError(f"{path}: idx payload has {data.size} bytes, header promises "
                         f"{n}x{rows}x{cols}={n * rows * cols}")
    return data.reshape(n, rows, cols, 1)


def _read_idx_labels(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        header = f.read(8)
        if len(header) < 8:
            raise ValueError(f"{path}: truncated idx header ({len(header)} bytes)")
        magic, n = struct.unpack(">II", header)
        if magic != 2049:
            raise ValueError(f"{path}: bad idx label magic {magic} (want 2049)")
        data = np.frombuffer(f.read(), dtype=np.uint8)
    if data.size != n:
        raise ValueError(f"{path}: idx payload has {data.size} labels, header promises {n}")
    return data.astype(np.int32)


def prepare_mnist(raw_dir: str, out_dir: str) -> None:
    x_tr = _read_idx_images(os.path.join(raw_dir, "train-images-idx3-ubyte"))
    y_tr = _read_idx_labels(os.path.join(raw_dir, "train-labels-idx1-ubyte"))
    x_te = _read_idx_images(os.path.join(raw_dir, "t10k-images-idx3-ubyte"))
    y_te = _read_idx_labels(os.path.join(raw_dir, "t10k-labels-idx1-ubyte"))
    for split, x, y in (("train", x_tr, y_tr), ("test", x_te, y_te)):
        if len(x) != len(y):
            raise ValueError(f"mnist {split}: {len(x)} images but {len(y)} labels — "
                             f"mismatched idx files in {raw_dir}")
    _save(out_dir, "mnist", "train", x_tr, y_tr)
    _save(out_dir, "mnist", "test", x_te, y_te)


# ---------------------------------------------------------------------------
# CIFAR-10 (python pickle batches)
# ---------------------------------------------------------------------------


def _read_cifar_batch(path: str) -> Tuple[np.ndarray, np.ndarray]:
    # pickle.load runs code from the file: the user names these files as
    # the CIFAR-10 distribution's own batches (cifar-10-python.tar.gz).
    with open(path, "rb") as f:
        try:
            d = pickle.load(f, encoding="bytes")
        except Exception as e:
            raise ValueError(f"{path}: not a CIFAR-10 pickle batch ({e})") from e
    if not isinstance(d, dict) or b"data" not in d or b"labels" not in d:
        raise ValueError(f"{path}: CIFAR-10 batch is missing data/labels keys")
    raw = np.asarray(d[b"data"])
    if raw.ndim != 2 or raw.shape[1] != 3072:
        raise ValueError(f"{path}: CIFAR-10 rows must be 3072 bytes, got {raw.shape}")
    x = raw.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y = np.asarray(d[b"labels"], dtype=np.int32)
    if len(y) != len(x):
        raise ValueError(f"{path}: {len(x)} images but {len(y)} labels")
    return x, y


def prepare_cifar10(raw_dir: str, out_dir: str, fit_zca_stats: bool = True) -> None:
    bdir = os.path.join(raw_dir, "cifar-10-batches-py")
    if not os.path.isdir(bdir):
        bdir = raw_dir
    xs, ys = [], []
    for i in range(1, 6):
        x, y = _read_cifar_batch(os.path.join(bdir, f"data_batch_{i}"))
        xs.append(x)
        ys.append(y)
    x_tr, y_tr = np.concatenate(xs), np.concatenate(ys)
    x_te, y_te = _read_cifar_batch(os.path.join(bdir, "test_batch"))
    _save(out_dir, "cifar10", "train", x_tr, y_tr)
    _save(out_dir, "cifar10", "test", x_te, y_te)
    if fit_zca_stats:
        _save_zca(x_tr, out_dir, "cifar10")


# ---------------------------------------------------------------------------
# SVHN (.mat cropped-digits format)
# ---------------------------------------------------------------------------


def prepare_svhn(raw_dir: str, out_dir: str) -> None:
    from scipy.io import loadmat

    def read(split):
        path = os.path.join(raw_dir, f"{split}_32x32.mat")
        m = loadmat(path)
        if "X" not in m or "y" not in m:
            raise ValueError(f"{path}: SVHN .mat is missing X/y variables")
        x = m["X"].transpose(3, 0, 1, 2)  # HWCN → NHWC
        y = m["y"].reshape(-1).astype(np.int32)
        y[y == 10] = 0  # SVHN stores the digit 0 as class 10
        return x, y

    x_tr, y_tr = read("train")
    x_te, y_te = read("test")
    for split, x, y in (("train", x_tr, y_tr), ("test", x_te, y_te)):
        if len(x) != len(y):
            raise ValueError(f"svhn {split}_32x32.mat: {len(x)} images but {len(y)} labels")
    _save(out_dir, "svhn", "train", x_tr, y_tr)
    _save(out_dir, "svhn", "test", x_te, y_te)


# ---------------------------------------------------------------------------
# STL-10 (binary format)
# ---------------------------------------------------------------------------


def prepare_stl10(raw_dir: str, out_dir: str) -> None:
    bdir = os.path.join(raw_dir, "stl10_binary")
    if not os.path.isdir(bdir):
        bdir = raw_dir

    def read_images(path):
        with open(path, "rb") as f:
            data = np.frombuffer(f.read(), dtype=np.uint8)
        if data.size == 0 or data.size % (3 * 96 * 96) != 0:
            raise ValueError(f"{path}: STL-10 image file must be a multiple of "
                             f"3*96*96={3 * 96 * 96} bytes, got {data.size}")
        return data.reshape(-1, 3, 96, 96).transpose(0, 3, 2, 1)  # CWH → NHWC

    def read_labels(path):
        with open(path, "rb") as f:
            return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32) - 1  # 1..10 → 0..9

    x_tr = read_images(os.path.join(bdir, "train_X.bin"))
    y_tr = read_labels(os.path.join(bdir, "train_y.bin"))
    x_te = read_images(os.path.join(bdir, "test_X.bin"))
    y_te = read_labels(os.path.join(bdir, "test_y.bin"))
    for split, x, y in (("train", x_tr, y_tr), ("test", x_te, y_te)):
        if len(x) != len(y):
            raise ValueError(f"stl10 {split}: {len(x)} images in {split}_X.bin but "
                             f"{len(y)} labels in {split}_y.bin")
    # The unlabeled images, where present, join the train images with label -1.
    unl = os.path.join(bdir, "unlabeled_X.bin")
    if os.path.exists(unl):
        x_u = read_images(unl)
        x_tr = np.concatenate([x_tr, x_u])
        y_tr = np.concatenate([y_tr, np.full((len(x_u),), -1, np.int32)])
    _save(out_dir, "stl10", "train", x_tr, y_tr)
    _save(out_dir, "stl10", "test", x_te, y_te)


# ---------------------------------------------------------------------------
# digits (UCI optdigits, as scikit-learn bundles it; a copy ships here)
# ---------------------------------------------------------------------------


DIGITS_TEST_PER_CLASS = 50
DIGITS_SPLIT_SEED = 0
# scikit-learn's ``datasets/data/digits.csv.gz`` (1.9.0), byte for byte: the
# UCI optdigits sample (CC BY 4.0), in scikit-learn's copy (BSD-3)
DIGITS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "digits.csv.gz")
DIGITS_SHA256 = "09f66e6debdee2cd2b5ae59e0d6abbb73fc2b0e0185d2e1957e9ebb51e23aa22"


def load_digits_file(path: str = DIGITS_FILE) -> Tuple[np.ndarray, np.ndarray]:
    """(images (1797, 8, 8) float64 in 0..16, targets int) of the packaged
    digits file, read as scikit-learn's ``load_digits`` reads its copy: the
    gzip'd CSV through ``np.loadtxt``, the last column the target. Raises
    ``ValueError`` when the file's sha256 is not ``DIGITS_SHA256``."""
    import hashlib

    with open(path, "rb") as f:
        raw = f.read()
    digest = hashlib.sha256(raw).hexdigest()
    if digest != DIGITS_SHA256:
        raise ValueError(f"{path}: sha256 {digest}, want {DIGITS_SHA256} (a damaged copy of the digits file)")
    data = np.loadtxt(io.StringIO(gzip.decompress(raw).decode("utf-8")), delimiter=",")
    return data[:, :-1].reshape(-1, 8, 8), data[:, -1].astype(int)


def prepare_digits(raw_dir: str, out_dir: str) -> None:
    """The handwritten digits scikit-learn bundles (UCI optdigits): 1,797
    real 8×8 images, read from the package's own copy
    (``load_digits_file``; no scikit-learn needed). ``raw_dir`` is
    ignored. Pixels 0..16 rescale to uint8 0..255 and upsample
    nearest-neighbour to 28×28×1, so the ``mnist100`` architecture applies
    unchanged; ``DIGITS_TEST_PER_CLASS`` images of each class are held out
    (seed ``DIGITS_SPLIT_SEED``), so every run writes the same shards."""
    images, target = load_digits_file()
    x = np.round(images * (255.0 / 16.0)).astype(np.uint8)  # (1797, 8, 8)
    y = target.astype(np.int32)
    idx28 = (np.arange(28) * 8) // 28
    x = x[:, idx28][:, :, idx28][..., None]  # nearest neighbour → (N, 28, 28, 1)

    rng = np.random.RandomState(DIGITS_SPLIT_SEED)
    test_idx = []
    for c in range(10):
        cls = np.flatnonzero(y == c)
        rng.shuffle(cls)
        test_idx.append(cls[:DIGITS_TEST_PER_CLASS])
    test_idx = np.concatenate(test_idx)
    test_mask = np.zeros(len(y), bool)
    test_mask[test_idx] = True
    train_idx = np.flatnonzero(~test_mask)
    rng.shuffle(train_idx)
    _save(out_dir, "digits", "train", x[train_idx], y[train_idx])
    _save(out_dir, "digits", "test", x[test_idx], y[test_idx])


# ---------------------------------------------------------------------------
# shapes (structured synthetic, generated)
# ---------------------------------------------------------------------------


SHAPES_SEED = 0
# more train images than a 32×32×3 image has pixel values (3072), so that
# the ZCA covariance fitted at prepare time is of full rank
SHAPES_N_TRAIN = 4000
SHAPES_N_TEST = 1000


def prepare_shapes(raw_dir: str, out_dir: str, image_size: int = 32, name: str = "shapes") -> None:
    """``data/datasets.py::make_shapes`` gratings from a fixed seed: 4,000
    train and 1,000 test images, the same bytes at every call; ZCA
    statistics fitted on the train images as for CIFAR-10. ``raw_dir`` is
    ignored."""
    from triplegan_tpu_torch.data.datasets import make_shapes

    rng = np.random.RandomState(SHAPES_SEED)
    x_tr, y_tr = make_shapes(SHAPES_N_TRAIN, image_size=image_size, rng=rng)
    x_te, y_te = make_shapes(SHAPES_N_TEST, image_size=image_size, rng=rng)
    _save(out_dir, name, "train", x_tr, y_tr)
    _save(out_dir, name, "test", x_te, y_te)
    _save_zca(x_tr, out_dir, name)


def prepare_shapes16(raw_dir: str, out_dir: str) -> None:
    """``shapes`` at 16×16 (the same generator, seed and counts)."""
    prepare_shapes(raw_dir, out_dir, image_size=16, name="shapes16")


PREPARERS = {
    "mnist": prepare_mnist,
    "cifar10": prepare_cifar10,
    "svhn": prepare_svhn,
    "stl10": prepare_stl10,
    "digits": prepare_digits,
    "shapes": prepare_shapes,
    "shapes16": prepare_shapes16,
}

# the datasets whose converter reads no raw files
RAW_FREE = frozenset({"digits", "shapes", "shapes16"})


def prepare(name: str, raw_dir: str, out_dir: str, download: bool = False) -> None:
    """Convert dataset ``name`` (a key of ``PREPARERS``) from ``raw_dir``
    into shards under ``out_dir``; with ``download``, first fetch and verify
    its raw files into ``raw_dir`` (``data/download.py``)."""
    if name not in PREPARERS:
        raise KeyError(f"unknown dataset '{name}'; available: {sorted(PREPARERS)}")
    if not raw_dir and name not in RAW_FREE:
        raise ValueError(f"dataset '{name}' converts raw files on disk — pass --raw-dir "
                         f"(only {sorted(RAW_FREE)} need none)")
    if download and name not in RAW_FREE:
        from triplegan_tpu_torch.data.download import download_dataset

        download_dataset(name, raw_dir)
    PREPARERS[name](raw_dir, out_dir)
