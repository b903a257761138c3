"""Checksum-verified dataset downloader: the port of
``triplegan_tpu/data/download.py``.

Downloading is opt-in (``cli prepare --download``), and this module is the
only place in the port that reaches the network: each source file is
fetched only if it is missing or fails its pinned MD5, verified, and
archives are unpacked into ``raw_dir`` in the layout that
``data/prepare.py`` reads. Conversion itself never needs the network.
"""

from __future__ import annotations

import hashlib
import os
import tarfile
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Source:
    url: str
    filename: str
    md5: str
    extract: bool = False  # a tar archive to unpack after the download


MNIST_BASE = "https://ossci-datasets.s3.amazonaws.com/mnist/"

SOURCES = {
    "mnist": (
        Source(MNIST_BASE + "train-images-idx3-ubyte.gz",
               "train-images-idx3-ubyte.gz", "f68b3c2dcbeaaa9fbdd348bbdeb94873"),
        Source(MNIST_BASE + "train-labels-idx1-ubyte.gz",
               "train-labels-idx1-ubyte.gz", "d53e105ee54ea40749a09fcbcd1e9432"),
        Source(MNIST_BASE + "t10k-images-idx3-ubyte.gz",
               "t10k-images-idx3-ubyte.gz", "9fb629c4189551a2d022fa330f9573f3"),
        Source(MNIST_BASE + "t10k-labels-idx1-ubyte.gz",
               "t10k-labels-idx1-ubyte.gz", "ec29112dd5afa0611ce80d1b7f02629c"),
    ),
    "cifar10": (
        Source("https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",
               "cifar-10-python.tar.gz", "c58f30108f718f92721af3b95e74349a", extract=True),
    ),
    "svhn": (
        Source("http://ufldl.stanford.edu/housenumbers/train_32x32.mat",
               "train_32x32.mat", "e26dedcc434d2e4c54c9b2d4a06d8373"),
        Source("http://ufldl.stanford.edu/housenumbers/test_32x32.mat",
               "test_32x32.mat", "eb5a983be6a315427106f1b164d9cef3"),
    ),
    "stl10": (
        Source("http://ai.stanford.edu/~acoates/stl10/stl10_binary.tar.gz",
               "stl10_binary.tar.gz", "91f7769df0f17e558f3565bffb0c7dfb", extract=True),
    ),
}


def md5_of(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def _extracted(src: Source, raw_dir: str, sentinel: str) -> bool:
    """True when ``sentinel`` records that this archive (its MD5, line 1)
    was unpacked and every top-level member it produced (the other lines)
    still exists, so a deleted or half-removed tree is unpacked again."""
    if not os.path.exists(sentinel):
        return False
    with open(sentinel) as f:
        lines = f.read().splitlines()
    return bool(lines) and lines[0] == src.md5 and all(
        os.path.exists(os.path.join(raw_dir, m)) for m in lines[1:])


def fetch(src: Source, raw_dir: str, progress: bool = True) -> str:
    """Download one source into ``raw_dir`` unless a file there already
    has its MD5, verify the MD5, and unpack it if it is an archive; return
    the local path. The download goes to ``<file>.part``, which is removed
    on a checksum mismatch (``IOError``) and renamed into place otherwise.
    An archive is unpacked with tarfile's "data" filter, which refuses a
    member that would land outside ``raw_dir``; ``<file>.extracted``
    records the archive's MD5 and top-level members, so a verified archive
    whose tree is intact is not unpacked twice."""
    import urllib.request

    os.makedirs(raw_dir, exist_ok=True)
    path = os.path.join(raw_dir, src.filename)
    cached = os.path.exists(path) and md5_of(path) == src.md5
    if not cached:
        tmp = path + ".part"
        urllib.request.urlretrieve(src.url, tmp)
        got = md5_of(tmp)
        if got != src.md5:
            os.remove(tmp)
            raise IOError(f"checksum mismatch for {src.url}: expected {src.md5}, got {got}")
        os.replace(tmp, path)
    if src.extract:
        sentinel = path + ".extracted"
        if not (cached and _extracted(src, raw_dir, sentinel)):
            with tarfile.open(path) as tf:
                tops = sorted({m.name.split("/", 1)[0] for m in tf.getmembers()})
                tf.extractall(raw_dir, filter="data")
            with open(sentinel, "w") as f:
                f.write("\n".join([src.md5] + tops) + "\n")
    if progress and not cached:
        print(f"downloaded {src.filename} ({src.md5})")
    return path


def download_dataset(name: str, raw_dir: str) -> Tuple[str, ...]:
    """Fetch and verify every source file of ``name`` into ``raw_dir``."""
    if name not in SOURCES:
        raise KeyError(f"no download sources for '{name}'; available: {sorted(SOURCES)}")
    return tuple(fetch(s, raw_dir) for s in SOURCES[name])
