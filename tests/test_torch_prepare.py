"""The port's dataset preparation (``triplegan_tpu_torch/data/prepare.py``,
``cli prepare``) and downloader (``data/download.py``) against the JAX
package's, on the CPU.

Each entry of ``PREPARERS`` converts a tiny raw tree written here in its
native format (MNIST idx, gzipped or not; CIFAR-10 pickle batches; SVHN
.mat; STL-10 binaries with unlabeled images), or generates its data
(digits, shapes, shapes16): the port's shards must equal the JAX
package's bitwise, and so must the ZCA statistics, which both fit in
float64 numpy. Each dataset is prepared once per package for the whole
file. The downloader's cases fetch from ``file://`` URLs under the test's
own directory: nothing reaches the network."""

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from triplegan_tpu.data import datasets as jax_datasets  # noqa: E402
from triplegan_tpu.data import download as jax_download  # noqa: E402
from triplegan_tpu.data import prepare as jax_prepare  # noqa: E402
from triplegan_tpu_torch.data import datasets, download, prepare  # noqa: E402

torch.set_num_threads(1)


def _images(rng, n, hw, ch):
    return rng.randint(0, 256, size=(n, hw, hw, ch)).astype(np.uint8)


def _write_mnist(raw):
    rng = np.random.RandomState(1)
    os.makedirs(raw)
    for split, n in (("train", 24), ("t10k", 12)):
        x, y = _images(rng, n, 28, 1)[..., 0], rng.randint(0, 10, n).astype(np.uint8)
        img = struct.pack(">IIII", 2051, n, 28, 28) + x.tobytes()
        lab = struct.pack(">II", 2049, n) + y.tobytes()
        with gzip.open(os.path.join(raw, f"{split}-images-idx3-ubyte.gz"), "wb") as f:
            f.write(img)  # the images gzipped, the labels not: both forms are read
        with open(os.path.join(raw, f"{split}-labels-idx1-ubyte"), "wb") as f:
            f.write(lab)


def _write_cifar10(raw):
    rng = np.random.RandomState(2)
    d = os.path.join(raw, "cifar-10-batches-py")
    os.makedirs(d)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        x, y = _images(rng, 6, 32, 3), rng.randint(0, 10, 6)
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": x.transpose(0, 3, 1, 2).reshape(6, -1), b"labels": y.tolist()}, f)


def _write_svhn(raw):
    from scipy.io import savemat

    rng = np.random.RandomState(3)
    os.makedirs(raw)
    for split, n in (("train", 20), ("test", 10)):
        x, y = _images(rng, n, 32, 3), rng.randint(0, 10, n)
        savemat(os.path.join(raw, f"{split}_32x32.mat"),
                {"X": x.transpose(1, 2, 3, 0), "y": np.where(y == 0, 10, y).astype(np.uint8).reshape(-1, 1)})


def _write_stl10(raw):
    rng = np.random.RandomState(4)
    d = os.path.join(raw, "stl10_binary")
    os.makedirs(d)
    for name, n, labels in (("train", 8, True), ("test", 6, True), ("unlabeled", 5, False)):
        x = _images(rng, n, 96, 3)
        with open(os.path.join(d, f"{name}_X.bin"), "wb") as f:
            f.write(x.transpose(0, 3, 2, 1).tobytes())
        if labels:
            with open(os.path.join(d, f"{name}_y.bin"), "wb") as f:
                f.write((rng.randint(0, 10, n) + 1).astype(np.uint8).tobytes())


RAW_WRITERS = {"mnist": _write_mnist, "cifar10": _write_cifar10, "svhn": _write_svhn, "stl10": _write_stl10}
ZCA_DATASETS = ("cifar10", "shapes", "shapes16")


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """``prepared(name)``: (the port's dataset dir, the JAX package's),
    each package's ``prepare`` run once per dataset for the module."""
    done = {}

    def run(name):
        if name not in done:
            if name == "digits":
                pytest.importorskip("sklearn")
            root = tmp_path_factory.mktemp(name)
            raw = ""
            if name in RAW_WRITERS:
                raw = str(root / "raw")
                RAW_WRITERS[name](raw)
            prepare.prepare(name, raw, str(root / "port"))
            jax_prepare.prepare(name, raw, str(root / "jax"))
            done[name] = (str(root / "port" / name), str(root / "jax" / name))
        return done[name]

    return run


def _arrays(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("name", sorted(jax_prepare.PREPARERS))
def test_shards_equal_the_jax_packages_bitwise(name, prepared):
    port, jax = prepared(name)
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax))
    for split in ("train", "test"):
        got = _arrays(os.path.join(port, f"{split}.npz"))
        _assert_bitwise(got, _arrays(os.path.join(jax, f"{split}.npz")))
        assert got["images"].dtype == np.uint8 and got["images"].ndim == 4
        assert got["labels"].dtype == np.int32
    if name == "stl10":  # the unlabeled images joined the train split as label -1
        labels = _arrays(os.path.join(port, "train.npz"))["labels"]
        assert len(labels) == 13 and (labels[8:] == -1).all() and (labels[:8] >= 0).all()


@pytest.mark.parametrize("name", ZCA_DATASETS)
def test_zca_stats_equal_the_jax_packages_bitwise(name, prepared):
    port, jax = prepared(name)
    _assert_bitwise(_arrays(os.path.join(port, "zca_stats.npz")), _arrays(os.path.join(jax, "zca_stats.npz")))


@pytest.mark.parametrize("n,size", [(50, 32), (7, 16)])
def test_make_shapes_and_shapes_dataset_equal_the_jax_packages(n, size):
    x, y = datasets.make_shapes(n, image_size=size, seed=3)
    xj, yj = jax_datasets.make_shapes(n, image_size=size, seed=3)
    _assert_bitwise({"x": x, "y": y}, {"x": xj, "y": yj})
    a = datasets.shapes_dataset(image_size=size, n_train=n, n_test=5, num_labeled=10, seed=1)
    b = jax_datasets.shapes_dataset(image_size=size, n_train=n, n_test=5, num_labeled=10, seed=1)
    for k in ("x_label", "y_label", "x_unlabel", "x_test", "y_test"):
        _assert_bitwise({k: getattr(a, k)}, {k: getattr(b, k)})


def test_load_dataset_names_the_ports_own_prepare_and_that_command_works(tmp_path, capsys):
    from triplegan_tpu_torch.cli import main

    raw, data = str(tmp_path / "raw"), str(tmp_path / "data")
    _write_mnist(raw)
    with pytest.raises(FileNotFoundError) as e:
        datasets.load_dataset(data, "mnist", 20)
    msg = str(e.value)
    assert "python -m triplegan_tpu_torch.cli prepare --dataset mnist" in msg
    assert "triplegan_tpu.cli" not in msg
    main(["prepare", "--dataset", "mnist", "--raw-dir", raw, "--data-dir", data])
    assert capsys.readouterr().out.strip() == f"prepared mnist → {data}/mnist"
    got = datasets.load_dataset(data, "mnist", 20)
    assert got.x_unlabel.shape == (24, 28, 28, 1) and got.x_test.shape == (12, 28, 28, 1)


@pytest.mark.parametrize("name", ["mnist", "svhn"])
def test_chip_smoke_raw_files_load_back_as_the_images_they_were_drawn_from(name, tmp_path):
    """``chip_smoke.write_raw``'s MNIST idx and SVHN .mat files, which the
    card run converts with ``cli prepare``, through ``prepare_mnist`` /
    ``prepare_svhn`` and ``load_dataset``: the images and labels that
    ``chip_smoke.synthetic_split`` drew, bitwise (SVHN's label 10 read back
    as the digit 0)."""
    import chip_smoke

    raw, data = str(tmp_path / "raw"), str(tmp_path / "data")
    chip_smoke.write_raw(raw, name, 40, 12)
    {"mnist": prepare.prepare_mnist, "svhn": prepare.prepare_svhn}[name](raw, data)
    size, channels = chip_smoke.RAW_SHAPES[name]
    rng = np.random.RandomState(chip_smoke.SEED)
    x_tr, y_tr = chip_smoke.synthetic_split(40, size, rng, channels)
    x_te, y_te = chip_smoke.synthetic_split(12, size, rng, channels)
    assert (y_tr == 0).any() and x_tr.shape == (40, size, size, channels)
    got = datasets.load_dataset(data, name, 20)
    x_l, y_l, _ = datasets.semi_split(x_tr, y_tr, 20, 10)
    for have, want in ((got.x_unlabel, x_tr), (got.x_test, x_te), (got.y_test, y_te),
                       (got.x_label, x_l), (got.y_label, y_l)):
        assert have.dtype == want.dtype and have.shape == want.shape
        np.testing.assert_array_equal(have, want)


def test_bad_requests_and_malformed_raw_files_are_refused_by_name(tmp_path):
    with pytest.raises(KeyError, match="unknown dataset 'nope'"):
        prepare.prepare("nope", str(tmp_path), str(tmp_path))
    with pytest.raises(ValueError, match="pass --raw-dir"):
        prepare.prepare("mnist", "", str(tmp_path))
    raw = str(tmp_path / "raw")
    _write_mnist(raw)
    bad = os.path.join(raw, "t10k-labels-idx1-ubyte")
    with open(bad, "wb") as f:
        f.write(struct.pack(">II", 2049, 99) + bytes(12))
    with pytest.raises(ValueError, match="t10k-labels-idx1-ubyte: idx payload has 12 labels, header promises 99"):
        prepare.prepare("mnist", raw, str(tmp_path / "out"))
    with open(os.path.join(raw, "cifar"), "wb") as f:
        f.write(b"not a pickle")
    with pytest.raises(ValueError, match="not a CIFAR-10 pickle batch"):
        prepare._read_cifar_batch(os.path.join(raw, "cifar"))


# ---------------------------------------------------------------------------
# the downloader, on file:// URLs
# ---------------------------------------------------------------------------


def test_download_fetch_and_checksum(tmp_path):
    src_file = tmp_path / "payload.bin"
    src_file.write_bytes(b"triple-gan raw data")
    good = download.Source(f"file://{src_file}", "got.bin", download.md5_of(str(src_file)))
    raw = tmp_path / "raw"
    out = download.fetch(good, str(raw), progress=False)
    assert open(out, "rb").read() == b"triple-gan raw data"
    assert download.fetch(good, str(raw), progress=False) == out  # cached: its checksum holds
    bad = download.Source(f"file://{src_file}", "bad.bin", "0" * 32)
    with pytest.raises(IOError, match="checksum mismatch"):
        download.fetch(bad, str(raw), progress=False)
    assert sorted(os.listdir(raw)) == ["got.bin"]  # no bad.bin, no bad.bin.part


def test_download_cached_archive_still_extracts(tmp_path):
    payload = tmp_path / "inner.txt"
    payload.write_bytes(b"raw batch bytes")
    archive = tmp_path / "data.tar.gz"
    with tarfile.open(archive, "w:gz") as tf:
        tf.add(payload, arcname="extracted/inner.txt")
    raw = tmp_path / "raw"
    raw.mkdir()
    (raw / "data.tar.gz").write_bytes(archive.read_bytes())  # verified, never unpacked
    src = download.Source(f"file://{archive}", "data.tar.gz", download.md5_of(str(archive)), extract=True)
    download.fetch(src, str(raw), progress=False)
    assert (raw / "extracted" / "inner.txt").read_bytes() == b"raw batch bytes"


def test_download_rejects_path_traversal_archive(tmp_path):
    (tmp_path / "src").mkdir()
    payload = tmp_path / "src" / "evil.txt"
    payload.write_bytes(b"escape")
    archive = tmp_path / "src" / "evil.tar.gz"
    with tarfile.open(archive, "w:gz") as tf:
        tf.add(payload, arcname="../evil.txt")
    raw = tmp_path / "raw"
    src = download.Source(f"file://{archive}", "evil.tar.gz", download.md5_of(str(archive)), extract=True)
    with pytest.raises(tarfile.OutsideDestinationError):
        download.fetch(src, str(raw), progress=False)
    assert not (tmp_path / "evil.txt").exists()  # nothing landed beside raw


def test_download_registry_equals_the_jax_packages_and_covers_every_raw_dataset():
    assert download.SOURCES == {k: tuple(download.Source(**vars(s)) for s in v)
                                for k, v in jax_download.SOURCES.items()}
    assert set(download.SOURCES) == set(prepare.PREPARERS) - prepare.RAW_FREE
    assert prepare.PREPARERS.keys() == jax_prepare.PREPARERS.keys() and prepare.RAW_FREE == jax_prepare.RAW_FREE


def test_fetch_extraction_sentinel(tmp_path, monkeypatch):
    raw = tmp_path / "raw"
    raw.mkdir()
    inner = tmp_path / "payload.txt"
    inner.write_text("hello")
    archive = raw / "data.tar.gz"
    with tarfile.open(archive, "w:gz") as tf:
        tf.add(inner, arcname="payload.txt")
    src = download.Source("file:///unused", "data.tar.gz", download.md5_of(str(archive)), extract=True)
    download.fetch(src, str(raw), progress=False)  # a pre-copied archive: unpacked, sentinel written
    assert (raw / "payload.txt").exists()
    assert (raw / "data.tar.gz.extracted").read_text().splitlines() == [src.md5, "payload.txt"]
    opens = []
    real_open = download.tarfile.open
    monkeypatch.setattr(download.tarfile, "open", lambda *a, **k: (opens.append(1), real_open(*a, **k))[1])
    download.fetch(src, str(raw), progress=False)
    assert not opens  # the sentinel and the tree stand: not unpacked again
    (raw / "payload.txt").unlink()
    download.fetch(src, str(raw), progress=False)
    assert (raw / "payload.txt").exists() and opens  # a removed member: unpacked again


def test_prepare_download_fetches_then_converts(tmp_path, monkeypatch):
    """``prepare --download`` fetches each source into --raw-dir (here from
    file:// URLs) and converts what it fetched."""
    src_dir = str(tmp_path / "mirror")
    _write_mnist(src_dir)
    for name in os.listdir(src_dir):  # the mirror holds the gzipped files, as the real one does
        path = os.path.join(src_dir, name)
        if not name.endswith(".gz"):
            with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
                g.write(f.read())
            os.remove(path)
    sources = tuple(download.Source(f"file://{src_dir}/{n}", n, download.md5_of(os.path.join(src_dir, n)))
                    for n in sorted(os.listdir(src_dir)))
    monkeypatch.setitem(download.SOURCES, "mnist", sources)
    raw, data = str(tmp_path / "raw"), str(tmp_path / "data")
    prepare.prepare("mnist", raw, data, download=True)
    assert sorted(os.listdir(raw)) == sorted(os.listdir(src_dir))
    jax_prepare.prepare("mnist", raw, str(tmp_path / "jax"))
    for split in ("train", "test"):
        _assert_bitwise(_arrays(os.path.join(data, "mnist", f"{split}.npz")),
                        _arrays(os.path.join(tmp_path, "jax", "mnist", f"{split}.npz")))
