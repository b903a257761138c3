"""The port's host batches against the JAX package's on the CPU:
``data/pipeline.py::BatchSampler`` (its streams, bitwise against JAX's
sampler for the same seed: wraps, a stream smaller than a batch,
``skip_c_unlabeled``), ``data/native.py`` (the native gather against its
plain twin and the JAX module's, the out-of-range ``IndexError``, a build
that fails) and ``device_prefetch`` on the CPU. Its card behaviour (pinned
copies on a side stream, the consumer's stream ordered after them) is
held in ``tests/test_torch_cuda.py``."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from triplegan_tpu.data import native as jax_native  # noqa: E402
from triplegan_tpu.data.datasets import synthetic_dataset as jax_synthetic  # noqa: E402
from triplegan_tpu.data.pipeline import BatchSampler as JaxBatchSampler  # noqa: E402
from triplegan_tpu_torch.data import native  # noqa: E402
from triplegan_tpu_torch.data.datasets import synthetic_dataset  # noqa: E402
from triplegan_tpu_torch.data.pipeline import BatchSampler, device_prefetch  # noqa: E402
from triplegan_tpu_torch.ops import build  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("num_labeled,batch,skip", [
    (40, 16, False),   # the labeled stream (40) wraps every few steps, the unlabeled (90) too
    (10, 16, False),   # a labeled stream smaller than a batch: drawn with replacement
    (40, 16, True),    # share_pseudo_forward: the C stream draws no x_u
], ids=["wrap", "small_stream", "skip_c_unlabeled"])
def test_next_triple_matches_jax_bitwise(num_labeled, batch, skip):
    kw = dict(image_size=8, channels=3, num_classes=10, n_train=90, n_test=4, num_labeled=num_labeled,
              seed=1)
    ours = BatchSampler(synthetic_dataset(**kw), batch, seed=7)
    theirs = JaxBatchSampler(jax_synthetic(**kw), batch, seed=7)
    for t in range(30):
        a, b = ours.next_triple(12, 10, skip), theirs.next_triple(12, 10, skip)
        assert a.keys() == b.keys() == {"d", "g", "c"}
        for s in a:
            assert a[s].keys() == b[s].keys(), (t, s)
            for k in a[s]:
                assert a[s][k].dtype == b[s][k].dtype and a[s][k].shape == b[s][k].shape, (t, s, k)
                np.testing.assert_array_equal(a[s][k], b[s][k], err_msg=f"step {t} {s}.{k}")
    assert ("x_u" in a["c"]) == (not skip)
    it = ours.triple_iter(12, 10, skip)
    np.testing.assert_array_equal(next(it)["d"]["x_l"], theirs.next_triple(12, 10, skip)["d"]["x_l"])


@pytest.mark.parametrize("threads", [0, 1, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_native_gather_matches_the_plain_and_jax_gathers(dtype, threads):
    rng = np.random.RandomState(3)
    src = (rng.uniform(0, 255, size=(50, 4, 5, 3))).astype(dtype)
    idx = rng.randint(0, 50, size=37)  # repeats; 37 rows spread over 4 threads
    got = native.gather_rows(src, idx, n_threads=threads)
    assert native.native_available()
    assert got.dtype == src.dtype and got.shape == (37, 4, 5, 3) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, native.reference_gather_rows(src, idx))
    np.testing.assert_array_equal(got, jax_native.gather_rows(src, idx, n_threads=threads))
    assert native.gather_rows(src, idx[:0]).shape == (0, 4, 5, 3)


def test_a_gather_starts_a_thread_per_bytes_a_thread_it_moves():
    cpus = min(os.cpu_count() or 1, 8)
    assert native.default_threads(100 * 32 * 32 * 3) == 1  # a batch of 100 CIFAR images
    assert native.default_threads(0) == 1
    assert native.default_threads(3 * native.BYTES_A_THREAD) == min(cpus, 3)
    assert native.default_threads(1 << 40) == cpus


@pytest.mark.parametrize("bad", [-1, 50])
def test_gathers_raise_on_an_index_out_of_range(bad):
    src = np.zeros((50, 3), np.uint8)
    idx = np.array([0, 4, bad])
    for fn in (native.gather_rows, native.reference_gather_rows, jax_native.gather_rows):
        with pytest.raises(IndexError, match="out of bounds for axis 0 with size 50"):
            fn(src, idx)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.gather_rows(np.zeros((6, 4), np.uint8)[:, ::2], np.array([1]))


def test_a_failed_native_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("extern \"C\" void f() { this is not C++; }\n")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed .*broken\.cpp") as e:
        build.build_shared(str(src), "libbroken", ["g++", *native.CXX_FLAGS])
    assert "error" in str(e.value)
    assert not list((tmp_path / "_build").iterdir())  # no partial library left behind


def test_device_prefetch_on_the_cpu_yields_every_batch_as_tensors():
    data = synthetic_dataset(8, 3, 10, n_train=40, n_test=4, num_labeled=20, seed=0)
    want = BatchSampler(data, 8, seed=2)
    it = BatchSampler(data, 8, seed=2).triple_iter(6, 10)
    batches = (next(it) for _ in range(5))
    got = list(device_prefetch(batches, "cpu"))
    assert len(got) == 5
    for g in got:
        w = want.next_triple(6, 10)
        for s in w:
            for k in w[s]:
                assert isinstance(g[s][k], torch.Tensor) and g[s][k].device.type == "cpu"
                np.testing.assert_array_equal(g[s][k].numpy(), w[s][k])
    with pytest.raises(ValueError, match="cpu or cuda"):
        next(device_prefetch(iter([]), "meta"))
