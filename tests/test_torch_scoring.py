"""The port's scoring (``eval/inception.py``, ``eval/fid.py`` and
``Classifier.apply(return_features=True)``) against the JAX package's, on
the same numpy-seeded inputs.

Tolerances: the scores rtol 1e-6 (the same float64 host arithmetic after a
float32 softmax that the two frameworks may round one ulp apart); the
classifier's features and logits float32 atol 1e-5 (the network tests'
math, four layers deep at the tiny widths); ``_as_logits`` bitwise
(numpy on both sides).
"""

import builtins
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tests.helpers import tiny_config  # noqa: E402
from tests.test_torch_networks import build_pair  # noqa: E402
from triplegan_tpu.eval import fid as jfid  # noqa: E402
from triplegan_tpu.eval import inception as jinc  # noqa: E402
from triplegan_tpu_torch.eval import fid as tfid  # noqa: E402
from triplegan_tpu_torch.eval import inception as tinc  # noqa: E402

torch.set_num_threads(1)


def _logits(n=203, k=10, seed=0, scale=3.0):
    return (np.random.RandomState(seed).normal(size=(n, k)) * scale).astype(np.float32)


@pytest.mark.parametrize("batch_size", [7, 64, 256])
@pytest.mark.parametrize("n_splits", [1, 10])
def test_inception_score_matches_jax_and_ignores_chunking(n_splits, batch_size):
    logits = _logits()
    want = jinc.inception_score(lambda x: x, jnp.asarray(logits), n_splits=n_splits, batch_size=256)
    got = tinc.inception_score(lambda x: x, torch.from_numpy(logits), n_splits=n_splits,
                               batch_size=batch_size)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_inception_score_takes_the_scorers_preferred_batch():
    seen = []

    def scorer(x):
        seen.append(x.shape[0])
        return x

    scorer.preferred_batch = 50
    tinc.inception_score(scorer, torch.from_numpy(_logits(n=120)), n_splits=2)
    assert seen == [50, 50, 20]


@pytest.mark.parametrize("batch_size", [9, 256])
def test_fid_matches_jax_and_ignores_chunking(batch_size):
    rng = np.random.RandomState(1)
    a = rng.normal(size=(150, 6)).astype(np.float32)
    b = (rng.normal(size=(120, 6)) * 1.3 + 0.4).astype(np.float32)
    mu_j, cov_j = jfid.activation_stats(lambda x: x, a)
    mu_t, cov_t = tfid.activation_stats(lambda x: x, torch.from_numpy(a), batch_size=batch_size)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-6)
    np.testing.assert_allclose(cov_t, cov_j, rtol=1e-6)
    want = jfid.fid_score(lambda x: x, a, b)
    got = tfid.fid_score(lambda x: x, torch.from_numpy(a), torch.from_numpy(b), batch_size=batch_size)
    assert got > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-6)
    mu2, cov2 = rng.normal(size=6), np.cov(rng.normal(size=(40, 6)), rowvar=False)
    np.testing.assert_allclose(tfid.frechet_distance(mu_t, cov_t, mu2, cov2),
                               jfid.frechet_distance(mu_j, cov_j, mu2, cov2), rtol=1e-6)
    assert tfid.frechet_distance(mu_t, cov_t, mu_t, cov_t) == jfid.frechet_distance(mu_j, cov_j, mu_j, cov_j)
    # one feature: the covariance is kept 2-D
    assert tfid.activation_stats(lambda x: x, torch.from_numpy(a[:, :1]))[1].shape == (1, 1)


def _probs(n=6, k=5, seed=0):
    e = np.exp(_logits(n, k, seed))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


_STREAMS = {
    "logits": [_logits(6, 5, 0), _logits(6, 5, 1)],
    "probs": [_probs(6, 5, 0), _probs(6, 5, 1)],
    # probabilities whose row sums wobble past the tight test on batch 2:
    # the hysteresis keeps the stream
    "wobbly_probs": [_probs(6, 5, 0), _probs(6, 5, 1) * np.float32(1.01)],
    # logits first, then a batch that looks like probabilities: a flip
    "logits_then_probs": [_logits(6, 5, 0), _probs(6, 5, 1)],
    # probabilities first, then clearly negative entries: a flip
    "probs_then_logits": [_probs(6, 5, 0), _logits(6, 5, 1)],
}


def _run(as_logits, stream, outputs):
    state, outs = {}, []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for arr in stream:
            try:
                outs.append(as_logits(arr.copy(), outputs, state))
            except ValueError as e:
                outs.append(("raised", str(e)))
    return outs, state


@pytest.mark.parametrize("outputs", ["auto", "logits", "probs"])
@pytest.mark.parametrize("stream", sorted(_STREAMS))
def test_as_logits_behaves_as_jax(stream, outputs):
    want, want_state = _run(jinc._as_logits, _STREAMS[stream], outputs)
    got, got_state = _run(tinc._as_logits, _STREAMS[stream], outputs)
    assert got_state == want_state
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)
    if outputs == "auto":
        flips = {"logits_then_probs", "probs_then_logits"}
        assert isinstance(got[1], tuple) == (stream in flips)


def test_as_logits_warns_once_on_probabilities():
    with pytest.warns(UserWarning, match="look like probabilities"):
        out = tinc._as_logits(_probs(), "auto", {})
    np.testing.assert_array_equal(out, np.log(np.maximum(_probs(), 1e-12)))


def test_pick_output_as_jax():
    out = {"logits": 1, "pool_3": 2}
    assert tinc._pick_output(out, None) == jinc._pick_output(out, None) == 1
    assert tinc._pick_output(out, "pool_3") == 2
    assert tinc._pick_output({"x": 5}, None) == 5
    with pytest.raises(KeyError, match="not in signature"):
        tinc._pick_output(out, "nope")
    with pytest.raises(KeyError, match="none matches"):
        tinc._pick_output({"a": 1, "b": 2}, None)


@pytest.mark.parametrize("outputs", ["logits", "auto"])
def test_npz_probe_scorer_matches_jax(outputs, tmp_path):
    rng = np.random.RandomState(3)
    path = str(tmp_path / "probe.npz")
    np.savez(path, w=rng.normal(size=(4 * 4 * 3, 7)).astype(np.float32),
             b=rng.normal(size=7).astype(np.float32))
    images = rng.uniform(-1, 1, size=(9, 4, 4, 3)).astype(np.float32)
    want = np.asarray(jinc.load_scorer(path, outputs=outputs)(jnp.asarray(images)))
    got = tinc.load_scorer(path, outputs=outputs)(torch.from_numpy(images))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        tinc.inception_score(tinc.load_scorer(path, outputs=outputs), torch.from_numpy(images), n_splits=3),
        jinc.inception_score(jinc.load_scorer(path, outputs=outputs), jnp.asarray(images), n_splits=3),
        rtol=1e-5)


def test_scorer_refusals(tmp_path):
    with pytest.raises(ValueError, match="auto\\|logits\\|probs"):
        tinc.load_scorer("x.npz", outputs="softmax")
    np.savez(str(tmp_path / "bad.npz"), v=np.zeros((2, 2)))
    with pytest.raises(KeyError, match="key 'w'"):
        tinc.load_scorer(str(tmp_path / "bad.npz"))
    (tmp_path / "model").mkdir()
    with pytest.raises(FileNotFoundError, match="saved_model.pb"):
        tinc.load_scorer(str(tmp_path / "model"))


def test_savedmodel_scorer_without_tensorflow_names_it(tmp_path, monkeypatch):
    (tmp_path / "sm").mkdir()
    (tmp_path / "sm" / "saved_model.pb").write_bytes(b"")
    real = builtins.__import__

    def no_tf(name, *args, **kwargs):
        if name == "tensorflow" or name.startswith("tensorflow."):
            raise ImportError("No module named 'tensorflow'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tf)
    with pytest.raises(ImportError, match="tensorflow"):
        tinc.load_scorer(str(tmp_path / "sm"))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_classifier_features_match_jax(use_pallas, tmp_path):
    jcfg = tiny_config()
    _, jclf, params, bn, _, tclf = build_pair(jcfg, use_pallas, tmp_path)
    x = np.random.RandomState(2).normal(size=(3, 16, 16, 3)).astype(np.float32)
    (want_logits, want_feats), _ = jclf.apply(params["clf"], bn["clf"], jnp.asarray(x), train=False,
                                              return_features=True)
    with torch.inference_mode():
        (logits, feats), _ = tclf.apply(*tclf.trees(), torch.from_numpy(x), train=False,
                                        return_features=True)
        plain, _ = tclf.apply(*tclf.trees(), torch.from_numpy(x), train=False)
    assert feats.shape == (3, jcfg.clf.tail[-1])
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), rtol=0, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=1e-5)
    torch.testing.assert_close(logits, plain, rtol=0, atol=0)
