"""Each serving layer of triplegan_tpu_torch.nn.layers against its JAX
function in triplegan_tpu.nn.layers, on the same inputs and the same
weights (JAX's, carried across by bridge.from_jax). float32 throughout;
tolerance atol = 1e-5 (same math, sums taken in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from triplegan_tpu.nn import layers as JL  # noqa: E402
from triplegan_tpu_torch import bridge  # noqa: E402
from triplegan_tpu_torch.nn import layers as TL  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5


def _port(player, p, s=None):
    """One JAX layer dict (plus BN stats) → the port's dict of tensors."""
    sd = bridge.from_jax({player: {"l": p}}, {player: {"l": s}} if s else {})[player]
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


def _np(p):
    return {k: np.asarray(v) for k, v in p.items()}


def _randomize(p, rng, keys=("b", "g")):
    """Nonzero biases and gains, so their paths are exercised."""
    for k in keys:
        if k in p:
            p[k] = (rng.normal(size=p[k].shape) * 0.3 + (1.0 if k == "g" else 0.0)).astype(np.float32)
    return p


def _x(shape, seed=0):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _check(got: torch.Tensor, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_dense():
    rng = np.random.RandomState(0)
    p = _randomize(_np(JL.dense_init(jax.random.PRNGKey(0), 12, 7)), rng)
    x = _x((3, 12))
    _check(TL.dense_apply(_port("clf", p), torch.from_numpy(x)), JL.dense_apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("kernel,padding", [(3, "SAME"), (3, "VALID"), (1, "SAME")])
def test_conv2d(kernel, padding):
    rng = np.random.RandomState(1)
    p = _randomize(_np(JL.conv2d_init(jax.random.PRNGKey(1), 5, 6, kernel=kernel)), rng)
    x = _x((2, 8, 8, 5), 1)
    got = TL.conv2d_apply(_port("clf", p), torch.from_numpy(x), padding=padding)
    assert got.is_contiguous()  # rows of C channels for the epilogue kernel
    _check(got, JL.conv2d_apply(p, jnp.asarray(x), padding=padding))


def test_conv2d_no_bias_as_in_classifier():
    p = _np(JL.conv2d_init(jax.random.PRNGKey(2), 4, 8, kernel=3, use_bias=False))
    x = _x((2, 6, 6, 4), 2)
    _check(TL.conv2d_apply(_port("clf", p), torch.from_numpy(x)), JL.conv2d_apply(p, jnp.asarray(x)))


# 4→8: a cifar Generator deconv; 7→14: the 28-px (mnist) Generator's.
@pytest.mark.parametrize("size", [4, 7])
def test_subpixel_deconv(size):
    rng = np.random.RandomState(3)
    p = _randomize(_np(JL.deconv2d_init(jax.random.PRNGKey(3), 6, 5, kernel=5)), rng)
    x = _x((2, size, size, 6), 3)
    want = JL.deconv2d_apply(p, jnp.asarray(x), stride=2)
    pt = _port("gen", p)
    _check(TL.deconv2d_apply(pt, torch.from_numpy(x), stride=2), want)


def test_subpixel_matches_lax_conv_transpose():
    """The subpixel deconv equals JAX's plain transposed conv, not only
    JAX's own subpixel form."""
    w = _x((5, 5, 3, 4), 4) * 0.1
    x = _x((1, 4, 4, 3), 5)
    want = jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), transpose_kernel=False,
    )
    got = TL.deconv2d_apply({"w": torch.from_numpy(w)}, torch.from_numpy(x), stride=2)
    _check(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("act,slope", [("relu", 0.1), ("leaky_relu", 0.1), ("tanh", 0.1), (None, 0.1)])
def test_batchnorm_act_eval(act, slope, use_pallas):
    rng = np.random.RandomState(6)
    c = 16
    p = {"scale": (rng.rand(c) + 0.5).astype(np.float32), "bias": rng.normal(size=c).astype(np.float32)}
    s = {"mean": rng.normal(size=c).astype(np.float32), "var": (rng.rand(c) * 2 + 0.1).astype(np.float32)}
    x = _x((3, 5, 5, c), 6)
    want, _ = JL.batchnorm_act_apply(p, s, jnp.asarray(x), train=False, act=act, slope=slope,
                                     use_pallas=use_pallas)
    pt = _port("clf", p, s)
    got, _ = TL.batchnorm_act_apply(pt, pt, torch.from_numpy(x), act=act, slope=slope,
                                    use_pallas=use_pallas)
    _check(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_weightnorm_deconv_tanh(use_pallas):
    rng = np.random.RandomState(7)
    p = _randomize(_np(JL.deconv2d_init(jax.random.PRNGKey(7), 8, 3, kernel=5, weight_norm=True)), rng)
    x = _x((2, 4, 4, 8), 7)
    want = JL.deconv2d_wn_act_apply(p, jnp.asarray(x), stride=2, act="tanh", use_pallas=use_pallas)
    got = TL.deconv2d_wn_act_apply(_port("gen", p), torch.from_numpy(x), stride=2, act="tanh",
                                   use_pallas=use_pallas)
    _check(got, want)


@pytest.mark.parametrize("size", [8, 7])
def test_max_pool_same(size):
    x = _x((2, size, size, 3), 8)
    got = TL.max_pool(torch.from_numpy(x))
    assert got.is_contiguous()
    _check(got, JL.max_pool(jnp.asarray(x)))


def test_global_avg_pool_and_onehot():
    x = _x((2, 6, 6, 4), 9)
    _check(TL.global_avg_pool(torch.from_numpy(x)), JL.global_avg_pool(jnp.asarray(x)))
    y = np.array([0, 3, 9], np.int32)
    _check(TL.onehot(torch.from_numpy(y), 10), JL.onehot(jnp.asarray(y), 10))
