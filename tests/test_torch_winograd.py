"""The port's Winograd F(2×2, 3×3) conv (``triplegan_tpu_torch/ops/winograd.py``)
against the JAX package's ``conv3x3_winograd`` and the port's direct
``reference_conv3x3``, at float32 and bfloat16, on the CPU; and its
``winograd_nopad``, the plain version of the float32 Winograd pipeline on
the card, at halo 0, 1 and 2 and odd output sizes, against the direct
``reference_conv3x3_nopad``.

Tolerances, with u = 2⁻²⁴ and M = ``winograd_magnitude(x, w)`` (the same
computation on |x|, |w| and the transforms' absolute values, which bounds
the sum of the magnitudes of the terms any rounding acts on; it also
bounds the direct conv's terms, since each of them appears in the
Winograd expansion with coefficients whose magnitudes sum to at least
one). Each output is a chain of at most 16 additions of the input
transform, Cin of the products and 16 of the output transform, n = Cin +
32, so one float32 implementation is within γ_n·M of the exact value:
- float32, port against JAX: 2·n·u·M (both within γ_n·M);
- float32, against the direct conv (9·Cin additions): (n + 9·Cin)·u·M;
- bfloat16, port against JAX: the same operations rounded at the same
  places (V and U to bfloat16, float32 sums, the output to bfloat16), so
  2·n·u·M plus one bfloat16 ulp of the larger output;
- bfloat16, against the direct conv: V and U each rounded to bfloat16
  (2⁻⁹ relative each), so 2·2⁻⁹·M + n·u·M, plus two bfloat16 ulps (each
  side rounds its output once).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from triplegan_tpu.ops.winograd import conv3x3_winograd as jax_winograd  # noqa: E402
from triplegan_tpu_torch.ops.conv3x3 import _pad_hw, reference_conv3x3, reference_conv3x3_nopad  # noqa: E402
from triplegan_tpu_torch.ops.winograd import conv3x3_winograd, winograd_magnitude, winograd_nopad  # noqa: E402

torch.set_num_threads(1)
U = 2.0 ** -24


def _bf16_ulp(v):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def _inputs(shape, cout, seed):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, shape[-1], cout)) / np.sqrt(9 * shape[-1])).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", [((2, 8, 6, 5), 7), ((1, 4, 10, 16), 3)])
def test_winograd_matches_jax_and_the_direct_conv(shape, cout, dtype):
    x, w = _inputs(shape, cout, seed=shape[-1])
    tdt = getattr(torch, dtype)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    got = conv3x3_winograd(xt, wt)
    assert got.dtype == tdt and got.shape == shape[:3] + (cout,)
    got = got.double().numpy()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want_jax = np.asarray(jax_winograd(jnp.asarray(x, jdt), jnp.asarray(w, jdt)).astype(jnp.float32),
                          np.float64)
    direct = reference_conv3x3(xt, wt).double().numpy()
    m = winograd_magnitude(xt, wt).double().numpy()
    n = shape[-1] + 32
    if dtype == "float32":
        lim_jax = 2 * n * U * m
        lim_direct = (n + 9 * shape[-1]) * U * m
    else:
        lim_jax = 2 * n * U * m + _bf16_ulp(np.maximum(np.abs(got), np.abs(want_jax)))
        lim_direct = 2 * 2.0 ** -9 * m + n * U * m + 2 * _bf16_ulp(np.maximum(np.abs(got), np.abs(direct)))
    assert np.all(np.abs(got - want_jax) <= lim_jax), float(np.abs(got - want_jax).max())
    assert np.all(np.abs(got - direct) <= lim_direct), float(np.abs(got - direct).max())


def test_odd_sizes_and_a_wrong_filter_are_refused():
    x = torch.zeros((1, 5, 4, 3))
    with pytest.raises(ValueError, match="even H and W, got 5x4"):
        conv3x3_winograd(x, torch.zeros((3, 3, 3, 2)))
    with pytest.raises(ValueError, match=r"\(3, 3, 3, Cout\) HWIO"):
        conv3x3_winograd(torch.zeros((1, 4, 4, 3)), torch.zeros((3, 3, 4, 2)))


# (N, H, W, Cin, Cout, halo): every halo; odd Ho, odd Wo and both (a last
# row or column of tiles cut to the output); the 8 -> 6 VALID forward and
# its halo-2 input gradient at the widths of C's t0 cut to a few channels;
# a 1 × 1 output (one ragged tile)
_NOPAD_SHAPES = [(2, 8, 8, 6, 5, 0), (2, 6, 6, 5, 6, 2), (1, 7, 9, 4, 3, 1), (2, 9, 6, 3, 5, 0),
                 (1, 5, 5, 7, 2, 2), (3, 8, 7, 16, 9, 1), (1, 3, 3, 5, 4, 0), (2, 4, 5, 8, 3, 2)]


@pytest.mark.parametrize("shape", _NOPAD_SHAPES)
def test_winograd_nopad_matches_the_direct_conv_at_every_halo(shape):
    """float32: within (n + 9·Cin)·u·M of the direct plain conv, the
    tolerance the pipeline on the card is held to against the same plain
    conv (each within γ_n·M of the exact sum), and within n·u·M of the
    exact sum (the direct conv in float64), so the rounding is the bound's
    and not a tile misread; the output's shape (N, H + 2·halo − 2,
    W + 2·halo − 2, Cout)."""
    n_, h, w, cin, cout, pad = shape
    x, wt = _inputs((n_, h, w, cin), cout, seed=h * w + pad)
    xt, wt_ = torch.from_numpy(x), torch.from_numpy(wt)
    got = winograd_nopad(xt, wt_, pad)
    assert got.dtype == torch.float32 and got.shape == (n_, h + 2 * pad - 2, w + 2 * pad - 2, cout)
    direct = reference_conv3x3_nopad(_pad_hw(xt, pad), wt_).double().numpy()
    exact = reference_conv3x3_nopad(_pad_hw(xt.double(), pad), wt_.double()).numpy()
    m = winograd_magnitude(xt, wt_, pad).double().numpy()
    n = cin + 32
    got = got.double().numpy()
    assert np.all(np.abs(got - direct) <= (n + 9 * cin) * U * m), float(np.abs(got - direct).max())
    assert np.all(np.abs(got - exact) <= n * U * m), float(np.abs(got - exact).max())


def test_winograd_nopad_at_halo_1_is_the_same_conv3x3_winograd():
    x, w = _inputs((2, 8, 6, 5), 7, seed=3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(winograd_nopad(xt, wt, 1), conv3x3_winograd(xt, wt))
    assert torch.equal(winograd_magnitude(xt, wt, 1), winograd_magnitude(xt, wt))


def test_winograd_nopad_refuses_a_wrong_halo_or_too_small_an_input():
    with pytest.raises(ValueError, match="halo must be 0, 1 or 2 pixels, got 3"):
        winograd_nopad(torch.zeros((1, 4, 4, 2)), torch.zeros((3, 3, 2, 2)), 3)
    with pytest.raises(ValueError, match="smaller than the 3x3 kernel"):
        winograd_nopad(torch.zeros((1, 2, 4, 2)), torch.zeros((3, 3, 2, 2)), 0)
