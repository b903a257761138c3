"""The port's Winograd F(2×2, 3×3) conv (``triplegan_tpu_torch/ops/winograd.py``)
against the JAX package's ``conv3x3_winograd`` and the port's direct
``reference_conv3x3``, at float32 and bfloat16, on the CPU.

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
from triplegan_tpu_torch.ops.conv3x3 import reference_conv3x3  # noqa: E402
from triplegan_tpu_torch.ops.winograd import conv3x3_winograd, winograd_magnitude  # noqa: E402

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
