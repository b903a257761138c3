"""triplegan_tpu_torch.ops.scale_bias_act against the JAX package's Pallas
kernel (interpreted on the CPU, as tests/test_ops.py runs it).

On the CPU the port's wrapper takes its plain version, so these tests hold
that plain version to the TPU kernel's semantics: k and b cast to x's dtype,
float32 math, the result rounded once to x's dtype. Tolerances: float32
rtol = atol = 1e-6 (the two differ only in how each library evaluates tanh
and whether it fuses the multiply-add); bfloat16 within one bfloat16 ulp
(the float32 results before rounding may straddle a rounding boundary).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from triplegan_tpu.ops.pallas_fused import scale_bias_act as jax_scale_bias_act  # noqa: E402
from triplegan_tpu_torch.ops import build  # noqa: E402
from triplegan_tpu_torch.ops import scale_bias_act as sba  # noqa: E402

torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """Spacing of bfloat16 (8 significant bits) at |v|."""
    mag = np.maximum(np.abs(v.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def assert_close(got: np.ndarray, want: np.ndarray, dtype: str):
    got = got.astype(np.float32)
    want = want.astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        err = np.abs(got.astype(np.float64) - want)
        lim = bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(err <= lim), f"max excess over 1 ulp: {np.max(err - lim)}"


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32) * 2.0
    k = (rng.normal(size=(c,)) * 0.5 + 1.0).astype(np.float32)
    b = (rng.normal(size=(c,)) * 0.3).astype(np.float32)
    return x, k, b


def _run_both(x, k, b, act, slope, dtype):
    jdt, tdt = _DT[dtype]
    want = jax_scale_bias_act(
        jnp.asarray(x).astype(jdt), jnp.asarray(k), jnp.asarray(b), act, slope, True
    )
    got = sba.scale_bias_act(torch.from_numpy(x).to(tdt), torch.from_numpy(k),
                             torch.from_numpy(b), act, slope)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


# (4, 6, 6, 16): 144 rows; (5, 17, 13, 24): 1105 rows, more than one
# 1024-row Pallas block and not a multiple of it.
@pytest.mark.parametrize("shape", [(4, 6, 6, 16), (5, 17, 13, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["linear", "relu", "leaky_relu", "tanh"])
def test_plain_matches_jax_kernel(act, dtype, shape):
    x, k, b = _inputs(shape)
    got, want = _run_both(x, k, b, act, 0.1, dtype)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slope", [0.1, 0.2])
def test_leaky_relu_slopes_and_odd_channels(slope, dtype):
    # C = 3 (the Generator's RGB output) and a row count that is not a
    # multiple of anything the kernel vectorizes over.
    x, k, b = _inputs((3, 7, 11, 3), seed=1)
    got, want = _run_both(x, k, b, "leaky_relu", slope, dtype)
    assert_close(got, want, dtype)


def test_leaky_relu_keeps_zero_side():
    # z >= 0 keeps z (JAX's test); at z = 0 both branches give 0, so check
    # the sign of the slope branch on exact negatives and positives.
    x = torch.tensor([[-2.0, 0.0, 3.0]])
    y = sba.scale_bias_act(x, torch.ones(3), torch.zeros(3), "leaky_relu", 0.25)
    assert y.tolist() == [[-0.5, 0.0, 3.0]]


def test_cpu_call_does_not_count_or_build(monkeypatch):
    def no_nvcc():
        raise AssertionError("a CPU call must not build the kernel")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    before = sba.launches.copy()
    x, k, b = _inputs((2, 4, 4, 8))
    sba.scale_bias_act(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b), "relu")
    assert sba.launches == before
    assert "scale_bias_act" not in build._loaded


def test_kernel_source_ships_and_import_builds_nothing():
    import os
    import subprocess
    import sys

    assert os.path.isfile(build.source_path("scale_bias_act"))
    # A fresh interpreter with no nvcc anywhere on PATH imports the module.
    code = (
        "import triplegan_tpu_torch.ops.scale_bias_act as m, "
        "triplegan_tpu_torch.ops.build as b; assert not b._loaded; print('ok')"
    )
    env = dict(os.environ, PATH=os.path.dirname(sys.executable))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_wrapper_rejects_what_it_cannot_take():
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="unknown act"):
        sba.scale_bias_act(x, torch.ones(3), torch.zeros(3), "gelu")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sba.scale_bias_act(x.to("meta"), torch.ones(3), torch.zeros(3), "relu")
