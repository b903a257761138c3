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


def _bwd_inputs(shape, seed=0):
    x, k, b = _inputs(shape, seed)
    g = np.random.RandomState(seed + 100).normal(size=shape).astype(np.float32)
    return x, k, b, g


def _sum_limit(terms: np.ndarray, m: int) -> np.ndarray:
    """8·√M·2⁻²⁴·Σ|terms| per channel: two float32 sums of M terms in
    different orders."""
    return 8.0 * np.sqrt(m) * 2.0 ** -24 * np.abs(terms.astype(np.float64)).reshape(m, -1).sum(0)


# (3, 7, 11, 3): C = 3; (5, 17, 13, 24): 1105 rows, more than one 1024-row
# Pallas block and not a multiple of it; (7, 13, 11, 37): an odd C.
@pytest.mark.parametrize("shape", [(3, 7, 11, 3), (5, 17, 13, 24), (7, 13, 11, 37)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["linear", "relu", "leaky_relu", "tanh"])
def test_plain_backward_matches_jax_vjp(act, dtype, shape):
    """``reference_scale_bias_act_bwd`` against ``jax.vjp`` of the Pallas
    kernel (interpreted), with k and b in x's dtype as the layers pass them.
    Tolerances: dx float32 within 2e-6·|g|·|k| (both round each step in
    float32, but each library evaluates tanh differently and 1 − t² can
    magnify that by 2|t|); bfloat16 within 2 bfloat16 ulps (XLA on the CPU
    may keep a fused intermediate in float32; on these inputs they agree
    bitwise). dk and db: 8·√M·2⁻²⁴·Σ|terms| (float32 sums in different
    orders), plus one bfloat16 ulp of the value at bfloat16 (each rounds its
    sum once)."""
    jdt, tdt = _DT[dtype]
    x, k, b, g = _bwd_inputs(shape)
    xj, kj, bj, gj = (jnp.asarray(a).astype(jdt) for a in (x, k, b, g))
    _, vjp = jax.vjp(lambda x_, k_, b_: jax_scale_bias_act(x_, k_, b_, act, 0.1, True), xj, kj, bj)
    want = [np.asarray(a.astype(jnp.float32)) for a in vjp(gj)]
    xt, kt, bt, gt = (torch.from_numpy(a).to(tdt) for a in (x, k, b, g))
    out = sba.reference_scale_bias_act_bwd(xt, kt, bt, gt, act, 0.1)
    assert [t.dtype for t in out] == [tdt] * 3
    dx, dk, db = (t.float().numpy() for t in out)
    m = int(np.prod(shape[:-1]))
    if dtype == "float32":
        gk = np.abs(g) * np.abs(k)
        assert np.all(np.abs(dx - want[0]) <= 2e-6 * gk), np.max(np.abs(dx - want[0]) - 2e-6 * gk)
    else:
        err = np.abs(dx.astype(np.float64) - want[0])
        assert np.all(err <= 2 * bf16_ulp(np.maximum(np.abs(dx), np.abs(want[0])))), np.max(err)
    xf, gf = xt.float().numpy(), gt.float().numpy()
    for got, ref, terms in ((dk, want[1], xf * gf), (db, want[2], gf)):
        # |t| ≤ |g|·max|act'|, and act' ≤ 1 for every act here
        lim = _sum_limit(terms, m)
        if dtype == "bfloat16":
            lim = lim + bf16_ulp(np.maximum(np.abs(got), np.abs(ref)))
        assert np.all(np.abs(got.astype(np.float64) - ref) <= lim), np.max(np.abs(got - ref) - lim)


_MASKS = [(dx, dk, db) for dx in (False, True) for dk in (False, True) for db in (False, True)
          if dx or dk or db]


@pytest.mark.parametrize("needs", _MASKS, ids=["".join("xkb"[i] for i in range(3) if m[i]) for m in _MASKS])
def test_backward_computes_only_what_autograd_asks(needs):
    """Through the autograd Function on the CPU: each gradient asked for
    equals the plain backward's, and the plain backward returns None for
    the ones not asked for."""
    x, k, b, g = _bwd_inputs((2, 5, 3, 12), seed=4)
    ins = [torch.from_numpy(a).requires_grad_(n) for a, n in zip((x, k, b), needs)]
    y = sba.scale_bias_act(*ins, "tanh", 0.1)
    grads = torch.autograd.grad(y, [t for t in ins if t.requires_grad], torch.from_numpy(g))
    full = sba.reference_scale_bias_act_bwd(*(torch.from_numpy(a) for a in (x, k, b, g)), "tanh", 0.1)
    assert [f for f, n in zip(full, needs) if n] and len(grads) == sum(needs)
    for got, want in zip(grads, [f for f, n in zip(full, needs) if n]):
        assert torch.equal(got, want)
    masked = sba.reference_scale_bias_act_bwd(*(torch.from_numpy(a) for a in (x, k, b, g)), "tanh", 0.1,
                                              needs)
    assert [t is None for t in masked] == [not n for n in needs]


@pytest.mark.parametrize("act", ["linear", "relu", "leaky_relu", "tanh"])
def test_function_gradcheck_float64(act):
    x, k, b, _ = _bwd_inputs((2, 3, 3, 5), seed=5)
    ins = [torch.from_numpy(a).double().requires_grad_() for a in (x, k, b)]
    assert torch.autograd.gradcheck(lambda x_, k_, b_: sba.scale_bias_act(x_, k_, b_, act, 0.2), ins)


def test_cpu_backward_does_not_count_or_build(monkeypatch):
    def no_nvcc():
        raise AssertionError("a CPU call must not build the kernel")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    before = (sba.launches.copy(), sba.bwd_launches.copy())
    x, k, b, g = (torch.from_numpy(a).requires_grad_() for a in _bwd_inputs((2, 4, 4, 8)))
    torch.autograd.grad(sba.scale_bias_act(x, k, b, "relu"), (x, k, b), g.detach())
    assert (sba.launches, sba.bwd_launches) == before
    assert "scale_bias_act" not in build._loaded


def test_wrapper_rejects_what_it_cannot_take():
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="unknown act"):
        sba.scale_bias_act(x, torch.ones(3), torch.zeros(3), "gelu")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sba.scale_bias_act(x.to("meta"), torch.ones(3), torch.zeros(3), "relu")
