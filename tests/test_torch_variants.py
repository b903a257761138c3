"""The four layer variants the JAX package reads from the environment, in
the port's layers against JAX's under the same value, forward and
gradient, on the CPU (the port's kernel arm takes the kernels' plain
versions here):

* ``TRIPLEGAN_SMALLCIN=patches``: a 3×3 stride-1 conv with 9·Cin ≤ 128 is
  the patches matmul in ``conv2d_apply`` (either arm), not in the kernel
  arm's weight-norm route, which bypasses ``conv2d_apply`` in JAX too;
* ``TRIPLEGAN_DECONV=transpose``: every deconv is ``conv_transpose``;
* ``TRIPLEGAN_DROPOUT_BITS=8``: the uint8-bit mask (the bits are each
  framework's own, so the masks' values and kept shares are compared);
* ``TRIPLEGAN_MAXPOOL=reshape|maskbwd``: ties split their gradient evenly
  (bfloat16 inputs with ties).

The two read at import (DECONV, MAXPOOL) are set here on both modules'
variables as an import under the env value would set them; a fresh
interpreter shows the port reading them at import.

Tolerances: float32 outputs and gradients within 1e-5·(1 + |ref|) (float32
sums in other orders); bfloat16 outputs within two bfloat16 ulps of the
larger magnitude (each side rounds a float32 sum once, in another order),
bfloat16 conv gradients within 2⁻⁶ of the gradient's largest coordinate
(sums over the batch of bfloat16 terms, rounded in other places); the
max pools' outputs bitwise, and their gradients bitwise at float32 and
within two bfloat16 ulps at bfloat16 (g / count rounds once on each side).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from triplegan_tpu.nn import layers as JL  # noqa: E402
from triplegan_tpu_torch.nn import layers as L  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, dtype, what, grad=False):
    got = got.detach().double().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    if dtype == "float32":
        lim = 1e-5 * (1 + np.abs(want))
    elif grad:
        lim = 2.0 ** -6 * np.abs(want).max()
    else:
        mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
        lim = 2 * np.exp2(np.floor(np.log2(mag)) - 7)
    assert (err <= lim).all(), (what, float(err.max()))


def _conv_params(rng, cin, cout, weight_norm):
    v = (rng.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
    jp = {"b": (rng.normal(size=cout) * 0.1).astype(np.float32)}
    if weight_norm:
        jp.update(v=v, g=(rng.uniform(0.5, 1.5, size=cout)).astype(np.float32))
    else:
        jp["w"] = v
    tp = {k: torch.from_numpy(a.transpose(3, 2, 0, 1).copy() if a.ndim == 4 else a) for k, a in jp.items()}
    return jp, tp


def _grads(fn_t, tp, x, gy):
    xt = x.clone().requires_grad_()
    leaves = {k: t.clone().requires_grad_() for k, t in tp.items()}
    y = fn_t(leaves, xt)
    grads = torch.autograd.grad(y, [xt, *leaves.values()], gy)
    return y, dict(zip(["x", *leaves], grads))


def _jgrads(fn_j, jp, x, gy):
    y, vjp = jax.vjp(fn_j, jp, x)
    gp, gx = vjp(gy)
    return y, {"x": gx, **gp}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding,weight_norm,cin", [("SAME", False, 3), ("VALID", False, 13),
                                                     ("SAME", True, 13), ("SAME", False, 15)])
def test_smallcin_patches_conv_matches_jax(padding, weight_norm, cin, dtype, monkeypatch):
    monkeypatch.setenv("TRIPLEGAN_SMALLCIN", "patches")
    calls = []
    real = L._conv3x3_patches
    monkeypatch.setattr(L, "_conv3x3_patches", lambda *a: calls.append(1) or real(*a))
    rng = np.random.RandomState(0)
    jp, tp = _conv_params(rng, cin, 8, weight_norm)
    x = rng.normal(size=(2, 6, 7, cin)).astype(np.float32)
    ho, wo = (6, 7) if padding == "SAME" else (4, 5)
    gy = rng.normal(size=(2, ho, wo, 8)).astype(np.float32)
    jdt, tdt = _JDT[dtype], _TDT[dtype]
    want, jg = _jgrads(lambda p, xx: JL.conv2d_apply(p, xx, padding=padding), jp,
                       jnp.asarray(x, jdt), jnp.asarray(gy, jdt))
    for use_pallas in (False, True):
        got, tg = _grads(lambda p, xx: L.conv2d_apply(p, xx, padding=padding, use_pallas=use_pallas), tp,
                         torch.from_numpy(x).to(tdt), torch.from_numpy(gy).to(tdt))
        assert got.dtype == tdt
        _close(got, want, dtype, "y")
        for k, g in tg.items():
            jk = np.asarray(jnp.asarray(jg[k], jnp.float32))
            _close(g.permute(2, 3, 1, 0) if g.dim() == 4 and k != "x" else g, jk, dtype, k, grad=True)
    assert len(calls) == (2 if 9 * cin <= 128 else 0)  # one forward a route, both arms


def test_smallcin_patches_follows_jax_routes_per_arm(monkeypatch):
    """Under patches the kernel arm's weight-norm conv (D's first) convolves
    raw v and is not patched, as JAX's ``conv2d_wn_act_apply`` with
    ``use_pallas`` bypasses ``conv2d_apply``; the plain arm's is; a stride-2
    conv never is. Outputs equal JAX's in each arm."""
    monkeypatch.setenv("TRIPLEGAN_SMALLCIN", "patches")
    calls = []
    real = L._conv3x3_patches
    monkeypatch.setattr(L, "_conv3x3_patches", lambda *a: calls.append(1) or real(*a))
    rng = np.random.RandomState(1)
    jp, tp = _conv_params(rng, 13, 8, True)
    x = rng.normal(size=(2, 8, 8, 13)).astype(np.float32)
    for use_pallas, stride, patched in ((True, 1, 0), (False, 1, 1), (False, 2, 0)):
        calls.clear()
        got = L.conv2d_wn_act_apply(tp, torch.from_numpy(x), stride=stride, act="leaky_relu",
                                    use_pallas=use_pallas)
        want = JL.conv2d_wn_act_apply(jp, jnp.asarray(x), stride=stride, act="leaky_relu",
                                      use_pallas=use_pallas)
        assert len(calls) == patched, (use_pallas, stride)
        _close(got, want, "float32", (use_pallas, stride))


@pytest.mark.parametrize("k,s", [(5, 2), (3, 2), (2, 3)])
@pytest.mark.parametrize("route", ["plain", "weight_norm_kernel"])
def test_deconv_transpose_matches_jax(k, s, route, monkeypatch):
    monkeypatch.setattr(JL, "_DECONV_IMPL", "transpose")
    monkeypatch.setattr(L, "_DECONV_IMPL", "transpose")
    rng = np.random.RandomState(2)
    cin, cout = 6, 4
    jp = {"v" if route != "plain" else "w": (rng.normal(size=(k, k, cin, cout)) * 0.2).astype(np.float32),
          "b": (rng.normal(size=cout) * 0.1).astype(np.float32)}
    if route != "plain":
        jp["g"] = rng.uniform(0.5, 1.5, size=cout).astype(np.float32)
    tp = {key: torch.from_numpy(a) for key, a in jp.items()}
    x = rng.normal(size=(2, 5, 4, cin)).astype(np.float32)
    gy = rng.normal(size=(2, 5 * s, 4 * s, cout)).astype(np.float32)
    if route == "plain":
        jfn = lambda p, xx: JL.deconv2d_apply(p, xx, stride=s)  # noqa: E731
        tfn = lambda p, xx: L.deconv2d_apply(p, xx, stride=s)  # noqa: E731
    else:
        jfn = lambda p, xx: JL.deconv2d_wn_act_apply(p, xx, stride=s, act="tanh", use_pallas=True)  # noqa: E731
        tfn = lambda p, xx: L.deconv2d_wn_act_apply(p, xx, stride=s, act="tanh", use_pallas=True)  # noqa: E731
    want, jg = _jgrads(jfn, jp, jnp.asarray(x), jnp.asarray(gy))
    subpixel_calls = []
    monkeypatch.setattr(L, "_deconv2d_subpixel", lambda *a: subpixel_calls.append(1))
    got, tg = _grads(tfn, tp, torch.from_numpy(x), torch.from_numpy(gy))
    assert not subpixel_calls
    _close(got, want, "float32", "y")
    for key, g in tg.items():
        _close(g, jg[key], "float32", key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.5, 0.2, 0.001])
def test_dropout_bits8_matches_jax(rate, dtype, monkeypatch):
    monkeypatch.setenv("TRIPLEGAN_DROPOUT_BITS", "8")
    keep = 1.0 - rate
    thresh = max(int(round(keep * 256.0)), 1)
    x = torch.from_numpy(np.random.RandomState(3).uniform(0.5, 2.0, size=(64, 32, 32)).astype(np.float32))
    x = x.to(_TDT[dtype])
    got = L.dropout(torch.Generator().manual_seed(0), x.requires_grad_(), rate, train=True)
    want = JL.dropout(jax.random.PRNGKey(0), jnp.asarray(x.detach().float().numpy(), _JDT[dtype]), rate,
                      train=True)
    if thresh >= 256:
        assert got is x
        np.testing.assert_array_equal(np.asarray(want, np.float32), x.detach().float().numpy())
        return
    # kept elements are x · (256/thresh), the scale rounded to x's dtype first
    kept = (x.detach() * torch.tensor(256.0 / thresh, dtype=_TDT[dtype])).float().numpy()
    for out in (got.detach().float().numpy(), np.asarray(want, np.float32)):
        assert ((out == 0) | (out == kept)).all()
        share = float((out != 0).mean())
        sigma = np.sqrt(thresh / 256 * (1 - thresh / 256) / out.size)
        assert abs(share - thresh / 256) <= 5 * sigma, share
    (gx,) = torch.autograd.grad(got.float().sum(), x)
    scale = float(torch.tensor(256.0 / thresh, dtype=_TDT[dtype]))
    np.testing.assert_array_equal(gx.float().numpy(), np.where(got.detach().float().numpy() != 0, scale, 0.0))


def _tied(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    x = np.round(rng.normal(size=shape) * 2) / 2  # few distinct values: ties in most windows
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 6, 8, 3), (2, 5, 7, 3)], ids=["even", "odd"])
@pytest.mark.parametrize("impl", ["reshape", "maskbwd"])
def test_maxpool_variant_matches_jax(impl, shape, dtype, monkeypatch):
    monkeypatch.setattr(JL, "_MAXPOOL_IMPL", impl)
    monkeypatch.setattr(L, "_MAXPOOL_IMPL", impl)
    x = _tied(shape, dtype, 4)
    ho, wo = -(-shape[1] // 2), -(-shape[2] // 2)
    gy = np.random.RandomState(5).normal(size=(shape[0], ho, wo, shape[3])).astype(np.float32)
    jdt, tdt = _JDT[dtype], _TDT[dtype]
    want, vjp = jax.vjp(lambda xx: JL.max_pool(xx, 2, 2), jnp.asarray(x, jdt))
    (jgx,) = vjp(jnp.asarray(gy, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    got = L.max_pool(xt, 2)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(gy).to(tdt))
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want, np.float32))
    jgx = np.asarray(jgx, np.float32)
    if dtype == "float32":
        np.testing.assert_array_equal(gx.numpy(), jgx)
    else:
        _close(gx, jgx, "bfloat16", "dx")
    split = (gx.float().numpy() != 0).sum() > gy.size  # some window's gradient went to several ties
    even_split = impl == "maskbwd" or shape[1] % 2 == 0 and shape[2] % 2 == 0
    assert split == even_split


def test_import_time_variants_are_read_at_import():
    code = ("import triplegan_tpu_torch.nn.layers as L\n"
            "print(L._DECONV_IMPL, L._MAXPOOL_IMPL)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(TRIPLEGAN_DECONV="transpose", TRIPLEGAN_MAXPOOL="maskbwd")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["transpose", "maskbwd"]
