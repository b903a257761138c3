"""The train-mode layers of triplegan_tpu_torch.nn.layers against their JAX
namesakes: forward values and the VJP (``jax.vjp`` against
``torch.autograd.grad`` with the same cotangent), float32, the weights
carried across by the bridge (conv kernels HWIO ↔ OIHW).

Tolerance: atol = rtol = 1e-5 for values and gradients (the same float32
math with sums in another order), except where stated: scale_bias_act at
bfloat16 holds dx within one bfloat16 ulp of each value and dk, db within
2⁻⁸ of Σ|terms| (both sides sum bfloat16 products). The dropout test is
statistical: the kept fraction within 5 standard errors of keep, and kept
values exactly x/keep. translate_at and label_concat_spatial select values,
so they must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from triplegan_tpu.data import ondevice as JD  # noqa: E402
from triplegan_tpu.nn import layers as JL  # noqa: E402
from triplegan_tpu.ops.pallas_fused import scale_bias_act as jax_sba  # noqa: E402
from triplegan_tpu_torch import bridge  # noqa: E402
from triplegan_tpu_torch.data import ondevice as TD  # noqa: E402
from triplegan_tpu_torch.data.zca import ZCAStats  # noqa: E402
from triplegan_tpu_torch.nn import layers as TL  # noqa: E402
from triplegan_tpu_torch.ops import scale_bias_act as sba  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale).astype(np.float32)


def _port(player, p):
    sd = bridge.from_jax({player: {"l": p}}, {})[player]
    return {k.split(".", 1)[1]: v.requires_grad_() for k, v in sd.items()}


def _to_jax_grad(player, name, g):
    return bridge._to_jax(player, g) if name in ("w", "v") else g.detach().numpy()


def _vjp_both(jfn, tfn, jparams, player, x, seed=11):
    """Forward and VJP of ``jfn(params, x)`` and ``tfn(port_params, x)``
    with one cotangent; returns (port out, jax out, port grads, jax grads)
    with the port's grads in JAX layouts."""
    tp = _port(player, jparams)
    tx = torch.from_numpy(x).requires_grad_()
    y_t = tfn(tp, tx)
    y_j, vjp = jax.vjp(jfn, jparams, jnp.asarray(x))
    g = _x(y_t.shape, seed)
    gp_j, gx_j = vjp(jnp.asarray(g))
    names = sorted(tp)
    grads = torch.autograd.grad(y_t, [tp[n] for n in names] + [tx], torch.from_numpy(g))
    gp_t = {n: _to_jax_grad(player, n, gr) for n, gr in zip(names, grads[:-1])}
    return y_t.detach().numpy(), np.asarray(y_j), {**gp_t, "x": grads[-1].numpy()}, \
        {**{n: np.asarray(v) for n, v in gp_j.items()}, "x": np.asarray(gx_j)}


def _assert_all(got, want, **tol):
    tol = tol or TOL
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _np(p):
    return {k: np.asarray(v) for k, v in p.items()}


def _wn_params(init, rng):
    p = _np(init)
    p["g"] = (rng.rand(*p["g"].shape) + 0.5).astype(np.float32)
    p["b"] = (rng.normal(size=p["b"].shape) * 0.3).astype(np.float32)
    return p


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
def test_batchnorm_act_train(act, use_pallas):
    rng = np.random.RandomState(0)
    c = 12
    p = {"scale": (rng.rand(c) + 0.5).astype(np.float32),
         "bias": rng.normal(size=c).astype(np.float32)}
    s = {"mean": rng.normal(size=c).astype(np.float32),
         "var": (rng.rand(c) + 0.5).astype(np.float32)}
    x = _x((4, 5, 5, c), 1, 2.0) + 0.7

    def jfn(pp, xx):
        return JL.batchnorm_act_apply(pp, s, xx, train=True, act=act, slope=0.1,
                                      use_pallas=use_pallas)[0]

    ts = {k: torch.from_numpy(v) for k, v in s.items()}

    def tfn(pp, xx):
        return TL.batchnorm_act_apply(pp, ts, xx, train=True, act=act, slope=0.1,
                                      use_pallas=use_pallas)[0]

    y_t, y_j, g_t, g_j = _vjp_both(jfn, tfn, p, "clf", x)
    np.testing.assert_allclose(y_t, y_j, **TOL)
    _assert_all(g_t, g_j, rtol=1e-4, atol=1e-4)
    # the new running stats: 0.99·old + 0.01·new, biased batch variance
    _, new_j = JL.batchnorm_act_apply(p, s, jnp.asarray(x), train=True, act=act)
    _, new_t = TL.batchnorm_act_apply({k: torch.from_numpy(v) for k, v in p.items()}, ts,
                                      torch.from_numpy(x), train=True, act=act)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new_t[k].numpy(), np.asarray(new_j[k]), **TOL)
        assert not new_t[k].requires_grad


def test_batchnorm_apply_train():
    rng = np.random.RandomState(2)
    c = 6
    p = {"scale": (rng.rand(c) + 0.5).astype(np.float32), "bias": rng.normal(size=c).astype(np.float32)}
    s = {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}
    x = _x((3, 4, 4, c), 3)
    ts = {k: torch.from_numpy(v) for k, v in s.items()}
    y_t, y_j, g_t, g_j = _vjp_both(
        lambda pp, xx: JL.batchnorm_apply(pp, s, xx, train=True)[0],
        lambda pp, xx: TL.batchnorm_apply(pp, ts, xx, train=True)[0], p, "clf", x)
    np.testing.assert_allclose(y_t, y_j, **TOL)
    _assert_all(g_t, g_j, rtol=1e-4, atol=1e-4)


# 8: even size, TF SAME pads (0, 1); 7: odd size, pads (1, 1).
@pytest.mark.parametrize("size", [8, 7])
def test_stride2_weightnorm_conv(size):
    rng = np.random.RandomState(4)
    p = _wn_params(JL.conv2d_init(jax.random.PRNGKey(4), 5, 6, kernel=3, weight_norm=True), rng)
    x = _x((2, size, size, 5), 5)
    y_t, y_j, g_t, g_j = _vjp_both(
        lambda pp, xx: JL.conv2d_apply(pp, xx, stride=2),
        lambda pp, xx: TL.conv2d_apply(pp, xx, stride=2), p, "disc", x)
    assert y_t.shape == (2, (size + 1) // 2, (size + 1) // 2, 6)
    np.testing.assert_allclose(y_t, y_j, **TOL)
    _assert_all(g_t, g_j)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_weightnorm_conv_act(stride, use_pallas):
    rng = np.random.RandomState(6)
    p = _wn_params(JL.conv2d_init(jax.random.PRNGKey(6), 13, 8, kernel=3, weight_norm=True), rng)
    x = _x((3, 8, 8, 13), 7)
    y_t, y_j, g_t, g_j = _vjp_both(
        lambda pp, xx: JL.conv2d_wn_act_apply(pp, xx, stride=stride, act="leaky_relu",
                                              slope=0.2, use_pallas=use_pallas),
        lambda pp, xx: TL.conv2d_wn_act_apply(pp, xx, stride=stride, act="leaky_relu",
                                              slope=0.2, use_pallas=use_pallas),
        p, "disc", x)
    np.testing.assert_allclose(y_t, y_j, **TOL)
    _assert_all(g_t, g_j)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_classifier_conv_routes(padding, use_pallas):
    p = _np(JL.conv2d_init(jax.random.PRNGKey(8), 3, 16, kernel=3, use_bias=False))
    x = _x((2, 9, 9, 3), 8)
    y_t, y_j, g_t, g_j = _vjp_both(
        lambda pp, xx: JL.conv2d_apply(pp, xx, padding=padding),
        lambda pp, xx: TL.conv2d_apply(pp, xx, padding=padding, use_pallas=use_pallas),
        p, "clf", x)
    np.testing.assert_allclose(y_t, y_j, **TOL)
    _assert_all(g_t, g_j)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_deconv_and_weightnorm_deconv(use_pallas):
    rng = np.random.RandomState(9)
    p = _np(JL.deconv2d_init(jax.random.PRNGKey(9), 6, 5, kernel=5))
    p["b"] = (rng.normal(size=5) * 0.3).astype(np.float32)
    x = _x((2, 4, 4, 6), 9)
    y_t, y_j, g_t, g_j = _vjp_both(
        lambda pp, xx: JL.deconv2d_apply(pp, xx, stride=2),
        lambda pp, xx: TL.deconv2d_apply(pp, xx, stride=2, use_pallas=use_pallas),
        p, "gen", x)
    np.testing.assert_allclose(y_t, y_j, **TOL)
    _assert_all(g_t, g_j)
    pw = _wn_params(JL.deconv2d_init(jax.random.PRNGKey(10), 6, 3, kernel=5, weight_norm=True), rng)
    y_t, y_j, g_t, g_j = _vjp_both(
        lambda pp, xx: JL.deconv2d_wn_act_apply(pp, xx, stride=2, act="tanh", use_pallas=use_pallas),
        lambda pp, xx: TL.deconv2d_wn_act_apply(pp, xx, stride=2, act="tanh", use_pallas=use_pallas),
        pw, "gen", x)
    np.testing.assert_allclose(y_t, y_j, **TOL)
    _assert_all(g_t, g_j)


def test_deconv_trains_after_a_first_call_in_inference_mode():
    # Serving in the same process first builds the cached phase index under
    # inference mode; a train step's backward must still be able to save it.
    TL._phase_index.cache_clear()
    w = torch.from_numpy(_x((5, 5, 6, 4), 13))
    x = torch.from_numpy(_x((2, 4, 4, 6), 14))
    with torch.inference_mode():
        y_inf = TL.deconv2d_apply({"w": w}, x, stride=2)
    w_grad = w.clone().requires_grad_()
    y = TL.deconv2d_apply({"w": w_grad}, x, stride=2)
    (g,) = torch.autograd.grad(y.square().sum(), (w_grad,))
    torch.testing.assert_close(y.detach(), y_inf, rtol=0, atol=0)
    assert g.shape == w.shape and bool(torch.isfinite(g).all())


def test_weightnorm_dense():
    rng = np.random.RandomState(12)
    p = _wn_params(JL.dense_init(jax.random.PRNGKey(12), 20, 1, weight_norm=True), rng)
    x = _x((5, 20), 12)
    y_t, y_j, g_t, g_j = _vjp_both(JL.dense_apply, TL.dense_apply, p, "disc", x)
    np.testing.assert_allclose(y_t, y_j, **TOL)
    _assert_all(g_t, g_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["linear", "relu", "leaky_relu", "tanh"])
def test_scale_bias_act_vjp(act, dtype):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.RandomState(13)
    c = 8
    x = _x((3, 5, 4, c), 13)
    x[0, 0, 0, :] = 0.0  # z = b exactly where b = 0 below: the z >= 0 branch
    k = (rng.normal(size=c) * 0.5 + 1.0).astype(np.float32)
    b = (rng.normal(size=c) * 0.3).astype(np.float32)
    b[0] = 0.0
    g = _x(x.shape, 14)
    # callers pass k and b already in x's dtype (layers.py)
    jx, jk, jb = (jnp.asarray(a).astype(jdt) for a in (x, k, b))
    y_j, vjp = jax.vjp(lambda a, kk, bb: jax_sba(a, kk, bb, act, 0.1, True), jx, jk, jb)
    grads_j = [np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g).astype(jdt))]
    tx, tk, tb = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (x, k, b))
    y_t = sba.scale_bias_act(tx, tk, tb, act, 0.1)
    grads_t = [t.float().numpy() for t in torch.autograd.grad(y_t, (tx, tk, tb),
                                                              torch.from_numpy(g).to(tdt))]
    assert y_t.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=1e-6, atol=1e-6)
        for got, want in zip(grads_t, grads_j):
            np.testing.assert_allclose(got, want, **TOL)
    else:
        dx_t, dx_j = grads_t[0].astype(np.float64), grads_j[0].astype(np.float64)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(dx_j), 2.0 ** -126))) - 7)
        assert np.all(np.abs(dx_t - dx_j) <= ulp)
        mass = np.sum(np.abs(g * x), axis=(0, 1, 2)) + np.sum(np.abs(g), axis=(0, 1, 2))
        for got, want in zip(grads_t[1:], grads_j[1:]):
            assert np.all(np.abs(got - want) <= 2.0 ** -8 * mass)


def test_max_pool_gradient_goes_to_one_element():
    # distinct values: no ties; an odd size exercises the SAME edge window
    for size in (8, 7):
        x = np.random.RandomState(15).permutation(2 * size * size * 3).astype(np.float32)
        x = x.reshape(2, size, size, 3) / 10.0
        y_j, vjp = jax.vjp(JL.max_pool, jnp.asarray(x))
        g = _x(y_j.shape, 16)
        tx = torch.from_numpy(x).requires_grad_()
        y_t = TL.max_pool(tx)
        (gx_t,) = torch.autograd.grad(y_t, tx, torch.from_numpy(g))
        np.testing.assert_array_equal(y_t.detach().numpy(), np.asarray(y_j))
        np.testing.assert_array_equal(gx_t.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def test_label_concat_spatial_and_leaky_relu():
    x = _x((2, 3, 4, 5), 17)
    y1h = np.eye(10, dtype=np.float32)[[3, 7]]
    np.testing.assert_array_equal(
        TL.label_concat_spatial(torch.from_numpy(x), torch.from_numpy(y1h)).numpy(),
        np.asarray(JL.label_concat_spatial(jnp.asarray(x), jnp.asarray(y1h))))
    v = np.array([-2.0, -0.0, 0.0, 3.0], np.float32)
    np.testing.assert_array_equal(TL.leaky_relu(torch.from_numpy(v), 0.2).numpy(),
                                  np.asarray(JL.leaky_relu(jnp.asarray(v), 0.2)))


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_translate_at_every_offset(pad_mode):
    r = 2
    x = _x((1, 6, 5, 3), 18)
    for oy in range(2 * r + 1):
        for ox in range(2 * r + 1):
            want = JD.translate_at(jnp.asarray(x), jnp.array([oy]), jnp.array([ox]), r, pad_mode)
            got = TD.translate_at(torch.from_numpy(x), torch.tensor([oy]), torch.tensor([ox]),
                                  r, pad_mode)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{oy},{ox}")


@pytest.mark.parametrize("aug_order", ["zca_first", "augment_first"])
def test_train_pipeline_picks_a_translate_and_flip_of_each_image(aug_order):
    """Random draws differ between the frameworks, so each augmented
    example must equal one of JAX's (2r+1)²·2 candidates for it."""
    r = 2
    rng = np.random.RandomState(19)
    x_u8 = rng.randint(0, 256, size=(6, 6, 6, 3)).astype(np.uint8)
    d = 6 * 6 * 3
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.02
    zca = ZCAStats(mean=rng.normal(size=d).astype(np.float32) * 0.1,
                   whiten=np.eye(d, dtype=np.float32) + a)
    zf = aug_order == "zca_first"
    kw = dict(zca_mean=zca.mean, zca_whiten=zca.whiten)
    got = TD.standard_pipeline(torch.from_numpy(x_u8), generator=torch.Generator().manual_seed(0),
                               translate=r, flip=True, train=True, zca_first=zf,
                               **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    base = np.asarray(JD.standard_pipeline(None, jnp.asarray(x_u8), train=False,
                                           **{k: jnp.asarray(v) for k, v in kw.items()}))
    np.testing.assert_allclose(TD.standard_pipeline(
        torch.from_numpy(x_u8), **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy(),
        base, **TOL)
    pre = np.asarray(JD.rescale(jnp.asarray(x_u8)))
    if zf:
        pre = base
    seen = set()
    for i in range(6):
        found = None
        for oy in range(2 * r + 1):
            for ox in range(2 * r + 1):
                t = JD.translate_at(jnp.asarray(pre[i:i + 1]), jnp.array([oy]), jnp.array([ox]), r)
                for fl in (False, True):
                    c = t[:, :, ::-1] if fl else t
                    if not zf:
                        c = JD.apply_zca(c, jnp.asarray(zca.mean), jnp.asarray(zca.whiten))
                    if np.allclose(np.asarray(c)[0], got[i], rtol=1e-5, atol=1e-5):
                        found = (oy, ox, fl)
        assert found is not None, i
        seen.add(found)
    assert len(seen) > 1  # the draws vary across the batch


def test_dropout_statistics_and_identity():
    x = torch.full((200, 10, 10, 4), 3.0)
    gen = torch.Generator().manual_seed(0)
    for rate in (0.2, 0.5):
        keep = 1.0 - rate
        y = TL.dropout(gen, x, rate, train=True)
        kept = y != 0
        frac = float(kept.float().mean())
        se = (keep * rate / x.numel()) ** 0.5
        assert abs(frac - keep) <= 5 * se, (rate, frac)
        torch.testing.assert_close(y[kept], torch.full_like(y[kept], 3.0 / keep), rtol=0, atol=0)
    assert TL.dropout(gen, x, 0.0, train=True) is x
    assert TL.dropout(gen, x, 0.5, train=False) is x
    assert TL.dropout(None, x, 0.5, train=True) is x
    n = TL.gaussian_noise(gen, torch.zeros(100, 10, 10, 4), 0.15, train=True)
    assert abs(float(n.std()) - 0.15) < 0.01 and abs(float(n.mean())) < 0.01
    assert TL.gaussian_noise(gen, x, 0.15, train=False) is x
