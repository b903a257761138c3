"""The three networks in train mode against the JAX nets: outputs, new BN
running stats and every parameter gradient (the VJP of a fixed cotangent),
at ``train=True`` with noise and dropout at 0
(``tests/helpers.py::deterministic_config``), for both ``use_pallas`` arms
of the port (the JAX side runs its plain path), both ``label_reconcat``
settings of the Discriminator, and two sizes: the tiny 16 px test config
and a 32 px config with cifar10_4k's layer structure (3 Generator widths,
6 Discriminator convs with strides 1,2,1,2,1,2, the Classifier's two
3-conv blocks, VALID t0 and NiN tail) at a few channels.

Tolerance: rtol = atol = 2e-4 on outputs and stats, and on each gradient
relative to its largest magnitude (float32 sums in other orders through up
to 13 layers and their backward).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tests.helpers import deterministic_config  # noqa: E402
from triplegan_tpu.configs.base import make_networks as jax_make_networks  # noqa: E402
from triplegan_tpu.configs.base import save_config  # noqa: E402
from triplegan_tpu_torch import bridge  # noqa: E402
from triplegan_tpu_torch.configs import base as port_base  # noqa: E402

torch.set_num_threads(1)
TOL = 2e-4


def _cifar_cut():
    cfg = deterministic_config()
    cfg.image_size = 32
    cfg.gen.widths = (16, 8, 8)
    cfg.disc.widths = (4, 4, 8, 8, 8, 8)
    cfg.disc.strides = (1, 2, 1, 2, 1, 2)
    cfg.clf.conv_blocks = ((8, 8, 8), (8, 8, 8))
    cfg.clf.tail = (8, 8, 8)
    cfg.batch_size = 4
    return cfg


CONFIGS = {"tiny16": deterministic_config, "cifar32_cut": _cifar_cut}


def _setup(name, use_pallas, reconcat, tmp_path):
    jcfg = CONFIGS[name]()
    jcfg.disc.label_reconcat = reconcat
    path = str(tmp_path / "config.json")
    save_config(jcfg, path)
    cfg = port_base.merge_saved(port_base.base_config(), path)
    cfg.use_pallas = use_pallas
    jnets = jax_make_networks(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    inits = [net.init(k) for net, k in zip(jnets, keys)]
    rng = np.random.RandomState(1)
    params, bn = {}, {}
    for player, (p, s) in zip(("gen", "disc", "clf"), inits):
        p = jax.tree.map(np.asarray, p)
        for arrays in p.values():  # nonzero biases and non-unit gains / BN scales
            for k in [k for k in arrays if k in ("b", "bias", "g", "scale")]:
                base = 1.0 if k in ("g", "scale") else 0.0
                arrays[k] = (base + rng.normal(size=arrays[k].shape) * 0.2).astype(np.float32)
        params[player], bn[player] = p, jax.tree.map(np.asarray, s)
    tnets = port_base.make_networks(cfg)
    state = bridge.from_jax(params, bn)
    trees = {p: bridge.nested(state[p]) for p in ("gen", "disc", "clf")}
    return jcfg, jnets, params, bn, tnets, trees


def _compare(player, out_t, out_j, stats_t, stats_j, gp_t, gp_j):
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=TOL, atol=TOL)
    for layer, arrays in stats_j.items():
        for k, v in arrays.items():
            np.testing.assert_allclose(stats_t[layer][k].numpy(), np.asarray(v), rtol=TOL, atol=TOL)
    tflat = bridge.to_jax({player: bridge.flat(gp_t, {})})[0][player]
    for layer, arrays in gp_j.items():
        for k, want in arrays.items():
            want = np.asarray(want)
            got = tflat[layer][k]
            scale = float(np.max(np.abs(want))) + 1e-12
            assert np.max(np.abs(got - want)) <= TOL * max(scale, 1.0), (player, layer, k)


def _grads(tree, out, cot):
    leaves = [t for arrays in tree.values() for t in arrays.values()]
    grads = iter(torch.autograd.grad(out, leaves, torch.from_numpy(cot)))
    return {layer: {k: next(grads) for k in arrays} for layer, arrays in tree.items()}


def _with_grad(tree):
    return {layer: {k: t.clone().requires_grad_() for k, t in arrays.items()}
            for layer, arrays in tree.items()}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generator_and_classifier_train_mode(name, use_pallas, tmp_path):
    jcfg, jnets, params, bn, tnets, trees = _setup(name, use_pallas, True, tmp_path)
    rng = np.random.RandomState(2)
    n = 4
    z = rng.normal(size=(n, jcfg.z_dim)).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.int32)
    x = rng.normal(size=(n, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)

    def jgen(p):
        return jnets[0].apply(p, bn["gen"], jnp.asarray(z), jnp.asarray(y), train=True)

    out_j, vjp, st_j = jax.vjp(jgen, params["gen"], has_aux=True)
    cot = rng.normal(size=out_j.shape).astype(np.float32)
    (gp_j,) = vjp(jnp.asarray(cot))
    pg = _with_grad(trees["gen"][0])
    out_t, st_t = tnets[0].apply(pg, trees["gen"][1], torch.from_numpy(z), torch.from_numpy(y),
                                 train=True)
    _compare("gen", out_t, out_j, st_t, st_j, _grads(pg, out_t, cot), gp_j)

    def jclf(p):
        return jnets[2].apply(p, bn["clf"], jnp.asarray(x), train=True)

    out_j, vjp, st_j = jax.vjp(jclf, params["clf"], has_aux=True)
    cot = rng.normal(size=out_j.shape).astype(np.float32)
    (gp_j,) = vjp(jnp.asarray(cot))
    pc = _with_grad(trees["clf"][0])
    out_t, st_t = tnets[2].apply(pc, trees["clf"][1], torch.from_numpy(x), train=True)
    _compare("clf", out_t, out_j, st_t, st_j, _grads(pc, out_t, cot), gp_j)


@pytest.mark.parametrize("reconcat", [True, False])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_discriminator_train_mode(name, use_pallas, reconcat, tmp_path):
    jcfg, jnets, params, bn, tnets, trees = _setup(name, use_pallas, reconcat, tmp_path)
    rng = np.random.RandomState(3)
    n = 6
    x = rng.normal(size=(n, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.int32)

    def jdisc(p, xx):
        return jnets[1].apply(p, {}, xx, jnp.asarray(y), train=True)[0]

    out_j, vjp = jax.vjp(jdisc, params["disc"], jnp.asarray(x))
    cot = rng.normal(size=out_j.shape).astype(np.float32)
    gp_j, gx_j = vjp(jnp.asarray(cot))
    pd = _with_grad(trees["disc"][0])
    tx = torch.from_numpy(x).requires_grad_()
    out_t, _ = tnets[1].apply(pd, {}, tx, torch.from_numpy(y), train=True)
    leaves = [t for arrays in pd.values() for t in arrays.values()]
    grads = torch.autograd.grad(out_t, leaves + [tx], torch.from_numpy(cot))
    it = iter(grads[:-1])
    gp_t = {layer: {k: next(it) for k in arrays} for layer, arrays in pd.items()}
    _compare("disc", out_t, out_j, {}, {}, gp_t, gp_j)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(gx_j), rtol=TOL, atol=TOL)
    # eval mode of the module itself gives the same logits (D has no BN,
    # and noise and dropout are 0 here)
    tnets[1].load_state_dict(bridge.from_jax(params, bn)["disc"])
    with torch.no_grad():
        np.testing.assert_allclose(tnets[1](torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                                   np.asarray(out_j), rtol=TOL, atol=TOL)


# Tolerance of the bfloat16 gradients against JAX's, relative to max(|JAX's|, 1):
# measured worst 3.1e-3 (kernel arm) and 7.1e-2 (plain arm), both on per-
# channel sums of a bfloat16 cotangent (biases, BN scale and bias, weight-norm
# g), which XLA sums on the CPU in bfloat16 in the backward and the port in
# float32; the conv and dense kernels' gradients were within 5e-4 and 1.1e-2.
BF16_GRAD_TOL = {True: 5e-3, False: 1.5e-1}


def _pre_bn_bias(player, layer, name):
    """The Generator's dense and inner deconv biases feed a batch norm,
    which removes each channel's mean: their exact gradient is 0, and what
    either package computes is the rounding of a cancelling bfloat16 sum."""
    return player == "gen" and name == "b" and layer != "deconv_out"


def _compare_bf16(player, use_pallas, out_t, out_j, stats_t, stats_j, gp_t, gp_j):
    np.testing.assert_array_equal(out_t.detach().float().numpy(), np.asarray(out_j.astype(jnp.float32)))
    for layer, arrays in stats_j.items():
        for k, v in arrays.items():
            np.testing.assert_allclose(stats_t[layer][k].numpy(), np.asarray(v), rtol=2e-6, atol=2e-6)
    tflat = bridge.to_jax({player: bridge.flat(gp_t, {})})[0][player]
    tol = BF16_GRAD_TOL[use_pallas]
    for layer, arrays in gp_j.items():
        for k, want in arrays.items():
            if _pre_bn_bias(player, layer, k):
                continue
            want = np.asarray(want, np.float64)
            err = np.max(np.abs(tflat[layer][k] - want))
            assert err <= tol * max(float(np.max(np.abs(want))), 1.0), (player, layer, k, err)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generator_and_discriminator_train_mode_bf16(name, use_pallas, tmp_path):
    """The Generator and the Discriminator in train mode at bfloat16 (inputs
    and cotangents in bfloat16, float32 weights), the port's arm against
    the JAX nets with the same ``use_pallas`` (the JAX epilogue in Pallas
    interpret mode for the kernel arm): outputs bitwise equal, BN running
    stats within 2e-6, D's input gradient within 1e-6 of max(|dx|, 1), and
    every parameter gradient within ``BF16_GRAD_TOL`` (but the Generator's
    pre-BN biases, ``_pre_bn_bias``)."""
    jcfg, _, params, bn, tnets, trees = _setup(name, use_pallas, True, tmp_path)
    jcfg.use_pallas = use_pallas
    jnets = jax_make_networks(jcfg)
    rng = np.random.RandomState(2)
    z = rng.normal(size=(4, jcfg.z_dim)).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.int32)

    def jgen(p):
        return jnets[0].apply(p, bn["gen"], jnp.asarray(z).astype(jnp.bfloat16), jnp.asarray(y), train=True)

    out_j, vjp, st_j = jax.vjp(jgen, params["gen"], has_aux=True)
    cot = rng.normal(size=out_j.shape).astype(np.float32)
    (gp_j,) = vjp(jnp.asarray(cot).astype(jnp.bfloat16))
    pg = _with_grad(trees["gen"][0])
    out_t, st_t = tnets[0].apply(pg, trees["gen"][1], torch.from_numpy(z).to(torch.bfloat16),
                                 torch.from_numpy(y), train=True)
    assert out_t.dtype == torch.bfloat16
    leaves = [t for arrays in pg.values() for t in arrays.values()]
    grads = iter(torch.autograd.grad(out_t, leaves, torch.from_numpy(cot).to(torch.bfloat16)))
    gp_t = {layer: {k: next(grads) for k in arrays} for layer, arrays in pg.items()}
    _compare_bf16("gen", use_pallas, out_t, out_j, st_t, st_j, gp_t, gp_j)

    x = rng.normal(size=(6, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    yd = rng.randint(0, 10, 6).astype(np.int32)

    def jdisc(p, xx):
        return jnets[1].apply(p, {}, xx, jnp.asarray(yd), train=True)[0]

    out_j, vjp = jax.vjp(jdisc, params["disc"], jnp.asarray(x).astype(jnp.bfloat16))
    cot = rng.normal(size=out_j.shape).astype(np.float32)
    gp_j, gx_j = vjp(jnp.asarray(cot).astype(jnp.bfloat16))
    pd = _with_grad(trees["disc"][0])
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    out_t, _ = tnets[1].apply(pd, {}, tx, torch.from_numpy(yd), train=True)
    leaves = [t for arrays in pd.values() for t in arrays.values()]
    grads = torch.autograd.grad(out_t, leaves + [tx], torch.from_numpy(cot).to(torch.bfloat16))
    it = iter(grads[:-1])
    gp_t = {layer: {k: next(it) for k in arrays} for layer, arrays in pd.items()}
    _compare_bf16("disc", use_pallas, out_t, out_j, {}, {}, gp_t, gp_j)
    gx_j = np.asarray(gx_j.astype(jnp.float32))
    assert np.max(np.abs(grads[-1].float().numpy() - gx_j)) <= 1e-6 * max(float(np.max(np.abs(gx_j))), 1.0)
