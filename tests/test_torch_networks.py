"""The port's Generator and Classifier against the JAX nets at train=False,
with use_pallas set the same on both sides (JAX interprets its Pallas
kernel on the CPU; the port takes its kernel's plain version), at the tiny
test widths (16 px) and at mnist100's widths (28 px).

The port's config comes from the JAX config through the run dir's
config.json format (JAX save_config → port merge_saved), and the weights
through bridge.from_jax. Tolerances: float32 atol 1e-4 (same math in
another summation order, through up to 7 layers); bfloat16 classify within
4 bfloat16 ulps (2^-8 relative each) of the largest logit: the two
frameworks round their bf16 convs and the plain epilogue's bf16 products
differently, and such one-ulp differences compound through the stack
(measured on the CPU: at most 1.3 ulps, and bit-identical logits with
use_pallas, whose epilogue rounds once).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tests.helpers import tiny_config  # noqa: E402
from triplegan_tpu.configs import get_config as jax_get_config  # noqa: E402
from triplegan_tpu.configs.base import make_networks as jax_make_networks  # noqa: E402
from triplegan_tpu.configs.base import save_config  # noqa: E402
from triplegan_tpu_torch import bridge  # noqa: E402
from triplegan_tpu_torch.configs import base as port_base  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-4
BF16_ULPS = 4


def randomize_state(params, bn, seed):
    """JAX init gives BN mean 0, var 1, scale 1, bias 0 and zero biases;
    draw all of them so every term of every epilogue is exercised."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, params)
    bn = jax.tree.map(np.asarray, bn)
    for arrays in (a for player in params.values() for a in player.values()):
        for name, a in arrays.items():
            if name in ("b", "bias"):
                arrays[name] = (rng.normal(size=a.shape) * 0.1).astype(np.float32)
            elif name in ("scale", "g"):
                arrays[name] = (rng.rand(*a.shape) * 0.5 + 0.75).astype(np.float32)
    for arrays in (a for player in bn.values() for a in player.values()):
        arrays["mean"] = (rng.normal(size=arrays["mean"].shape) * 0.1).astype(np.float32)
        arrays["var"] = (rng.rand(*arrays["var"].shape) + 0.5).astype(np.float32)
    return params, bn


def build_pair(jax_cfg, use_pallas, tmp_path, seed=0):
    """(JAX gen, JAX clf, params, bn, port gen, port clf) from one config."""
    jax_cfg.use_pallas = use_pallas
    path = str(tmp_path / "config.json")
    save_config(jax_cfg, path)
    cfg = port_base.merge_saved(port_base.base_config(), path)
    cfg.use_pallas = use_pallas  # an execution key: not taken from config.json
    jgen, _, jclf = jax_make_networks(jax_cfg)
    kg, kc = jax.random.split(jax.random.PRNGKey(seed))
    pg, sg = jgen.init(kg)
    pc, sc = jclf.init(kc)
    params, bn = randomize_state({"gen": pg, "clf": pc}, {"gen": sg, "clf": sc}, seed)
    tgen, tclf = port_base.make_networks(cfg)
    state = bridge.from_jax(params, bn)
    tgen.load_state_dict(state["gen"])
    tclf.load_state_dict(state["clf"])
    return jgen, jclf, params, bn, tgen.eval(), tclf.eval()


CONFIGS = {
    "tiny16": lambda: tiny_config(),
    "mnist28": lambda: jax_get_config("mnist100"),
}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generator_matches_jax(name, use_pallas, tmp_path):
    jcfg = CONFIGS[name]()
    jgen, _, params, bn, tgen, _ = build_pair(jcfg, use_pallas, tmp_path)
    rng = np.random.RandomState(1)
    z = rng.normal(size=(3, jcfg.z_dim)).astype(np.float32)
    y = np.array([0, 4, 9], np.int32)
    want, _ = jgen.apply(params["gen"], bn["gen"], jnp.asarray(z), jnp.asarray(y), train=False)
    with torch.inference_mode():
        got = tgen(torch.from_numpy(z), torch.from_numpy(y))
        got_pk = tgen(torch.from_numpy(z), torch.from_numpy(y), phase=tgen.phase_kernels())
    want = np.asarray(want)
    assert got.shape == want.shape == (3, jcfg.image_size, jcfg.image_size, jcfg.channels)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got_pk.numpy(), got.numpy())


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_classifier_matches_jax(name, use_pallas, tmp_path):
    jcfg = CONFIGS[name]()
    _, jclf, params, bn, _, tclf = build_pair(jcfg, use_pallas, tmp_path)
    x = np.random.RandomState(2).normal(
        size=(3, jcfg.image_size, jcfg.image_size, jcfg.channels)).astype(np.float32)
    want, _ = jclf.apply(params["clf"], bn["clf"], jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = tclf(torch.from_numpy(x))
    assert got.shape == (3, jcfg.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_classifier_bf16_matches_jax(name, use_pallas, tmp_path):
    jcfg = CONFIGS[name]()
    _, jclf, params, bn, _, tclf = build_pair(jcfg, use_pallas, tmp_path)
    x = np.random.RandomState(3).normal(
        size=(4, jcfg.image_size, jcfg.image_size, jcfg.channels)).astype(np.float32)
    want, _ = jclf.apply(params["clf"], bn["clf"], jnp.asarray(x).astype(jnp.bfloat16), train=False)
    with torch.inference_mode():
        got = tclf(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    scale = float(np.max(np.abs(want)))
    assert np.max(np.abs(got - want)) <= BF16_ULPS * 2.0 ** -8 * scale
