"""The port's data-dependent weight-norm init (``nn/ddinit.py``) against
the JAX package's on the CPU: the same weights (carried over by the
bridge) and the same float32 inputs, made with numpy, through
``ddinit_discriminator`` and ``ddinit_generator``, in both arms of the
port (``use_pallas``: on the CPU the conv kernels take their plain
versions, so the kernel arm runs the same routes in the port's layers).

Tolerance: every parameter within 1e-5·(1 + |p|) after the bridge. Both
sum the same float32 products in other orders (JAX's deconv is
``lax.conv_transpose``, the port's the subpixel conv), and g = 1/(std + ε)
carries their relative error (measured ≤ 4.8e-7·(1 + |p|)).

Also: the pre-activations of every weight-norm layer of D, recomputed
with the new parameters on the init batch, have per-channel mean 0 and
standard deviation 1 (within 1e-4); and the loop's ``_apply_ddinit``
repeats itself for one seed, changes with it, and changes only D's and
G's weight-norm parameters.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tests.helpers import tiny_config  # noqa: E402
from triplegan_tpu.configs.base import make_networks as jax_make_networks  # noqa: E402
from triplegan_tpu.configs.base import save_config  # noqa: E402
from triplegan_tpu.nn import ddinit as jax_ddinit  # noqa: E402
from triplegan_tpu.train.schedule import make_optimizers as jax_make_optimizers  # noqa: E402
from triplegan_tpu.train.state import create_state as jax_create_state  # noqa: E402
from triplegan_tpu_torch import bridge  # noqa: E402
from triplegan_tpu_torch.configs import base as port_base  # noqa: E402
from triplegan_tpu_torch.data.datasets import synthetic_dataset  # noqa: E402
from triplegan_tpu_torch.nn import ddinit, layers as L  # noqa: E402
from triplegan_tpu_torch.train import loop  # noqa: E402
from triplegan_tpu_torch.train.schedule import make_optimizers  # noqa: E402
from triplegan_tpu_torch.train.state import create_state  # noqa: E402

torch.set_num_threads(1)
B = 12


def _cfg():
    cfg = tiny_config()
    # a stride-1 conv after the label planes are concatenated again
    cfg.disc.widths, cfg.disc.strides = (8, 8, 16), (1, 2, 1)
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = _cfg()
    nets = jax_make_networks(cfg)
    state = jax_create_state(cfg, nets, jax_make_optimizers(cfg, 1))
    rng = np.random.RandomState(4)
    inputs = {"x": rng.uniform(-1, 1, size=(B, 16, 16, 3)).astype(np.float32),
              "y": rng.randint(0, 10, size=B).astype(np.int32),
              "z": rng.normal(size=(B, cfg.z_dim)).astype(np.float32),
              "y_g": rng.randint(0, 10, size=B).astype(np.int32)}
    params, bn = jax.tree.map(np.asarray, state.params), jax.tree.map(np.asarray, state.bn)
    want_d = jax_ddinit.ddinit_discriminator(nets[1], state.params["disc"], jnp.asarray(inputs["x"]),
                                             jnp.asarray(inputs["y"]))
    want_g = jax_ddinit.ddinit_generator(nets[0], state.params["gen"], state.bn["gen"],
                                         jnp.asarray(inputs["z"]), jnp.asarray(inputs["y_g"]))
    path = str(tmp_path_factory.mktemp("cfg") / "config.json")
    save_config(cfg, path)
    return dict(path=path, params=params, bn=bn, inputs=inputs,
                want={"disc": jax.tree.map(np.asarray, want_d), "gen": jax.tree.map(np.asarray, want_g)})


def _port(setup, use_pallas):
    cfg = port_base.merge_saved(port_base.base_config(), setup["path"])
    cfg.use_pallas = use_pallas
    nets = port_base.make_networks(cfg)
    trees = {p: bridge.nested(sd) for p, sd in bridge.from_jax(setup["params"], setup["bn"]).items()}
    return cfg, nets, trees


def _check(player, got_params, stats, want):
    got = bridge.to_jax({player: bridge.flat(got_params, stats)})[0][player]
    assert got.keys() == want.keys()
    for layer, arrays in want.items():
        for name, w in arrays.items():
            err = np.abs(got[layer][name] - w) / (1 + np.abs(w))
            assert err.max() <= 1e-5, (player, layer, name, err.max())


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_ddinit_discriminator_matches_jax(setup, use_pallas):
    _, (_, disc, _), trees = _port(setup, use_pallas)
    inp = setup["inputs"]
    params, stats = trees["disc"]
    new = ddinit.ddinit_discriminator(disc, params, torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"]))
    _check("disc", new, stats, setup["want"]["disc"])
    changed = [k for k in new if not torch.equal(new[k]["g"], params[k]["g"])]
    assert changed == ["conv0", "conv1", "conv2", "head"]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_ddinit_generator_matches_jax(setup, use_pallas):
    _, (gen, _, _), trees = _port(setup, use_pallas)
    inp = setup["inputs"]
    params, stats = trees["gen"]
    new = ddinit.ddinit_generator(gen, params, stats, torch.from_numpy(inp["z"]), torch.from_numpy(inp["y_g"]))
    _check("gen", new, stats, setup["want"]["gen"])
    assert [k for k in new if new[k] is not params[k]] == ["deconv_out"]


def test_ddinit_normalizes_every_weight_norm_pre_activation(setup):
    """D's forward with the new parameters: each weight-norm layer's
    pre-activation (conv with g·v/‖v‖ plus b) has per-channel mean 0 and
    std 1 on the init batch."""
    _, (_, disc, _), trees = _port(setup, True)
    x, y = torch.from_numpy(setup["inputs"]["x"]), torch.from_numpy(setup["inputs"]["y"])
    new = ddinit.ddinit_discriminator(disc, trees["disc"][0], x, y)
    y1h = L.onehot(y, disc.num_classes)
    h = L.label_concat_spatial(x, y1h)
    pre = []
    for i, s in enumerate(disc.strides):
        t = L.conv2d_apply(new[f"conv{i}"], h, stride=s)
        pre.append(t)
        h = L.leaky_relu(t, disc.lrelu_slope)
        if s == 2 and i + 1 < len(disc.widths):
            h = L.label_concat_spatial(h, y1h)
    pre.append(L.dense_apply(new["head"], torch.cat([L.global_avg_pool(h), y1h], -1)))
    for t in pre:
        flat = t.reshape(-1, t.shape[-1]).double()
        assert float(flat.mean(0).abs().max()) <= 1e-4
        assert float((flat.std(0, correction=0) - 1).abs().max()) <= 1e-4


def test_apply_ddinit_draws_from_seed_plus_one_and_leaves_the_rest(setup):
    cfg, nets, _ = _port(setup, True)
    cfg.batch_size = 8
    data = synthetic_dataset(16, 3, 10, n_train=40, n_test=4, num_labeled=20, seed=0)
    state = create_state(cfg, nets, make_optimizers(cfg, 1), device="cpu")
    a = loop._apply_ddinit(cfg, nets, state, data, None, torch.device("cpu"))
    b = loop._apply_ddinit(cfg, nets, state, data, None, torch.device("cpu"))
    for p in ("gen", "disc"):
        for layer in a.params[p]:
            for k in a.params[p][layer]:
                assert torch.equal(a.params[p][layer][k], b.params[p][layer][k])
    assert a.params["clf"] is state.params["clf"] and a.bn is state.bn and a.step == 0
    assert not torch.equal(a.params["disc"]["conv0"]["g"], state.params["disc"]["conv0"]["g"])
    assert not torch.equal(a.params["gen"]["deconv_out"]["g"], state.params["gen"]["deconv_out"]["g"])
    assert torch.equal(a.params["gen"]["deconv0"]["w"], state.params["gen"]["deconv0"]["w"])
    cfg.seed += 1
    c = loop._apply_ddinit(cfg, nets, state, data, None, torch.device("cpu"))
    assert not torch.equal(c.params["disc"]["conv0"]["g"], a.params["disc"]["conv0"]["g"])
