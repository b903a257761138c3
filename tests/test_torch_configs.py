"""The three configurations besides cifar10_4k and stl10 (mnist100, svhn1k,
cifar10_cond), each through three steps of the port's train step against
the JAX package's ``make_train_step`` on the same injected batches, from
the same weights (carried across by the bridge), then its eval step and
its serving functions, in the port's use_pallas off and on (on the CPU the
kernels take their plain versions; the JAX step runs its plain path).

What each configuration brings that cifar10_4k does not:
- mnist100, at its published widths: 28 × 28 × 1 images, so C's first
  conv takes Cin = 1, D's first 1 + 10 channels and 32 + 10 after the
  label re-concat at 14 × 14, G's last phase conv Cout = 4 and its output
  epilogue C = 1; C's VALID conv turns 7 × 7 into 5 × 5; no ZCA;
- svhn1k, at narrowed widths: no ZCA and no flip, so the input transform
  runs without ``zca_mean``/``zca_whiten``;
- cifar10_cond, G with three deconvs at narrowed widths, ZCA: fully
  labeled (its ``num_labeled``, 50000, takes every train image into the
  labeled set) and ``alpha_p_warmup_epochs = 0`` as shipped.

Settings as ``tests/test_torch_step.py``'s: no noise or dropout, no
augmentation, ``pseudo_label_mode="argmax"``, R_P live from the first step
(mnist100's and svhn1k's warm-up set to 0 too), tiny batches; ZCA (cifar10_cond) from
seeded statistics near the identity, not a fit. Tolerances as there: the
metrics within 1e-5·(1 + |metric|), every parameter within 2·N·lr and 99%
of each player's within lr/100 (N = 3 steps), BN statistics within 1e-4
absolute plus 1e-4 relative, the argmax pseudo-labels equal at every step,
the eval step's correct count equal; the serving functions of the JAX
run's final weights, carried across, within 1e-4
(``tests/test_torch_export.py``'s).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from triplegan_tpu import export as jexport  # noqa: E402
from triplegan_tpu.configs import get_config as jax_get_config  # noqa: E402
from triplegan_tpu.configs.base import make_networks as jax_make_networks  # noqa: E402
from triplegan_tpu.configs.base import save_config  # noqa: E402
from triplegan_tpu.data import ondevice as jax_ondevice  # noqa: E402
from triplegan_tpu.data.zca import ZCAStats as JaxZCAStats  # noqa: E402
from triplegan_tpu.train.schedule import make_optimizers as jax_make_optimizers  # noqa: E402
from triplegan_tpu.train.state import create_state as jax_create_state  # noqa: E402
from triplegan_tpu.train.step import make_eval_step as jax_make_eval_step  # noqa: E402
from triplegan_tpu.train.step import make_train_step as jax_make_train_step  # noqa: E402
from triplegan_tpu_torch import bridge  # noqa: E402
from triplegan_tpu_torch import export as texport  # noqa: E402
from triplegan_tpu_torch.configs import base as port_base  # noqa: E402
from triplegan_tpu_torch.data import ondevice  # noqa: E402
from triplegan_tpu_torch.data.datasets import synthetic_dataset  # noqa: E402
from triplegan_tpu_torch.data.zca import ZCAStats  # noqa: E402
from triplegan_tpu_torch.train import step as S  # noqa: E402
from triplegan_tpu_torch.train.schedule import make_optimizers  # noqa: E402
from triplegan_tpu_torch.train.state import create_state  # noqa: E402

torch.set_num_threads(1)
N_STEPS = 3
TOTAL = 16
N_TRAIN = 64
ATOL = 1e-4


def _jcfg(name):
    """The JAX config at its published widths (mnist100) or narrowed,
    stochastic layers and augmentation off, R_P live, batch 4."""
    cfg = jax_get_config(name)
    cfg.disc.input_noise = cfg.disc.input_dropout = cfg.disc.block_dropout = 0.0
    cfg.clf.input_noise = cfg.clf.block_dropout = 0.0
    cfg.aug_translate, cfg.aug_flip = 0, False
    cfg.alpha_p_warmup_epochs = 0
    cfg.batch_size = 4
    if name != "mnist100":
        cfg.z_dim = 16
        cfg.gen.widths = (32, 16, 8)
        cfg.disc.widths = (8, 8, 16, 16, 16, 16)
        cfg.clf.conv_blocks = ((16, 16), (16, 16))
        cfg.clf.tail = (16, 16, 8)
    return cfg


def _zca(d):
    """Seeded whitening statistics near the identity (a symmetric W)."""
    rng = np.random.RandomState(7)
    a = rng.normal(size=(d, d)).astype(np.float32) * (0.1 / d ** 0.5)
    return (rng.normal(size=d) * 0.05).astype(np.float32), np.eye(d, dtype=np.float32) + (a + a.T) / 2


def _batches(cfg, data):
    rng = np.random.RandomState(5)
    b = cfg.batch_size
    out = []
    for _ in range(N_STEPS):
        def stream():
            il = rng.randint(0, len(data.x_label), b)
            return {"x_l": data.x_label[il], "y_l": data.y_label[il],
                    "z": rng.normal(size=(b, cfg.z_dim)).astype(np.float32),
                    "y_g": rng.randint(0, cfg.num_classes, b).astype(np.int32),
                    "x_u": data.x_unlabel[rng.randint(0, len(data.x_unlabel), b)]}
        out.append({"d": stream(), "c": stream(),
                    "g": {"z": rng.normal(size=(b, cfg.z_dim)).astype(np.float32),
                          "y_g": rng.randint(0, cfg.num_classes, b).astype(np.int32)}})
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=["mnist100", "svhn1k", "cifar10_cond"])
def jax_run(request):
    """The JAX reference of one configuration: 3 steps, with the
    pseudo-labels along the way, then its eval step and its serving
    functions' outputs on seeded inputs."""
    name = request.param
    cfg = _jcfg(name)
    data = synthetic_dataset(cfg.image_size, cfg.channels, cfg.num_classes, n_train=N_TRAIN, n_test=16,
                             num_labeled=cfg.num_labeled, seed=0)
    zca = port_zca = None
    if cfg.zca:
        mean, whiten = _zca(cfg.image_size ** 2 * cfg.channels)
        zca, port_zca = JaxZCAStats(mean, whiten), ZCAStats(mean, whiten)
    nets = jax_make_networks(cfg)
    opts = jax_make_optimizers(cfg, TOTAL)
    state = jax_create_state(cfg, nets, opts)
    init = (_np(state.params), _np(state.bn))
    step = jax.jit(jax_make_train_step(cfg, nets, opts, TOTAL, zca_stats=zca, pseudo_label_mode="argmax"))
    batches = _batches(cfg, data)
    zm, zw = (None, None) if zca is None else (jnp.asarray(zca.mean), jnp.asarray(zca.whiten))
    labels, metrics = [], []
    for batch in batches:
        x_u = jax_ondevice.standard_pipeline(None, jnp.asarray(batch["d"]["x_u"]), zca_mean=zm, zca_whiten=zw,
                                             train=False)
        logits, _ = nets[2].apply(state.params["clf"], state.bn["clf"], x_u, train=True)
        labels.append(np.asarray(jnp.argmax(logits, -1)))
        state, m = step(state, jax.tree.map(jnp.asarray, batch))
        metrics.append({k: float(v) for k, v in m.items()})
    eval_batch = {"x": data.x_test, "y": data.y_test, "mask": np.ones(len(data.y_test), np.float32)}
    ev = jax_make_eval_step(cfg, nets, zca)(state, jax.tree.map(jnp.asarray, eval_batch))
    rng = np.random.RandomState(3)
    serve_in = types.SimpleNamespace(
        images=rng.randint(0, 256, size=(5, cfg.image_size, cfg.image_size, cfg.channels), dtype=np.uint8),
        z=rng.normal(size=(5, cfg.z_dim)).astype(np.float32), y=np.array([0, 3, 9, 1, 2], np.int32))
    classify, generate = jexport.make_serving_fns(cfg, nets, state, zca)
    return dict(name=name, cfg=cfg, zca=port_zca, init=init, batches=batches, labels=labels,
                metrics=metrics, params=_np(state.params), bn=_np(state.bn), correct=int(ev["correct"]),
                eval_batch=eval_batch, serve_in=serve_in,
                logits=np.asarray(classify(jnp.asarray(serve_in.images))),
                images=np.asarray(generate(jnp.asarray(serve_in.z), jnp.asarray(serve_in.y))))


def _port_cfg(jcfg, use_pallas, tmp_path):
    path = str(tmp_path / "config.json")
    save_config(jcfg, path)
    cfg = port_base.merge_saved(port_base.base_config(), path)
    cfg.use_pallas = use_pallas
    return cfg


def _port_trees(params, bn):
    """JAX (params, bn) → the port's nested trees, per player."""
    state = bridge.from_jax(params, bn)
    trees = {p: bridge.nested(sd) for p, sd in state.items()}
    return {p: t[0] for p, t in trees.items()}, {p: t[1] for p, t in trees.items()}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_three_steps_eval_and_serving_match_jax(jax_run, use_pallas, tmp_path):
    run = jax_run
    cfg = _port_cfg(run["cfg"], use_pallas, tmp_path)
    assert (cfg.image_size, cfg.channels, cfg.zca, cfg.aug_flip) == {
        "mnist100": (28, 1, False, False), "svhn1k": (32, 3, False, False),
        "cifar10_cond": (32, 3, True, False)}[run["name"]]
    nets = port_base.make_networks(cfg)
    opts = make_optimizers(cfg, TOTAL)
    p0, b0 = _port_trees(*run["init"])
    state = create_state(cfg, nets, opts, device="cpu", params=p0, bn=b0)
    step = S.make_train_step(cfg, nets, opts, TOTAL, zca_stats=run["zca"], pseudo_label_mode="argmax")
    zca = run["zca"]
    zm, zw = (None, None) if zca is None else (torch.from_numpy(zca.mean), torch.from_numpy(zca.whiten))
    for t, batch in enumerate(run["batches"]):
        x_u = ondevice.standard_pipeline(torch.from_numpy(batch["d"]["x_u"]), zca_mean=zm, zca_whiten=zw)
        with torch.no_grad():
            logits, _ = nets[2].apply(state.params["clf"], state.bn["clf"], x_u, train=True)
        np.testing.assert_array_equal(torch.argmax(logits, -1).numpy(), run["labels"][t],
                                      err_msg=f"pseudo-labels differ at step {t}")
        tb = {s: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for s, d in batch.items()}
        state, m = step(state, tb)
        assert sorted(m) == sorted(S.METRICS) == sorted(run["metrics"][t])
        for k in S.METRICS:
            want = run["metrics"][t][k]
            assert abs(float(m[k]) - want) <= 1e-5 * (1 + abs(want)), (t, k, float(m[k]), want)
    assert state.step == N_STEPS

    params, bn = bridge.to_jax({p: bridge.flat(state.params[p], state.bn[p]) for p in ("gen", "disc", "clf")})
    lr = float(cfg.lr_c)
    for player in ("gen", "disc", "clf"):
        errs = []
        for layer, arrays in run["params"][player].items():
            for name, want in arrays.items():
                err = np.abs(params[player][layer][name] - want)
                assert err.max() <= 2 * N_STEPS * lr, (player, layer, name, err.max())
                errs.append(err.ravel())
        errs = np.concatenate(errs)
        assert np.mean(errs <= lr / 100) >= 0.99, (player, np.mean(errs <= lr / 100))
        for layer, arrays in run["bn"][player].items():
            for name, want in arrays.items():
                np.testing.assert_allclose(bn[player][layer][name], want, rtol=1e-4, atol=1e-4)

    ev = S.make_eval_step(cfg, nets, zca)(state, {k: torch.from_numpy(v) for k, v in run["eval_batch"].items()})
    assert int(ev["correct"]) == run["correct"]
    assert int(ev["count"]) == len(run["eval_batch"]["y"])

    # the serving functions of the JAX run's final weights, carried across
    classify, generate = texport.make_serving_fns(cfg, nets, bridge.from_jax(run["params"], run["bn"]),
                                                  zca_stats=zca, device="cpu")
    si = run["serve_in"]
    logits = classify(torch.from_numpy(si.images)).numpy()
    images = generate(torch.from_numpy(si.z), torch.from_numpy(si.y)).numpy()
    assert logits.shape == (5, cfg.num_classes)
    assert images.shape == (5, cfg.image_size, cfg.image_size, cfg.channels)
    np.testing.assert_allclose(logits, run["logits"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(images, run["images"], rtol=0, atol=ATOL)
