"""Three steps of the port's train step against the JAX package's
``make_train_step`` on the same injected batches, from the same weights
(carried across by the bridge), with share_pseudo_forward off and on, and
with fused_clf_forward (C's three streams as one 3B-row pass), each in the
port's use_pallas off and on (on the CPU the kernels take their plain
versions; the JAX step runs its plain path).

Setting: ``tests/helpers.py::deterministic_config`` (16 px, no noise or
dropout, no augmentation), ZCA fitted on 1024 synthetic images,
``pseudo_label_mode="argmax"``, ``alpha_p_warmup_epochs = 0`` so R_P is
live from the first step.

Tolerances. The per-step metrics within 1e-5·(1 + |metric|): float32 sums
in other orders, through three sequential updates (measured: 2e-7). Adam turns a
near-zero gradient into a ±lr step, so a gradient that differs in its
last bits can flip the sign of one coordinate's update: every final
parameter is held within 2·N·lr (N = 3 steps), and 99% of each player's
parameters within lr/100. BN running stats within 1e-4 absolute plus
1e-4 relative (the Generator's are sums over wide dense outputs). The argmax
pseudo-labels must agree at every step, so a flip shows as such and not
as drift.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tests.helpers import deterministic_config  # noqa: E402
from triplegan_tpu.configs.base import make_networks as jax_make_networks  # noqa: E402
from triplegan_tpu.configs.base import save_config  # noqa: E402
from triplegan_tpu.data import ondevice as jax_ondevice  # noqa: E402
from triplegan_tpu.data.datasets import synthetic_dataset as jax_synthetic  # noqa: E402
from triplegan_tpu.data.zca import fit_zca as jax_fit_zca  # noqa: E402
from triplegan_tpu.train.schedule import make_optimizers as jax_make_optimizers  # noqa: E402
from triplegan_tpu.train.state import create_state as jax_create_state  # noqa: E402
from triplegan_tpu.train.step import make_eval_step as jax_make_eval_step  # noqa: E402
from triplegan_tpu.train.step import make_train_step as jax_make_train_step  # noqa: E402
from triplegan_tpu_torch import bridge  # noqa: E402
from triplegan_tpu_torch.configs import base as port_base  # noqa: E402
from triplegan_tpu_torch.data import ondevice  # noqa: E402
from triplegan_tpu_torch.data.datasets import synthetic_dataset  # noqa: E402
from triplegan_tpu_torch.data.zca import fit_zca  # noqa: E402
from triplegan_tpu_torch.train import step as S  # noqa: E402
from triplegan_tpu_torch.train.schedule import make_optimizers  # noqa: E402
from triplegan_tpu_torch.train.state import create_state  # noqa: E402

torch.set_num_threads(1)
N_STEPS = 3
TOTAL = 16


def _jcfg(share, fused=False):
    cfg = deterministic_config()
    cfg.alpha_p_warmup_epochs = 0
    cfg.share_pseudo_forward = share
    cfg.fused_clf_forward = fused
    cfg.zca = True
    return cfg


def _data(cfg):
    return synthetic_dataset(cfg.image_size, cfg.channels, cfg.num_classes, n_train=1024,
                             n_test=32, num_labeled=cfg.num_labeled, seed=0)


def _batches(cfg, data, share):
    rng = np.random.RandomState(5)
    b = cfg.batch_size
    out = []
    for _ in range(N_STEPS):
        def stream(with_u=True):
            il = rng.randint(0, len(data.x_label), b)
            s = {"x_l": data.x_label[il], "y_l": data.y_label[il],
                 "z": rng.normal(size=(b, cfg.z_dim)).astype(np.float32),
                 "y_g": rng.randint(0, cfg.num_classes, b).astype(np.int32)}
            if with_u:
                s["x_u"] = data.x_unlabel[rng.randint(0, len(data.x_unlabel), b)]
            return s
        out.append({"d": stream(), "c": stream(not share),
                    "g": {"z": rng.normal(size=(b, cfg.z_dim)).astype(np.float32),
                          "y_g": rng.randint(0, cfg.num_classes, b).astype(np.int32)}})
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=["share_off", "share_on", "fused"])
def jax_run(request):
    """The JAX reference: 3 steps, with the pseudo-labels and eval counts
    along the way; share_pseudo_forward off or on, or fused_clf_forward
    (C's three streams in one 3B-row pass)."""
    share, fused = request.param == "share_on", request.param == "fused"
    cfg = _jcfg(share, fused)
    data = _data(cfg)
    zca = jax_fit_zca(data.x_unlabel)
    nets = jax_make_networks(cfg)
    opts = jax_make_optimizers(cfg, TOTAL)
    state = jax_create_state(cfg, nets, opts)
    init = (_np(state.params), _np(state.bn))
    step = jax.jit(jax_make_train_step(cfg, nets, opts, TOTAL, zca_stats=zca,
                                       pseudo_label_mode="argmax"))
    batches = _batches(cfg, data, share)
    labels, metrics = [], []
    for batch in batches:
        x_u = jax_ondevice.standard_pipeline(None, jnp.asarray(batch["d"]["x_u"]),
                                             zca_mean=jnp.asarray(zca.mean),
                                             zca_whiten=jnp.asarray(zca.whiten), train=False)
        logits, _ = nets[2].apply(state.params["clf"], state.bn["clf"], x_u, train=True)
        labels.append(np.asarray(jnp.argmax(logits, -1)))
        state, m = step(state, jax.tree.map(jnp.asarray, batch))
        metrics.append({k: float(v) for k, v in m.items()})
    eval_batch = {"x": data.x_test, "y": data.y_test, "mask": np.ones(len(data.y_test), np.float32)}
    ev = jax_make_eval_step(cfg, nets, zca)(state, jax.tree.map(jnp.asarray, eval_batch))
    return dict(cfg=cfg, share=share, data=data, zca=zca, init=init, batches=batches,
                labels=labels, metrics=metrics, params=_np(state.params), bn=_np(state.bn),
                correct=int(ev["correct"]), eval_batch=eval_batch)


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
def test_three_steps_match_jax(jax_run, use_pallas, tmp_path):
    run = jax_run
    cfg = _port_cfg(run["cfg"], use_pallas, tmp_path)
    assert cfg.share_pseudo_forward == run["share"]
    assert cfg.fused_clf_forward == run["cfg"].fused_clf_forward
    nets = port_base.make_networks(cfg)
    opts = make_optimizers(cfg, TOTAL)
    p0, b0 = _port_trees(*run["init"])
    state = create_state(cfg, nets, opts, device="cpu", params=p0, bn=b0)
    step = S.make_train_step(cfg, nets, opts, TOTAL, zca_stats=run["zca"],
                             pseudo_label_mode="argmax")
    zm, zw = torch.from_numpy(run["zca"].mean), torch.from_numpy(run["zca"].whiten)
    for t, batch in enumerate(run["batches"]):
        x_u = ondevice.standard_pipeline(torch.from_numpy(batch["d"]["x_u"]), zca_mean=zm,
                                         zca_whiten=zw)
        with torch.no_grad():
            logits, _ = nets[2].apply(state.params["clf"], state.bn["clf"], x_u, train=True)
        np.testing.assert_array_equal(torch.argmax(logits, -1).numpy(), run["labels"][t],
                                      err_msg=f"pseudo-labels differ at step {t}")
        tb = {s: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
              for s, d in batch.items()}
        state, m = step(state, tb)
        assert sorted(m) == sorted(S.METRICS) == sorted(run["metrics"][t])
        for k in S.METRICS:
            want = run["metrics"][t][k]
            assert abs(float(m[k]) - want) <= 1e-5 * (1 + abs(want)), (t, k, float(m[k]), want)
    assert state.step == N_STEPS

    params, bn = bridge.to_jax({p: bridge.flat(state.params[p], state.bn[p])
                                for p in ("gen", "disc", "clf")})
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

    ev = S.make_eval_step(cfg, nets, run["zca"])(
        state, {k: torch.from_numpy(v) for k, v in run["eval_batch"].items()})
    assert int(ev["correct"]) == run["correct"]
    assert int(ev["count"]) == len(run["eval_batch"]["y"])


def test_fused_clf_forward_with_share_pseudo_forward_raises_as_in_jax(tmp_path):
    jcfg = _jcfg(True, fused=True)
    with pytest.raises(ValueError) as want:
        jax_make_train_step(jcfg, jax_make_networks(jcfg), jax_make_optimizers(jcfg, TOTAL), TOTAL)
    cfg = _port_cfg(jcfg, False, tmp_path)
    with pytest.raises(ValueError) as got:
        S.make_train_step(cfg, port_base.make_networks(cfg), make_optimizers(cfg, TOTAL), TOTAL)
    assert str(got.value) == str(want.value) and "mutually exclusive" in str(got.value)


@pytest.mark.parametrize("share", [False, True])
def test_sampler_in_range_and_repeatable(share):
    cfg = port_base.base_config()
    cfg.batch_size, cfg.z_dim, cfg.share_pseudo_forward = 16, 8, share
    data = synthetic_dataset(16, 3, 10, n_train=50, n_test=4, num_labeled=20)
    dev_data = S.upload_device_data(data, "cpu")
    sample = S._make_batch_sampler(cfg)
    a, b, c = sample(7, 3, dev_data), sample(7, 3, dev_data), sample(7, 4, dev_data)
    assert ("x_u" in a["c"]) == (not share)
    for s in ("d", "c", "g"):
        for k in a[s]:
            assert torch.equal(a[s][k], b[s][k]), (s, k)
    assert not torch.equal(a["d"]["z"], c["d"]["z"])
    for s in ("d", "c"):
        assert a[s]["x_l"].shape == (16, 16, 16, 3) and a[s]["x_l"].dtype == torch.uint8
        assert int(a[s]["y_l"].min()) >= 0 and int(a[s]["y_l"].max()) < 10
        # every labeled image drawn is one of the labeled set, with its label
        lab = {bytes(x.tobytes()): int(y) for x, y in zip(data.x_label, data.y_label)}
        for x, y in zip(a[s]["x_l"].numpy(), a[s]["y_l"].numpy()):
            assert lab[bytes(x.tobytes())] == y
        assert 0 <= int(a[s]["y_g"].min()) and int(a[s]["y_g"].max()) < 10
        assert a[s]["z"].shape == (16, 8)
    # the flag leaves the fields both settings draw unchanged
    cfg2 = dict(cfg)
    cfg2 = port_base.ConfigDict(cfg2)
    cfg2.share_pseudo_forward = not share
    other = S._make_batch_sampler(cfg2)(7, 3, dev_data)
    for s in ("d", "g"):
        for k in a[s]:
            assert torch.equal(a[s][k], other[s][k])


def test_synthetic_data_and_zca_fit_match_jax():
    a = synthetic_dataset(8, 3, 10, n_train=300, n_test=20, num_labeled=40, seed=3)
    b = jax_synthetic(8, 3, 10, n_train=300, n_test=20, num_labeled=40, seed=3)
    for k in ("x_label", "y_label", "x_unlabel", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    za, zb = fit_zca(a.x_unlabel), jax_fit_zca(b.x_unlabel)
    np.testing.assert_array_equal(za.mean, zb.mean)
    np.testing.assert_array_equal(za.whiten, zb.whiten)


@pytest.fixture(scope="module")
def jax_bench_run():
    """The JAX reference at bench's knob set: bfloat16 compute over float32
    weights, share_pseudo_forward on, JAX's default plain path; 3 steps."""
    cfg = _jcfg(True)
    cfg.compute_dtype = "bfloat16"
    data = _data(cfg)
    zca = jax_fit_zca(data.x_unlabel)
    nets = jax_make_networks(cfg)
    opts = jax_make_optimizers(cfg, TOTAL)
    state = jax_create_state(cfg, nets, opts)
    init = (_np(state.params), _np(state.bn))
    step = jax.jit(jax_make_train_step(cfg, nets, opts, TOTAL, zca_stats=zca,
                                       pseudo_label_mode="argmax"))
    batches = _batches(cfg, data, True)
    metrics = []
    for batch in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, batch))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(cfg=cfg, zca=zca, init=init, batches=batches, metrics=metrics,
                params=_np(state.params), bn=_np(state.bn))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_three_bf16_bench_steps_match_jax(jax_bench_run, use_pallas, tmp_path):
    """Three steps at bench's knob set (bfloat16 over float32 weights,
    share_pseudo_forward on) in each arm of the port, against JAX's
    ``make_train_step`` on the same batches from the same weights.

    Tolerances, measured on these inputs and set with room: every metric
    at every step within 1.5e-2·(1 + |m|) (measured ≤ 6.8e-3, loss_d of
    the kernel arm: its epilogues compute in float32 where JAX's plain
    path rounds each op to bfloat16); after 3 steps each player's
    parameters with every coordinate within 3·N·lr (measured ≤ 6.1·lr),
    at least 90% within lr (measured ≥ 96.8%) and a mean difference under
    lr/2 (measured ≤ 0.21·lr): bfloat16 gradients that differ in their
    last bits flip Adam's ±lr steps of near-zero coordinates; BN running
    stats within 2e-2·max(1, |s|) (measured ≤ 5e-3)."""
    run = jax_bench_run
    cfg = _port_cfg(run["cfg"], use_pallas, tmp_path)
    assert cfg.compute_dtype == "bfloat16" and cfg.share_pseudo_forward
    nets = port_base.make_networks(cfg)
    opts = make_optimizers(cfg, TOTAL)
    p0, b0 = _port_trees(*run["init"])
    state = create_state(cfg, nets, opts, device="cpu", params=p0, bn=b0)
    step = S.make_train_step(cfg, nets, opts, TOTAL, zca_stats=run["zca"], pseudo_label_mode="argmax")
    for t, batch in enumerate(run["batches"]):
        tb = {s: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for s, d in batch.items()}
        state, m = step(state, tb)
        for k in S.METRICS:
            want = run["metrics"][t][k]
            assert abs(float(m[k]) - want) <= 1.5e-2 * (1 + abs(want)), (t, k, float(m[k]), want)
    params, bn = bridge.to_jax({p: bridge.flat(state.params[p], state.bn[p])
                                for p in ("gen", "disc", "clf")})
    lr = float(cfg.lr_c)
    for player in ("gen", "disc", "clf"):
        errs = np.concatenate([np.abs(params[player][layer][name] - want).ravel()
                               for layer, arrays in run["params"][player].items()
                               for name, want in arrays.items()])
        assert errs.max() <= 3 * N_STEPS * lr, (player, errs.max() / lr)
        assert np.mean(errs <= lr) >= 0.9, (player, np.mean(errs <= lr))
        assert errs.mean() <= lr / 2, (player, errs.mean() / lr)
        for layer, arrays in run["bn"][player].items():
            for name, want in arrays.items():
                err = np.abs(bn[player][layer][name] - want) / np.maximum(1.0, np.abs(want))
                assert err.max() <= 2e-2, (player, layer, name, err.max())
