"""The port's ``scan_steps``: several train steps a call
(``train/step.py``'s ``make_scan_train_step``, ``make_scan_device_train_step``
and ``_reduce_scan_metrics``; ``train/loop.py``'s chunked loop), on the
CPU, where the chunk runs its steps eagerly through the code that the card
captures as a CUDA graph.

- A chunk of 4 device-data steps equals 4 single steps bitwise (every
  parameter, BN stat, Adam moment and metric), "last" and "mean", with α_P
  switching on and the lr decaying inside a chunk, over two chunks.
- A chunk of 4 steps on one injected batch against JAX's
  ``make_scan_train_step(step, 4)`` at ``tests/helpers.py::
  deterministic_config``, argmax pseudo-labels, α_P switching on at step 2
  and the lr decaying from count 2. Tolerances as in
  ``tests/test_torch_step.py``: metrics within 1e-5·(1 + |m|) (float32 sums
  in other orders); every parameter within 2·N·lr after N = 4 steps and 99%
  of each player's within lr/100 (Adam turns a near-zero gradient into a
  ±lr step whose sign the last bits decide); BN running stats within
  test_torch_step's allowance for its 3 steps, 1e-4 absolute plus 1e-4
  relative, scaled by N/3 as the parameters' allowance scales with N: on
  this batch, 4 steps take the Generator's ``bn1`` mean to 1.006 times the
  unscaled allowance (1.17 on another batch), in the parent tree's step as
  in this one.
- ``_reduce_scan_metrics`` against JAX's on the same stacked metrics
  (float32, within 1e-7 relative: a mean of 4 in another order), and both
  raise ValueError for a bad mode.
- A probe scalars tensor (α_P, the lr fraction, each Adam's lr and bias
  corrections) that raises when the host reads it (``int``, ``float``,
  ``bool``, ``.item()``, ``.tolist()``) goes through the step body and gives
  the eager step's result bitwise: the body reads nothing of what depends
  on the step number on the host, so nothing would be baked into a graph.
- ``loop.train`` with ``scan_steps=4`` ends in the checkpoint that
  ``scan_steps=1`` ends in, bitwise, and at ``scan_steps=3`` (which does
  not divide the 4-step epoch) logs, evaluates and checkpoints at the
  steps the JAX loop does.

One thread, a few layers and narrow widths.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tests.helpers import deterministic_config, tiny_config  # noqa: E402
from triplegan_tpu.configs.base import make_networks as jax_make_networks  # noqa: E402
from triplegan_tpu.configs.base import save_config as jax_save_config  # noqa: E402
from triplegan_tpu.data.zca import fit_zca as jax_fit_zca  # noqa: E402
from triplegan_tpu.train import loop as jax_loop  # noqa: E402
from triplegan_tpu.train import step as JS  # noqa: E402
from triplegan_tpu.train.schedule import make_optimizers as jax_make_optimizers  # noqa: E402
from triplegan_tpu.train.state import create_state as jax_create_state  # noqa: E402
from triplegan_tpu.utils.logging import MetricsLogger as JaxMetricsLogger  # noqa: E402
from triplegan_tpu_torch import bridge  # noqa: E402
from triplegan_tpu_torch.configs import base as port_base  # noqa: E402
from triplegan_tpu_torch.data.datasets import synthetic_dataset  # noqa: E402
from triplegan_tpu_torch.train import loop  # noqa: E402
from triplegan_tpu_torch.train import step as S  # noqa: E402
from triplegan_tpu_torch.train.schedule import AdamState, make_optimizers  # noqa: E402
from triplegan_tpu_torch.train.state import create_state  # noqa: E402
from triplegan_tpu_torch.utils.logging import MetricsLogger  # noqa: E402

torch.set_num_threads(1)
K = 4


def _port_cfg(jcfg, tmp_path):
    path = str(tmp_path / "jax_config.json")
    jax_save_config(jcfg, path)
    return port_base.merge_saved(port_base.base_config(), path)


def _tensors(state):
    """Every tensor of a state by path: parameters, BN stats, Adam moments."""
    out = {}
    for kind, trees in (("params", state.params), ("bn", state.bn),
                        ("mu", {p: o.mu for p, o in state.opt.items()}),
                        ("nu", {p: o.nu for p, o in state.opt.items()})):
        for p, tree in trees.items():
            for layer, arrays in tree.items():
                for k, t in arrays.items():
                    out[f"{kind}/{p}/{layer}/{k}"] = t
    return out


def _clone(state):
    return S._clone_state(state)


# --- (1) a chunk equals single steps, bitwise --------------------------------

def _scan_setup(tmp_path, mode):
    """tiny_config with every stochastic layer and augmentation on; 8
    steps in all (spe = 2 for the step's schedules): α_P switches on at
    step 2 (inside the first chunk) and the lr decays from count 5 on
    (inside the second)."""
    jcfg = tiny_config(aug_translate=2, aug_flip=True, zca=True, data_on_device=True)
    jcfg.epochs, jcfg.alpha_p_warmup_epochs, jcfg.lr_decay_start_frac = 4, 1, 0.5
    cfg = _port_cfg(jcfg, tmp_path)
    data = synthetic_dataset(cfg.image_size, cfg.channels, cfg.num_classes, n_train=256, n_test=8,
                             num_labeled=cfg.num_labeled, seed=0)
    from triplegan_tpu_torch.data.zca import fit_zca

    zca = fit_zca(data.x_unlabel)
    nets = port_base.make_networks(cfg)
    opts = make_optimizers(cfg, 8)
    state = create_state(cfg, nets, opts, device="cpu")
    dev_data = S.upload_device_data(data, "cpu")
    step = S.make_device_train_step(cfg, nets, opts, 8, zca_stats=zca)
    chunk = S.make_scan_device_train_step(cfg, nets, opts, 8, K, zca_stats=zca, metrics_mode=mode)
    return state, dev_data, step, chunk


@pytest.mark.parametrize("mode", ["last", "mean"])
def test_chunk_of_four_equals_four_single_steps_bitwise(mode, tmp_path):
    state, data, step, chunk = _scan_setup(tmp_path, mode)
    eager = _clone(state)
    ms = []
    for _ in range(2 * K):
        eager, m = step(eager, data)
        ms.append(m)
    ap = float(np.float32(0.1))
    assert [float(m["alpha_p"]) for m in ms[:K]] == [0.0, 0.0, ap, ap]
    assert [float(m["lr_frac"]) for m in ms[K:]] == [1.0, 0.75, 0.5, 0.25]

    scanned = state
    before = {k: t for k, t in _tensors(state).items()}
    for c in range(2):
        scanned, m = chunk(scanned, data)
        want = S._reduce_scan_metrics(S._stacked(ms[c * K:(c + 1) * K]), mode)
        assert sorted(m) == sorted(S.METRICS)
        for k in S.METRICS:
            assert torch.equal(m[k], want[k]), (c, k, float(m[k]), float(want[k]))
    # donation: the chunk wrote into the state's own tensors
    got = _tensors(scanned)
    assert all(got[k] is t for k, t in before.items())
    assert scanned.step == eager.step == 2 * K
    assert all(o.count == 2 * K for o in scanned.opt.values())
    for k, t in _tensors(eager).items():
        assert torch.equal(got[k], t), k


# --- (2) against JAX's make_scan_train_step ----------------------------------

TOTAL = 8


def _jax_cfg():
    cfg = deterministic_config(zca=True)
    cfg.epochs, cfg.alpha_p_warmup_epochs, cfg.lr_decay_start_frac = 4, 1, 0.25  # spe 2
    return cfg


def _fixed_batch(cfg, data):
    rng = np.random.RandomState(5)
    b = cfg.batch_size

    def stream():
        il = rng.randint(0, len(data.x_label), b)
        return {"x_l": data.x_label[il], "y_l": data.y_label[il],
                "z": rng.normal(size=(b, cfg.z_dim)).astype(np.float32),
                "y_g": rng.randint(0, cfg.num_classes, b).astype(np.int32),
                "x_u": data.x_unlabel[rng.randint(0, len(data.x_unlabel), b)]}
    return {"d": stream(), "c": stream(),
            "g": {"z": rng.normal(size=(b, cfg.z_dim)).astype(np.float32),
                  "y_g": rng.randint(0, cfg.num_classes, b).astype(np.int32)}}


@pytest.fixture(scope="module", params=["last", "mean"])
def jax_scan(request):
    mode = request.param
    cfg = _jax_cfg()
    data = synthetic_dataset(cfg.image_size, cfg.channels, cfg.num_classes, n_train=1024,
                             n_test=8, num_labeled=cfg.num_labeled, seed=0)
    zca = jax_fit_zca(data.x_unlabel)
    nets = jax_make_networks(cfg)
    opts = jax_make_optimizers(cfg, TOTAL)
    state = jax_create_state(cfg, nets, opts)
    init = jax.tree.map(np.asarray, (state.params, state.bn))
    batch = _fixed_batch(cfg, data)
    step = JS.make_train_step(cfg, nets, opts, TOTAL, zca_stats=zca, pseudo_label_mode="argmax")
    scanned = jax.jit(JS.make_scan_train_step(step, K, mode))
    state, m = scanned(state, jax.tree.map(jnp.asarray, batch))
    return dict(cfg=cfg, mode=mode, zca=zca, init=init, batch=batch,
                metrics={k: float(v) for k, v in m.items()},
                params=jax.tree.map(np.asarray, state.params), bn=jax.tree.map(np.asarray, state.bn))


def test_chunk_matches_jax_scan_train_step(jax_scan, tmp_path):
    run = jax_scan
    cfg = _port_cfg(run["cfg"], tmp_path)
    nets = port_base.make_networks(cfg)
    opts = make_optimizers(cfg, TOTAL)
    trees = {p: bridge.nested(sd) for p, sd in bridge.from_jax(*run["init"]).items()}
    state = create_state(cfg, nets, opts, device="cpu", params={p: t[0] for p, t in trees.items()},
                         bn={p: t[1] for p, t in trees.items()})
    step = S.make_train_step(cfg, nets, opts, TOTAL, zca_stats=run["zca"], pseudo_label_mode="argmax")
    batch = {s: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for s, d in run["batch"].items()}
    state, m = S.make_scan_train_step(step, K, run["mode"])(state, batch)
    assert state.step == K and sorted(m) == sorted(run["metrics"])
    for k, want in run["metrics"].items():
        assert abs(float(m[k]) - want) <= 1e-5 * (1 + abs(want)), (k, float(m[k]), want)
    if run["mode"] == "last":
        assert float(m["alpha_p"]) == pytest.approx(0.1) and float(m["lr_frac"]) == pytest.approx(5 / 6)
    params, bn = bridge.to_jax({p: bridge.flat(state.params[p], state.bn[p]) for p in ("gen", "disc", "clf")})
    lr = float(cfg.lr_c)
    for player in ("gen", "disc", "clf"):
        errs = np.concatenate([np.abs(params[player][layer][name] - want).ravel()
                               for layer, arrays in run["params"][player].items()
                               for name, want in arrays.items()])
        assert errs.max() <= 2 * K * lr, (player, errs.max())
        assert np.mean(errs <= lr / 100) >= 0.99, (player, np.mean(errs <= lr / 100))
        for layer, arrays in run["bn"][player].items():
            for name, want in arrays.items():
                np.testing.assert_allclose(bn[player][layer][name], want, rtol=K / 3 * 1e-4,
                                           atol=K / 3 * 1e-4)


# --- (3) the metrics' reduction --------------------------------------------------

@pytest.mark.parametrize("mode", ["last", "mean"])
def test_reduce_scan_metrics_matches_jax(mode):
    rng = np.random.RandomState(7)
    stacked = {k: (rng.normal(size=K) * 10 ** rng.randint(-3, 3)).astype(np.float32) for k in S.METRICS}
    got = S._reduce_scan_metrics({k: torch.from_numpy(v) for k, v in stacked.items()}, mode)
    want = JS._reduce_scan_metrics({k: jnp.asarray(v) for k, v in stacked.items()}, mode)
    assert sorted(got) == sorted(want)
    for k in stacked:
        assert got[k].shape == () and got[k].dtype == torch.float32
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-7, atol=0)
    with pytest.raises(ValueError, match="last|mean"):
        S._reduce_scan_metrics({k: torch.from_numpy(v) for k, v in stacked.items()}, "median")
    with pytest.raises(ValueError, match="last|mean"):
        JS._reduce_scan_metrics({k: jnp.asarray(v) for k, v in stacked.items()}, "median")
    with pytest.raises(ValueError, match="last|mean"):
        S.ScanChunk(None, K, "median")


# --- (4) nothing of the step is read on the host -----------------------------------

class _HostReadProbe(torch.Tensor):
    """A tensor that raises when the host reads its value; what is computed
    from it is a probe too."""

    def _refuse(self, *args, **kwargs):
        raise RuntimeError("the host read a value computed from the step's scalars")

    __int__ = __float__ = __bool__ = __index__ = item = tolist = numpy = _refuse


@pytest.mark.parametrize("share", [False, True], ids=["share_off", "share_on"])
def test_step_body_reads_nothing_of_the_step_on_the_host(share, tmp_path):
    state, data, step, _ = _scan_setup(tmp_path, "last")
    if share:
        cfg = _port_cfg(tiny_config(zca=False, share_pseudo_forward=True, data_on_device=True), tmp_path)
        cfg.epochs, cfg.alpha_p_warmup_epochs = 4, 1
        nets = port_base.make_networks(cfg)
        opts = make_optimizers(cfg, 8)
        state = create_state(cfg, nets, opts, device="cpu")
        step = S.make_device_train_step(cfg, nets, opts, 8)
    state = dataclasses.replace(state, step=3, opt={p: AdamState(3, o.mu, o.nu) for p, o in state.opt.items()})
    probe = step.scalars(state)[0].as_subclass(_HostReadProbe)
    assert probe.shape == (len(S.SCALARS),)
    with pytest.raises(RuntimeError, match="host read"):
        float(probe[0] + 1)
    new, m = step.body(_clone(state), data, step.generators(torch.device("cpu"), state.seed, 3), probe)
    # the schedules' values came from the probe, and equal the eager step's
    assert isinstance(m["alpha_p"], _HostReadProbe) and isinstance(m["lr_frac"], _HostReadProbe)
    with pytest.raises(RuntimeError, match="host read"):
        float(m["alpha_p"])
    want_state, want = step(_clone(state), data)
    for k in S.METRICS:
        assert torch.equal(m[k].as_subclass(torch.Tensor), want[k]), k
    got = _tensors(new)
    for k, t in _tensors(want_state).items():
        assert torch.equal(got[k].as_subclass(torch.Tensor), t), k


# --- (5) the chunked loop ----------------------------------------------------------

@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setattr(loop, "MetricsLogger", functools.partial(MetricsLogger, use_tensorboard=False))


def _driver_cfg(tmp_path, name, **overrides):
    jcfg = tiny_config(data_on_device=True, eval_every_epochs=1, ckpt_every_epochs=2, log_every=3)
    cfg = _port_cfg(jcfg, tmp_path)
    for k in port_base.EXEC_KEYS - {"workdir", "data_dir", "use_pallas"}:  # not merged from config.json
        cfg[k] = jcfg[k]
    cfg.workdir = str(tmp_path / name)
    cfg.update(overrides)
    return jcfg, cfg


def _events(run_dir):
    import json

    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    return ([r["step"] for r in recs if "loss_c" in r], [r["step"] for r in recs if "test_error" in r],
            sorted(n for n in os.listdir(run_dir) if n.endswith(".png")),
            sorted(int(n) for n in os.listdir(os.path.join(run_dir, "ckpt")) if n.isdigit()))


def test_chunked_loop_ends_in_the_single_step_checkpoint_bitwise(tmp_path):
    runs = {}
    for chunk in (1, 4):
        _, cfg = _driver_cfg(tmp_path, f"scan{chunk}", scan_steps=chunk, scan_metrics="mean")
        runs[chunk] = loop.train(cfg, max_steps=10, verbose=False, device="cpu")
    a, b = (torch.load(os.path.join(runs[c]["workdir"], "ckpt", "10"), weights_only=True) for c in (1, 4))

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            v = tree[k]
            yield from leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]

    la, lb = dict(leaves(a)), dict(leaves(b))
    assert sorted(la) == sorted(lb)
    for k, v in la.items():
        assert (torch.equal(v, lb[k]) if isinstance(v, torch.Tensor) else v == lb[k]), k
    assert runs[1]["test_error"] == runs[4]["test_error"]
    # chunks at 0→4, 4→8 and single steps 8→9, 9→10: logs at the first
    # boundary past each multiple of 3, and at the end
    assert _events(runs[4]["workdir"])[0] == [4, 8, 9, 10]


@pytest.fixture(scope="module")
def jax_scan_schedule(tmp_path_factory):
    """One JAX ``train()`` of 10 steps at scan_steps=3 (4 steps an epoch)."""
    tmp = tmp_path_factory.mktemp("jax_scan_train")
    jcfg, _ = _driver_cfg(tmp, "unused")
    jcfg.scan_steps = 3
    jcfg.workdir = str(tmp / "jax")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_loop, "MetricsLogger", functools.partial(JaxMetricsLogger, use_tensorboard=False))
    try:
        result = jax_loop.train(jcfg, max_steps=10, verbose=False)
    finally:
        mp.undo()
    return _events(result["workdir"])


def test_chunked_loop_cadence_matches_jax(jax_scan_schedule, tmp_path):
    _, cfg = _driver_cfg(tmp_path, "port", scan_steps=3)
    result = loop.train(cfg, max_steps=10, verbose=False, device="cpu")
    assert result["steps"] == 10 and not result["preempted"]
    got = _events(result["workdir"])
    # chunks end at 3, 6, 9, a single step at 10: logs at 3, 6, 9, 10;
    # epochs end inside the chunks to 6 and 9 (evals there, and at the end);
    # the epoch-2 checkpoint at 9, and the final one
    assert got == jax_scan_schedule
    assert got == ([3, 6, 9, 10], [6, 9, 10], ["samples_00000006.png", "samples_00000009.png"], [9, 10])
