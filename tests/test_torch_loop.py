"""The port's train driver and what it is made of, against the JAX package
on the CPU: ``data/datasets.py::load_dataset``, ``data/pipeline.py``'s test
batches, ``eval/sample.py``'s grid and PNG, ``configs/base.py``'s
``save_config``/``merge_saved`` across the two packages, ``evaluate_error``
on bridged weights, and ``train/loop.py::train``: its schedule of logs,
evals, sample grids and checkpoints against one JAX ``train()`` run of the
same tiny config; 4 + 4 resumed steps equal to 8 straight ones bitwise in
both arms; a stop (STOP file or SIGTERM) that checkpoints and resumes; the
host-streamed path (``data_on_device=False``: the sampler's batches from
seed + step, ddinit once before the first step, fused_clf_forward, a
resume); the per-call layer variants through the driver; and the options
not ported yet (meshes), which raise.

Sizes are ``tests/helpers.py::tiny_config``'s (16 px, a few channels),
mirrored into the port's config through the JAX ``save_config`` and the
port's ``merge_saved``; ``data_on_device=True``; one thread.
"""

import functools
import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tests.helpers import tiny_config  # noqa: E402
from triplegan_tpu.configs.base import make_networks as jax_make_networks  # noqa: E402
from triplegan_tpu.configs.base import merge_saved as jax_merge_saved  # noqa: E402
from triplegan_tpu.configs.base import save_config as jax_save_config  # noqa: E402
from triplegan_tpu.configs import base_config as jax_base_config  # noqa: E402
from triplegan_tpu.data import datasets as jax_datasets  # noqa: E402
from triplegan_tpu.data.pipeline import BatchSampler as JaxBatchSampler  # noqa: E402
from triplegan_tpu.eval import metrics as jax_metrics  # noqa: E402
from triplegan_tpu.eval import sample as jax_sample  # noqa: E402
from triplegan_tpu.train import loop as jax_loop  # noqa: E402
from triplegan_tpu.train.schedule import make_optimizers as jax_make_optimizers  # noqa: E402
from triplegan_tpu.train.state import create_state as jax_create_state  # noqa: E402
from triplegan_tpu.train.step import make_eval_step as jax_make_eval_step  # noqa: E402
from triplegan_tpu.utils.logging import MetricsLogger as JaxMetricsLogger  # noqa: E402
from triplegan_tpu_torch import bridge  # noqa: E402
from triplegan_tpu_torch.configs import base as port_base  # noqa: E402
from triplegan_tpu_torch.data import datasets  # noqa: E402
from triplegan_tpu_torch.data.pipeline import BatchSampler  # noqa: E402
from triplegan_tpu_torch.eval import metrics, sample  # noqa: E402
from triplegan_tpu_torch.train import loop  # noqa: E402
from triplegan_tpu_torch.train import step as S  # noqa: E402
from triplegan_tpu_torch.train.schedule import make_optimizers  # noqa: E402
from triplegan_tpu_torch.train.state import create_state  # noqa: E402
from triplegan_tpu_torch.utils.logging import MetricsLogger  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """JSONL logs only: importing a TensorBoard writer costs seconds."""
    monkeypatch.setattr(loop, "MetricsLogger", functools.partial(MetricsLogger, use_tensorboard=False))


def _port_cfg(jcfg, tmp_path):
    path = str(tmp_path / "jax_config.json")
    jax_save_config(jcfg, path)
    return port_base.merge_saved(port_base.base_config(), path)


def _write_shards(data_dir, dataset, seed=0):
    """Shards in the layout the JAX ``prepare`` writes (int64 labels here:
    the loaders cast them to int32)."""
    rng = np.random.RandomState(seed)
    ddir = os.path.join(data_dir, dataset)
    os.makedirs(ddir)
    for split, n in (("train", 120), ("test", 30)):
        np.savez(os.path.join(ddir, f"{split}.npz"),
                 images=rng.randint(0, 256, size=(n, 8, 8, 3)).astype(np.uint8),
                 labels=rng.randint(0, 10, size=n).astype(np.int64))


def test_load_dataset_matches_jax_bitwise(tmp_path):
    _write_shards(str(tmp_path), "toy")
    a = datasets.load_dataset(str(tmp_path), "toy", num_labeled=40, num_classes=10, seed=3)
    b = jax_datasets.load_dataset(str(tmp_path), "toy", num_labeled=40, num_classes=10, seed=3)
    for k in ("x_label", "y_label", "x_unlabel", "x_test", "y_test"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape and x.flags.c_contiguous, k
        np.testing.assert_array_equal(x, y)
    with pytest.raises(FileNotFoundError, match="python -m triplegan_tpu_torch.cli prepare --dataset nope"):
        datasets.load_dataset(str(tmp_path), "nope", 40)


@pytest.mark.parametrize("batch", [7, 10, 30])
def test_test_batches_match_jax_bitwise(batch, tmp_path):
    data = datasets.synthetic_dataset(8, 3, 10, n_train=50, n_test=30, num_labeled=20)
    got = list(BatchSampler(data, batch).test_batches())
    want = list(JaxBatchSampler(jax_datasets.synthetic_dataset(8, 3, 10, n_train=50, n_test=30,
                                                               num_labeled=20), batch, seed=1).test_batches())
    assert len(got) == len(want) == -(-30 // batch)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_uint8_grid_matches_jax_bitwise():
    x = np.random.RandomState(0).uniform(-1.2, 1.2, size=(12, 5, 4, 3)).astype(np.float32)
    x[0, 0, 0] = [-1.0, 1.0, 0.0]
    want = jax_sample.to_uint8_grid(jnp.asarray(x), 3, 4)
    for images in (x, torch.from_numpy(x)):
        got = sample.to_uint8_grid(images, 3, 4)
        assert got.dtype == np.uint8 and got.shape == (15, 16, 3)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="cannot fill"):
        sample.to_uint8_grid(x, 4, 4)


@pytest.mark.parametrize("shape", [(9, 14, 3), (9, 14, 1), (9, 14)])
def test_png_decodes_to_the_pixels(shape, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    pixels = np.random.RandomState(1).randint(0, 256, size=shape).astype(np.uint8)
    path = str(tmp_path / "g.png")
    sample.save_png(pixels, path)
    with Image.open(path) as im:
        assert im.mode == ("RGB" if shape[-1] == 3 else "L")
        np.testing.assert_array_equal(np.asarray(im), pixels if shape[-1] == 3 else pixels.reshape(shape[:2]))


def test_config_json_round_trips_across_the_packages(tmp_path):
    jcfg = tiny_config(batch_size=12, compute_dtype="bfloat16")
    jcfg.gen.widths = (24, 12)
    jcfg.clf.conv_blocks = ((8,), (16, 16))
    jcfg.workdir = "/elsewhere"  # an execution key: never merged
    jpath, ppath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jax_save_config(jcfg, jpath)
    pcfg = port_base.merge_saved(port_base.base_config(), jpath)
    assert pcfg.workdir == port_base.base_config().workdir
    port_base.save_config(pcfg, ppath)
    with open(ppath) as f:
        text = f.read()
    assert list(json.loads(text)) == sorted(json.loads(text))  # keys sorted, as JAX writes them
    back = jax_merge_saved(jax_base_config(), ppath)
    mine = json.loads(text)
    theirs = json.loads(json.dumps(back.to_dict(), default=list))
    for k in set(mine) - port_base.EXEC_KEYS:
        assert mine[k] == theirs[k], k
    assert back.clf.conv_blocks == ((8,), (16, 16)) and back.gen.widths == (24, 12)
    again = port_base.merge_saved(port_base.base_config(), ppath)
    assert again.clf.conv_blocks == ((8,), (16, 16)) and again.compute_dtype == "bfloat16"
    assert "compute_dtype" in port_base.display(again) and "gen.widths" in port_base.display(again)


def test_evaluate_error_matches_jax_count_for_count(tmp_path):
    """The classifier's test error through the driver's test stream, on the
    JAX package's initial weights carried over by the bridge: the same
    correct count in every batch (the last one padded and masked)."""
    jcfg = tiny_config(batch_size=12)
    cfg = _port_cfg(jcfg, tmp_path)
    jdata = jax_datasets.synthetic_dataset(16, 3, 10, n_train=64, n_test=128, num_labeled=40)
    data = datasets.synthetic_dataset(16, 3, 10, n_train=64, n_test=128, num_labeled=40)
    nets = jax_make_networks(jcfg)
    jstate = jax_create_state(jcfg, nets, jax_make_optimizers(jcfg, 1))
    jstep = jax.jit(jax_make_eval_step(jcfg, nets, None))
    jbatches = list(jax_loop._test_stream(JaxBatchSampler(jdata, 12), None))
    want = [int(jstep(jstate, b)["correct"]) for b in jbatches]
    want_err = jax_metrics.evaluate_error(jstep, jstate, iter(jbatches))

    port = bridge.from_jax(jax.tree.map(np.asarray, jstate.params), jax.tree.map(np.asarray, jstate.bn))
    trees = {p: bridge.nested(sd) for p, sd in port.items()}
    tnets = port_base.make_networks(cfg)
    state = create_state(cfg, tnets, make_optimizers(cfg, 1), device="cpu",
                         params={p: t[0] for p, t in trees.items()}, bn={p: t[1] for p, t in trees.items()})
    step = S.make_eval_step(cfg, tnets, None)
    batches = list(loop._test_stream(BatchSampler(data, 12), torch.device("cpu")))
    assert [int(step(state, b)["correct"]) for b in batches] == want
    assert len(want) == 11 and float(batches[-1]["mask"].sum()) == 128 - 10 * 12
    assert metrics.evaluate_error(step, state, iter(batches)) == want_err
    assert metrics.evaluate_error(step, state, iter([])) == 1.0


# --- the driver ----------------------------------------------------------

def _driver_cfg(tmp_path, name, **overrides):
    """tiny_config with the data on the device, ZCA on (fitted on the
    synthetic pool and cached in the run dir), an eval and grid every
    epoch, a checkpoint every 2 epochs, a log every 3 steps."""
    jcfg = tiny_config(data_on_device=True, eval_every_epochs=1, ckpt_every_epochs=2, log_every=3)
    cfg = _port_cfg(jcfg, tmp_path)
    for k in port_base.EXEC_KEYS - {"workdir", "data_dir", "use_pallas"}:  # not merged from config.json
        cfg[k] = jcfg[k]
    cfg.workdir, cfg.zca = str(tmp_path / name), True
    cfg.update(overrides)
    return jcfg, cfg


def _events(run_dir):
    """(steps with metrics, the metric names, steps with a test error,
    sample grids, checkpoints) of a run dir."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    logged = [r for r in recs if "loss_c" in r]
    names = {frozenset(r) for r in logged}
    return ([r["step"] for r in logged], names, [r["step"] for r in recs if "test_error" in r],
            sorted(n for n in os.listdir(run_dir) if n.endswith(".png")),
            sorted(int(n) for n in os.listdir(os.path.join(run_dir, "ckpt")) if n.isdigit()))


@pytest.fixture(scope="module")
def jax_schedule(tmp_path_factory):
    """One JAX ``train()`` of 10 steps of the tiny config (4 an epoch)."""
    tmp = tmp_path_factory.mktemp("jax_train")
    jcfg, _ = _driver_cfg(tmp, "unused")
    jcfg.zca = False
    jcfg.workdir = str(tmp / "jax")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_loop, "MetricsLogger", functools.partial(JaxMetricsLogger, use_tensorboard=False))
    try:
        result = jax_loop.train(jcfg, max_steps=10, verbose=False)
    finally:
        mp.undo()
    return result, _events(result["workdir"])


def test_schedule_of_logs_evals_grids_and_checkpoints_matches_jax(jax_schedule, tmp_path):
    want_result, want = jax_schedule
    _, cfg = _driver_cfg(tmp_path, "port")
    cfg.zca = False
    result = loop.train(cfg, max_steps=10, verbose=False, device="cpu")
    assert sorted(result) == sorted(want_result)
    assert result["steps"] == 10 and not result["preempted"]
    got = _events(result["workdir"])
    # logs at 3, 6, 9 and the last step; errors at each epoch's end and a
    # re-eval of the last (mid-epoch) state; grids at the epochs' ends;
    # checkpoints at epoch 2 and the end
    assert got == want
    assert got[0] == [3, 6, 9, 10] and got[2] == [4, 8, 10] and got[4] == [8, 10]
    assert sorted(result["metrics"]) == sorted(want_result["metrics"])
    assert os.path.exists(os.path.join(result["workdir"], "config.json"))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_four_plus_four_resumed_steps_equal_eight_bitwise(use_pallas, tmp_path):
    def run(name, *max_steps):
        _, cfg = _driver_cfg(tmp_path, name, use_pallas=use_pallas)
        for n in max_steps:
            result = loop.train(cfg, max_steps=n, verbose=False, device="cpu")
        return result

    straight = run("straight", 8)
    resumed = run("resumed", 4, 4)
    a, b = straight["state"], resumed["state"]
    assert a.step == b.step == 8 and a.seed == b.seed
    for p in a.params:
        for ta, tb in ((a.params[p], b.params[p]), (a.bn[p], b.bn[p]), (a.opt[p].mu, b.opt[p].mu),
                       (a.opt[p].nu, b.opt[p].nu)):
            for layer in ta:
                for k in ta[layer]:
                    assert torch.equal(ta[layer][k], tb[layer][k]), (p, layer, k)
        assert a.opt[p].count == b.opt[p].count == 8
    assert straight["test_error"] == resumed["test_error"]
    assert straight["metrics"] == resumed["metrics"]
    # the run dir's ZCA stats were fitted once and reused by the resume
    assert os.path.exists(os.path.join(resumed["workdir"], "zca_stats.npz"))


@pytest.mark.parametrize("how", ["stop_file", "sigterm"])
def test_a_stop_checkpoints_skips_the_final_eval_and_resumes(how, tmp_path, monkeypatch):
    """A STOP file made (or SIGTERM raised) after step 3: the run stops at
    the top of the next iteration, logs no final eval, checkpoints step 3
    and says preempted; a stale STOP is removed when the run is started
    again, and that run resumes from step 3."""
    _, cfg = _driver_cfg(tmp_path, "run")
    run_dir = os.path.join(cfg.workdir, cfg.name)
    real = loop.make_device_train_step

    def stopping_after_3(*args, **kwargs):
        step = real(*args, **kwargs)

        def wrapped(state, data):
            new, m = step(state, data)
            if new.step == 3:
                if how == "stop_file":
                    open(os.path.join(run_dir, "STOP"), "w").close()
                else:
                    signal.raise_signal(signal.SIGTERM)
            return new, m
        return wrapped

    monkeypatch.setattr(loop, "make_device_train_step", stopping_after_3)
    before = signal.getsignal(signal.SIGTERM)
    result = loop.train(cfg, max_steps=10, verbose=False, device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before  # restored after the save
    assert result["preempted"] and result["steps"] == 3 and result["test_error"] is None
    logged, _, evals, grids, ckpts = _events(run_dir)
    assert logged == [3] and evals == [] and grids == [] and ckpts == [3]
    monkeypatch.setattr(loop, "make_device_train_step", real)
    if how == "sigterm":
        open(os.path.join(run_dir, "STOP"), "w").close()  # stale: removed at start
    again = loop.train(cfg, max_steps=2, verbose=False, device="cpu")
    assert not again["preempted"] and again["steps"] == 5
    assert not os.path.exists(os.path.join(run_dir, "STOP"))
    assert _events(run_dir)[4] == [3, 5]


@pytest.mark.parametrize("knob,value,item", [
    ("mesh_shape", (2,), "needs 2 processes"),
    ("multihost", True, "MASTER_ADDR is not set"),
])
def test_options_not_ported_raise(knob, value, item, tmp_path, monkeypatch):
    """A mesh (or multihost) run started as one process, with no process
    group and no torchrun environment, raises naming the torchrun command
    before any work: it never trains unsharded."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    _, cfg = _driver_cfg(tmp_path, "run")
    cfg[knob] = value
    with pytest.raises(RuntimeError, match=f"{item}.*torchrun --nproc-per-node"):
        loop.train(cfg, max_steps=1, verbose=False, device="cpu")
    assert not os.path.exists(os.path.join(cfg.workdir, cfg.name))  # raised before any work


@pytest.mark.parametrize("var,value", [
    ("TRIPLEGAN_DROPOUT_BITS", "16"),
    ("TRIPLEGAN_MAXPOOL", "windows"),
    ("TRIPLEGAN_SMALLCIN", "conv"),
    ("TRIPLEGAN_DECONV", "conv_transpose"),
])
def test_env_values_the_jax_layers_ignore_are_accepted(var, value, tmp_path, monkeypatch):
    """A value of a layer variable with which the JAX package still
    computes its default layer leaves the port building its networks; for
    the dropout, JAX's mask under it equals its default mask."""
    _, cfg = _driver_cfg(tmp_path, "run")
    monkeypatch.setenv(var, value)
    port_base.make_networks(cfg)
    if var == "TRIPLEGAN_DROPOUT_BITS":
        from triplegan_tpu.nn.layers import dropout

        x, key = jnp.ones((4, 64)), jax.random.PRNGKey(3)
        under = np.asarray(dropout(key, x, 0.5, train=True))
        monkeypatch.delenv(var)
        np.testing.assert_array_equal(under, np.asarray(dropout(key, x, 0.5, train=True)))


@pytest.mark.parametrize("var,value", [
    ("TRIPLEGAN_DROPOUT_BITS", "8"),
    ("TRIPLEGAN_SMALLCIN", "patches"),
])
def test_env_variants_train_through_the_driver(var, value, tmp_path, monkeypatch):
    """The per-call layer variants run through ``train`` (two steps, the
    host-streamed path): the 8-bit dropout draws other masks, so the
    metrics differ from the default layer's; the patches conv computes the
    same sums in another order (the metrics within 1e-5·(1 + |m|)), and
    runs."""
    from triplegan_tpu_torch.nn import layers as L

    _, cfg = _driver_cfg(tmp_path, "default", data_on_device=False, zca=False)
    base = loop.train(cfg, max_steps=2, verbose=False, device="cpu")
    monkeypatch.setenv(var, value)
    calls = []
    real = L._conv3x3_patches
    monkeypatch.setattr(L, "_conv3x3_patches", lambda *a: calls.append(1) or real(*a))
    _, cfg = _driver_cfg(tmp_path, "variant", data_on_device=False, zca=False)
    got = loop.train(cfg, max_steps=2, verbose=False, device="cpu")
    assert got["steps"] == 2 and all(np.isfinite(v) for v in got["metrics"].values())
    if var == "TRIPLEGAN_DROPOUT_BITS":
        assert got["metrics"] != base["metrics"] and not calls
    else:
        assert calls
        for k, v in base["metrics"].items():
            assert abs(got["metrics"][k] - v) <= 1e-5 * (1 + abs(v)), k


def _recording_step(monkeypatch, seen):
    """Wrap the loop's host-streamed step to keep each batch it is fed."""
    real = loop.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def wrapped(state, batch):
            seen.append({s: {k: v.clone() for k, v in d.items()} for s, d in batch.items()})
            return step(state, batch)
        return wrapped

    monkeypatch.setattr(loop, "make_train_step", make)


@pytest.mark.parametrize("share", [False, True], ids=["share_off", "share_on"])
def test_host_streamed_batches_are_the_samplers_from_seed_plus_step(share, tmp_path, monkeypatch):
    """``data_on_device=False``: each step gets the next ``triple_iter``
    batch of a ``BatchSampler`` seeded ``seed + step`` (a resume draws a
    fresh continuation, as JAX's loop does), bitwise, as CPU tensors; under
    share_pseudo_forward the C stream has no x_u."""
    seen = []
    _recording_step(monkeypatch, seen)
    _, cfg = _driver_cfg(tmp_path, "run", data_on_device=False, share_pseudo_forward=share, zca=False)
    data = loop._resolve_data(cfg)
    loop.train(cfg, max_steps=3, verbose=False, device="cpu")
    loop.train(cfg, max_steps=2, verbose=False, device="cpu")
    assert len(seen) == 5
    for start, batches in ((0, seen[:3]), (3, seen[3:])):
        it = JaxBatchSampler(data, cfg.batch_size, seed=cfg.seed + start).triple_iter(
            cfg.z_dim, cfg.num_classes, skip_c_unlabeled=share)
        for got in batches:
            want = next(it)
            assert got.keys() == want.keys() and ("x_u" in got["c"]) == (not share)
            for s in want:
                assert got[s].keys() == want[s].keys()
                for k in want[s]:
                    np.testing.assert_array_equal(got[s][k].numpy(), want[s][k])


def test_host_streamed_ddinit_fused_run_checkpoints_and_resumes(tmp_path, capsys):
    """A host-streamed run with ddinit and fused_clf_forward: ddinit applied
    once, before the first step (its params are the start of the run); the
    resume restores the checkpoint and does not apply it again."""
    _, cfg = _driver_cfg(tmp_path, "run", data_on_device=False, ddinit=True, fused_clf_forward=True,
                         scan_steps=4)
    first = loop.train(cfg, max_steps=4, verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert out.count("applied data-dependent weight-norm init") == 1
    assert first["steps"] == 4 and not first["preempted"]
    assert all(np.isfinite(v) for v in first["metrics"].values())
    again = loop.train(cfg, max_steps=2, verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "applied data-dependent" not in out
    assert again["steps"] == 6
    _, ckpts = _events(again["workdir"])[3:]
    assert ckpts[-1] == 6

    # the params the run started from are ddinit's of the seeded state
    _, plain = _driver_cfg(tmp_path, "ref")
    nets = port_base.make_networks(plain)
    state = create_state(plain, nets, make_optimizers(plain, 16), device="cpu")
    data = loop._resolve_data(plain)
    zca = loop._resolve_zca(plain, data, str(tmp_path / "ref_zca"))
    init = loop._apply_ddinit(plain, nets, state, data, zca, torch.device("cpu"))
    assert not torch.equal(init.params["disc"]["conv0"]["g"], state.params["disc"]["conv0"]["g"])
    real = loop.make_train_step
    starts = []

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def wrapped(st, batch):
            starts.append({k: v.clone() for k, v in st.params["disc"]["conv0"].items()})
            return step(st, batch)
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(loop, "make_train_step", make)
    try:
        _, cfg2 = _driver_cfg(tmp_path, "check", data_on_device=False, ddinit=True, fused_clf_forward=True)
        loop.train(cfg2, max_steps=1, verbose=False, device="cpu")
    finally:
        mp.undo()
    for k, v in init.params["disc"]["conv0"].items():
        assert torch.equal(starts[0][k], v), k


def test_profile_window_writes_a_trace(tmp_path):
    """``profile_dir`` traces ``profile_steps`` steps after two untimed ones
    with torch.profiler and writes a Chrome trace there."""
    _, cfg = _driver_cfg(tmp_path, "run", zca=False, profile_dir=str(tmp_path / "prof"), profile_steps=2)
    result = loop.train(cfg, max_steps=5, verbose=False, device="cpu")
    assert result["steps"] == 5
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
