"""``python -m triplegan_tpu_torch.cli`` train, eval and sample on the CPU
(``--device cpu``), called in-process through ``cli.main``: a small
mnist100 run on the synthetic dataset trains, logs, evaluates, writes
sample grids and checkpoints; ``eval`` prints the error that ``train``
printed; ``sample`` writes a grid of N classes × M columns; a stopped run
exits 75 and the next resumes; the run dir's ``config.json`` is found as
the JAX CLI finds it (``--set name=...`` names another run); and without
``--device cpu`` every command asks for the card."""

import argparse
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from triplegan_tpu_torch import cli  # noqa: E402
from triplegan_tpu_torch.configs import get_config  # noqa: E402
from triplegan_tpu_torch.configs.base import save_config  # noqa: E402
from triplegan_tpu_torch.train import loop  # noqa: E402
from triplegan_tpu_torch.utils.logging import MetricsLogger  # noqa: E402

torch.set_num_threads(1)

SMALL = ["dataset=synthetic", "batch_size=8", "z_dim=16", "gen.widths=(16,8)", "disc.widths=(8,8,16,16)",
         "clf.conv_blocks=((8,8),(16,16))", "clf.tail=(16,8)", "epochs=3", "steps_per_epoch=2",
         "log_every=1", "eval_every_epochs=1", "ckpt_every_epochs=1"]


def _args(cmd, workdir, *extra, sets=SMALL):
    out = [cmd, "--config", "mnist100", "--workdir", str(workdir), "--device", "cpu"]
    for kv in sets:
        out += ["--set", kv]
    return out + list(extra)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setattr(loop, "MetricsLogger", functools.partial(MetricsLogger, use_tensorboard=False))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One ``cli train`` of 4 steps (2 epochs) and what it printed."""
    workdir = tmp_path_factory.mktemp("cli")
    mp = pytest.MonkeyPatch()
    mp.setattr(loop, "MetricsLogger", functools.partial(MetricsLogger, use_tensorboard=False))
    capture = []
    mp.setattr("builtins.print", lambda *a, **k: capture.append(" ".join(str(x) for x in a)))
    try:
        cli.main(_args("train", workdir, "--max-steps", "4"))
    finally:
        mp.undo()
    return workdir, capture


def test_train_logs_evaluates_samples_and_checkpoints(trained):
    workdir, printed = trained
    run = os.path.join(workdir, "mnist100")
    assert printed[-1].startswith("done: step=4 test_error=")
    assert [ln.split()[1] for ln in printed if ln.startswith("step ")] == ["1/6", "2/6", "3/6", "4/6"]
    assert sorted(n for n in os.listdir(run) if n.endswith(".png")) == ["samples_00000002.png",
                                                                       "samples_00000004.png"]
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["2", "4"]
    assert os.path.exists(os.path.join(run, "config.json")) and os.path.exists(os.path.join(run, "metrics.jsonl"))


def test_eval_prints_the_error_train_printed(trained, capsys):
    workdir, printed = trained
    cli.main(_args("eval", workdir, sets=[]))  # the run's config.json supplies the rest
    err = capsys.readouterr().out.strip().splitlines()[-1]
    assert err == "test error: " + printed[-1].split("test_error=")[1]
    cli.main(_args("eval", workdir, "--step", "2", sets=[]))
    assert capsys.readouterr().out.strip().startswith("test error: ")
    with pytest.raises(SystemExit, match=r"no checkpoint for step 3 \(available: \[2, 4\]\)"):
        cli.main(_args("eval", workdir, "--step", "3", sets=[]))


@pytest.mark.parametrize("n_per_class", [1, 3])
def test_sample_writes_a_classes_by_columns_grid(trained, n_per_class, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    workdir, _ = trained
    out = str(tmp_path / "grid.png")
    cli.main(_args("sample", workdir, "--out", out, "--n-per-class", str(n_per_class), sets=[]))
    with Image.open(out) as im:
        assert im.mode == "L"  # mnist is one channel
        pixels = np.asarray(im)
    assert pixels.shape == (10 * 28, n_per_class * 28)
    assert pixels.min() < pixels.max()


def test_eval_of_an_empty_run_dir_says_so(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint under"):
        cli.main(_args("eval", tmp_path))


def test_a_stopped_train_exits_75_and_the_next_resumes(tmp_path, monkeypatch, capsys):
    real = loop.make_device_train_step
    run = os.path.join(tmp_path, "mnist100")

    def stop_after_first(*args, **kwargs):
        step = real(*args, **kwargs)

        def wrapped(state, data):
            out = step(state, data)
            open(os.path.join(run, "STOP"), "w").close()
            return out
        return wrapped

    monkeypatch.setattr(loop, "make_device_train_step", stop_after_first)
    with pytest.raises(SystemExit) as exc:
        cli.main(_args("train", tmp_path, "--max-steps", "4"))
    assert exc.value.code == 75
    assert "preempted" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["1"]
    monkeypatch.setattr(loop, "make_device_train_step", real)
    cli.main(_args("train", tmp_path, "--max-steps", "1"))
    out = capsys.readouterr().out
    assert "resumed from step 1" in out and "done: step=2 " in out


def _ns(**kw):
    return argparse.Namespace(**{"workdir": None, "data_dir": None, "set": None, **kw})


def test_run_dir_config_is_found_with_the_overrides_applied(tmp_path):
    """As the JAX CLI does: ``--set name=other`` merges other's config.json
    (here z_dim 12), ``--set workdir=...`` looks there, and ``--data-dir``
    and ``--workdir`` win over what the saved config says."""
    saved = get_config("mnist100")
    saved.name, saved.z_dim = "other", 12
    save_config(saved, str(tmp_path / "other" / "config.json"))
    cfg = cli._load_cfg(_ns(config="mnist100", workdir=str(tmp_path), set=["name=other"]))
    assert (cfg.name, cfg.z_dim, cfg.workdir) == ("other", 12, str(tmp_path))
    cfg = cli._load_cfg(_ns(config="mnist100", set=[f"workdir={tmp_path}", "name=other"],
                            data_dir="/data"))
    assert (cfg.z_dim, cfg.data_dir) == (12, "/data")
    assert cli._load_cfg(_ns(config="mnist100", workdir=str(tmp_path))).z_dim == 100  # its own run dir: none
    with pytest.raises(SystemExit, match="unknown config 'nope'"):
        cli._load_cfg(_ns(config="nope"))


@pytest.mark.parametrize("cmd", ["train", "eval", "sample"])
def test_every_command_asks_for_the_card_by_default(cmd, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    args = [a for a in _args(cmd, tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)
