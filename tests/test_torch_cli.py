"""``python -m triplegan_tpu_torch.cli`` train, eval and sample on the CPU
(``--device cpu``), called in-process through ``cli.main``: a small
mnist100 run on the synthetic dataset trains, logs, evaluates, writes
sample grids and checkpoints; ``eval`` prints the error that ``train``
printed; ``sample`` writes a grid of N classes × M columns; a stopped run
exits 75 and the next resumes; the run dir's ``config.json`` is found as
the JAX CLI finds it (``--set name=...`` names another run); the trained
run is exported (``.pt2``, int8, npz), its artifact qualified by ``eval
--artifact`` (the error ``train`` printed), ``predict`` gives the same
logits from the checkpoint and from the artifact, ``inception`` and
``fid`` score it with its classifier and with the artifact, and ``serve
--config`` serves its checkpoint and, after one more train step,
``POST /reload`` the newer one; and without ``--device cpu`` every
command asks for the card."""

import argparse
import functools
import io
import json
import os
import re
import shutil
import threading
import urllib.request

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


_NEEDS = {"predict": ["--input", "images.npy"]}


@pytest.mark.parametrize("cmd", ["train", "eval", "sample", "inception", "fid", "export", "serve", "predict"])
def test_every_command_asks_for_the_card_by_default(cmd, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    args = [a for a in _args(cmd, tmp_path, *_NEEDS.get(cmd, [])) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)


def _run_cli(capsys, *args):
    """``cli.main(args)`` and the lines it printed."""
    cli.main(list(args))
    return capsys.readouterr().out.strip().splitlines()


@pytest.fixture(scope="module")
def exported(trained, tmp_path_factory):
    """The trained run's pt2 artifacts (batch 8), their int8 twins and its
    npz, through ``cli export``."""
    workdir, _ = trained
    out = tmp_path_factory.mktemp("export")
    for extra in ([], ["--quantize", "int8", "--out", str(out / "int8")], ["--format", "npz"]):
        cli.main(_args("export", workdir, "--out", str(out), *extra, sets=[]))
    return out


def test_export_writes_artifacts_and_eval_artifact_qualifies_them(trained, exported, capsys):
    workdir, printed = trained
    assert sorted(os.listdir(exported)) == ["classify.pt2", "generate.pt2", "int8", "params.npz"]
    assert sorted(os.listdir(exported / "int8")) == ["classify.pt2", "generate.pt2"]
    want = printed[-1].split("test_error=")[1]
    out = _run_cli(capsys, *_args("eval", workdir, "--artifact", str(exported / "classify.pt2"), sets=[]))
    assert out[-1] == "test error (artifact): " + want
    with pytest.raises(SystemExit, match="not a classifier artifact"):
        cli.main(_args("eval", workdir, "--artifact", str(exported / "generate.pt2"), sets=[]))
    with pytest.raises(SystemExit, match="npz stores the raw"):
        cli.main(_args("export", workdir, "--format", "npz", "--quantize", "int8", sets=[]))


def test_predict_from_the_checkpoint_and_the_artifact_agree(trained, exported, tmp_path, capsys):
    workdir, _ = trained
    images = str(tmp_path / "images.npy")
    np.save(images, np.random.RandomState(0).randint(0, 256, size=(11, 28, 28, 1)).astype(np.uint8))
    p1, p2, p3 = (str(tmp_path / f"p{i}.npz") for i in (1, 2, 3))
    out = _run_cli(capsys, *_args("predict", workdir, "--input", images, "--out", p1, sets=[]))
    assert out[-1].startswith(f"predicted 11 images → {p1}")
    cli.main(["predict", "--artifact", str(exported / "classify.pt2"), "--input", images, "--out", p2,
              "--device", "cpu"])
    cli.main(_args("predict", workdir, "--input", images, "--out", p3, "--quantize", "int8", sets=[]))
    with np.load(p1) as a, np.load(p2) as b, np.load(p3) as q:
        np.testing.assert_array_equal(a["logits"], b["logits"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
        assert a["probs"].shape == (11, 10) and np.allclose(a["probs"].sum(axis=1), 1.0)
        assert float(np.abs(q["logits"] - a["logits"]).max()) < 0.05
    bad = str(tmp_path / "bad.npy")
    np.save(bad, np.zeros((2, 28, 28, 1), np.float32))
    with pytest.raises(SystemExit, match="must be uint8"):
        cli.main(_args("predict", workdir, "--input", bad, sets=[]))
    with pytest.raises(SystemExit, match="no such input file"):
        cli.main(_args("predict", workdir, "--input", str(tmp_path / "none.npy"), sets=[]))
    with pytest.raises(SystemExit, match="needs --config"):
        cli.main(["predict", "--input", images, "--device", "cpu"])
    with pytest.raises(SystemExit, match="already quantized"):
        cli.main(["predict", "--artifact", str(exported / "classify.pt2"), "--input", images,
                  "--quantize", "int8", "--device", "cpu"])


def test_inception_and_fid_with_the_classifier_and_the_artifact(trained, exported, capsys):
    workdir, _ = trained
    art = str(exported / "classify.pt2")
    scores = {}
    for label, extra in (("classifier-scored", []), ("external-scored", ["--scorer-path", art])):
        out = _run_cli(capsys, *_args("inception", workdir, "--n-samples", "40", "--n-splits", "2",
                                      *extra, sets=[]))
        m = re.fullmatch(rf"inception score \({label}\): (\S+) ± (\S+)", out[-1])
        assert m, out[-1]
        scores[label] = float(m.group(1))
        assert 1.0 <= scores[label] <= 10.0
    for label, extra in (("classifier GAP features", []), ("external features", ["--scorer-path", art])):
        out = _run_cli(capsys, *_args("fid", workdir, "--n-samples", "40", "--n-real", "24", *extra,
                                      sets=[]))
        m = re.fullmatch(rf"FID \({label}, 40 gen vs 24 real\): (\S+)", out[-1])
        assert m and float(m.group(1)) >= 0.0, out[-1]


def _serve_args(workdir, **kw):
    return argparse.Namespace(**{
        "config": "mnist100", "workdir": str(workdir), "data_dir": None, "set": None, "step": None,
        "device": "cpu", "params": None, "zca": None, "classifier": None, "generator": None,
        "batch_size": None, "quantize": None, **kw})


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read()


def _post(url, body=b""):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/x-npy"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def test_serve_config_serves_the_checkpoint_and_reloads_a_newer_one(trained, tmp_path):
    """``serve --config`` of a port run dir: its newest checkpoint, and after
    one more ``cli train`` step in the same run dir ``POST /reload`` serves
    that one (the step moves in /healthz, and /classify changes)."""
    from triplegan_tpu_torch.serve import make_server

    workdir, _ = trained
    shutil.copytree(workdir, tmp_path / "w")
    app = cli._serve_source(_serve_args(tmp_path / "w"))
    server = make_server(app, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    buf = io.BytesIO()
    np.save(buf, np.random.RandomState(1).randint(0, 256, size=(3, 28, 28, 1)).astype(np.uint8))
    try:
        h = json.loads(_get(base + "/healthz"))
        assert (h["source"], h["step"]) == ("checkpoint", 4) and "reload" in h["endpoints"]
        before = np.load(io.BytesIO(_post(base + "/classify", buf.getvalue())))
        cli.main(_args("train", tmp_path / "w", "--max-steps", "1", sets=[]))
        assert json.loads(_post(base + "/reload")) == {"reloaded": True, "step": 5}
        assert json.loads(_get(base + "/healthz"))["step"] == 5
        after = np.load(io.BytesIO(_post(base + "/classify", buf.getvalue())))
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
    assert before.shape == after.shape == (3, 10)
    assert not np.array_equal(before, after)
    state = cli._restore_run(argparse.Namespace(config="mnist100", workdir=str(tmp_path / "w"), data_dir=None,
                                                set=None, step=None, device="cpu"), mesh=False)
    from triplegan_tpu_torch.export import make_serving_fns

    cfg, nets, restored, wd, _, _ = state
    classify, _ = make_serving_fns(cfg, nets, restored, zca_stats=cli._load_zca(cfg, wd), device="cpu")
    images = torch.from_numpy(np.load(io.BytesIO(buf.getvalue())))
    np.testing.assert_array_equal(after, classify(images).numpy())
