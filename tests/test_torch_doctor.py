"""The port's deployment diagnostics (``triplegan_tpu_torch/doctor.py``,
``cli doctor``) on the CPU: the CPU cases of the JAX package's
``tests/test_doctor.py``, with the port's findings held to the JAX
doctor's levels on the same config and files, and JAX's exit codes (1 if
and only if a check fails). The device probe runs in a subprocess: asked
for the CPU it runs the kernels' plain versions and says so; asked for a
card on a machine without one it is a fail, never a CPU run reported as
a card run; a hung probe is a fail, not a hang."""

import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.helpers import tiny_config  # noqa: E402
from triplegan_tpu import doctor as jax_doctor  # noqa: E402
from triplegan_tpu.configs.base import save_config  # noqa: E402
from triplegan_tpu_torch import doctor  # noqa: E402
from triplegan_tpu_torch.configs import base as port_base  # noqa: E402

torch.set_num_threads(1)


def _cfgs(tmp_path, **overrides):
    """(the port's config, the JAX package's) for the same tiny config."""
    jcfg = tiny_config(**overrides)
    jcfg.workdir = str(tmp_path)
    path = str(tmp_path / "jax_config.json")
    save_config(jcfg, path)
    return port_base.merge_saved(port_base.base_config(), path), jcfg


def _levels(findings, name=None):
    return [lv for lv, n, _ in findings if name is None or n == name]


def test_run_doctor_synthetic_ok(tmp_path):
    cfg, _ = _cfgs(tmp_path)
    findings = doctor.run_doctor(cfg, str(tmp_path / cfg.name), skip_device=True)
    assert "fail" not in _levels(findings)
    assert _levels(findings, "data") == ["ok"]
    out = doctor.format_findings(findings)
    assert "versions" in out and "mesh" in out and "torch" in out


@pytest.mark.parametrize("dataset", ["mnist", "cifar10"])
def test_check_data_missing_and_corrupt(tmp_path, dataset):
    cfg, jcfg = _cfgs(tmp_path, dataset=dataset, zca=dataset == "cifar10")
    cfg.data_dir = jcfg.data_dir = str(tmp_path)
    findings = doctor.check_data(cfg)
    assert _levels(findings) == _levels(jax_doctor.check_data(jcfg))
    assert _levels(findings, "data") == ["fail", "fail"]
    assert f"python -m triplegan_tpu_torch.cli prepare --dataset {dataset}" in findings[0][2]

    d = tmp_path / dataset
    d.mkdir()
    np.savez(d / "train.npz", images=np.zeros((4, 8, 8, 1), np.float32), labels=np.zeros((4,), np.int32))
    np.savez(d / "test.npz", images=np.zeros((4, 8, 8, 1), np.uint8), labels=np.zeros((3,), np.int32))
    findings = doctor.check_data(cfg)
    assert _levels(findings, "data") == _levels(jax_doctor.check_data(jcfg), "data") == ["fail", "fail"]
    msgs = [m for _, _, m in findings]
    assert any("uint8" in m for m in msgs) and any("4 images vs 3 labels" in m for m in msgs)
    if cfg.zca:  # stats fitted at prepare time count (the loop loads them)
        np.savez(d / "zca_stats.npz", mean=np.zeros(3), whiten=np.eye(3))
        assert _levels(doctor.check_data(cfg), "zca") == ["ok"]


def test_check_mesh_divisibility_cards_and_torchrun(tmp_path):
    cfg, jcfg = _cfgs(tmp_path)
    cfg.mesh_shape = jcfg.mesh_shape = (8,)
    cfg.batch_size = jcfg.batch_size = 12  # not divisible by 8
    assert "fail" in _levels(doctor.check_mesh(cfg, env={}), "mesh")
    cfg.batch_size = jcfg.batch_size = 16
    findings = doctor.check_mesh(cfg, visible_devices=4, env={})
    assert _levels(findings) == _levels(jax_doctor.check_mesh(jcfg, visible_devices=4)) == ["ok", "fail"]
    assert any("only 4 visible" in m for _, _, m in findings)
    assert _levels(doctor.check_mesh(cfg, visible_devices=8, env={})) == ["ok"]
    # under torchrun: the world must be the mesh, and this machine's ranks need cards
    assert _levels(doctor.check_mesh(cfg, 4, env={"WORLD_SIZE": "8", "LOCAL_WORLD_SIZE": "4"})) == ["ok"]
    findings = doctor.check_mesh(cfg, 8, env={"WORLD_SIZE": "4"})
    assert _levels(findings) == ["ok", "fail"] and "torchrun started 4" in findings[1][2]


def test_check_workdir_torn_tmp(tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "100").write_bytes(b"x")
    (ckpt / "200.tmp-123").write_bytes(b"half")
    findings = doctor.check_workdir(str(tmp_path))
    assert any("latest step 100" in m for _, _, m in findings)
    assert any("torn checkpoint tmp" in m for _, _, m in findings)
    assert _levels(doctor.check_workdir(str(tmp_path / "nowhere"))) == ["warn"]


def test_check_device_cpu_probe(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the probe's subprocess runs the plain kernels
    findings, visible, memory = doctor.check_device(timeout_s=300, device="cpu")
    assert findings[0][0] == "ok", findings
    assert "cpu, as asked" in findings[0][2] and "nothing built" in findings[0][2]
    for kernel in ("scale_bias_act", "conv3x3"):
        assert kernel in findings[0][2]
    assert visible == 1 and memory is None


def test_check_device_without_a_card_fails_and_never_reports_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    findings, visible, memory = doctor.check_device(timeout_s=300, device="cuda")
    assert [lv for lv, _, _ in findings] == ["fail"]
    assert "no CUDA device" in findings[0][2] and visible is None and memory is None


def test_check_device_hung_probe_is_a_finding(monkeypatch):
    def hung(*a, **kw):
        raise subprocess.TimeoutExpired(cmd="probe", timeout=kw["timeout"])

    monkeypatch.setattr(subprocess, "run", hung)
    findings, visible, memory = doctor.check_device(timeout_s=7, device="cuda")
    assert findings[0][0] == "fail" and "hung > 7 s" in findings[0][2]
    assert visible is None and memory is None


def test_run_doctor_feeds_visible_cards_and_memory_on(monkeypatch, tmp_path):
    seen = {}

    def fake(timeout_s, device):
        seen["device"] = device
        return [("ok", "device", "1 card(s)")], 1, 1000

    monkeypatch.setattr(doctor, "check_device", fake)
    cfg, _ = _cfgs(tmp_path)
    cfg.mesh_shape = (8,)
    cfg.batch_size = 16
    findings = doctor.run_doctor(cfg, str(tmp_path / cfg.name), device="cuda:0")
    assert seen["device"] == "cuda:0"
    assert any(lv == "fail" and "only 1 visible" in m for lv, n, m in findings if n == "mesh"), findings


def test_check_versions_survives_broken_import(monkeypatch):
    import importlib

    real = importlib.import_module

    def broken(name, *a, **kw):
        if name == "numpy":
            raise ImportError("no module named numpy")
        return real(name, *a, **kw)

    monkeypatch.setattr(importlib, "import_module", broken)
    findings = doctor.check_versions()
    assert any(lv == "fail" and "numpy" in m for lv, _, m in findings)
    assert any(lv == "ok" and "torch" in m for lv, _, m in findings)


def test_cli_doctor_exit_codes(tmp_path, capsys):
    from triplegan_tpu_torch.cli import main

    main(["doctor", "--config", "mnist100", "--workdir", str(tmp_path), "--set", "dataset=synthetic",
          "--skip-device"])
    assert "synthetic dataset" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        main(["doctor", "--config", "mnist100", "--workdir", str(tmp_path),
              "--data-dir", str(tmp_path / "nowhere"), "--skip-device"])
    assert e.value.code == 1
    assert "✗ data" in capsys.readouterr().out


def test_check_memory_thresholds_match_jax(tmp_path):
    cfg, jcfg = _cfgs(tmp_path, dataset="big", data_on_device=True)
    cfg.data_dir = jcfg.data_dir = str(tmp_path)
    d = tmp_path / "big"
    d.mkdir()
    imgs = np.zeros((64, 32, 32, 3), np.uint8)
    np.savez(d / "train.npz", images=imgs, labels=np.zeros((64,), np.int64))
    nbytes = imgs.nbytes + 64 * 8
    assert doctor._npz_nbytes(str(d / "train.npz")) == jax_doctor._npz_nbytes(str(d / "train.npz")) == nbytes
    for limit, level, words in ((nbytes * 10, "ok", "10%"), (int(nbytes / 0.6), "warn", "data_on_device=False"),
                                (nbytes, "fail", "out of memory"), (None, "ok", "GiB")):
        (lv, name, msg), = doctor.check_memory(cfg, memory_bytes=limit)
        (jlv, _, _), = jax_doctor.check_memory(jcfg, hbm_bytes=limit)
        assert (lv, name) == (level, "memory") and lv == jlv and words in msg
    cfg.data_on_device = False
    (lv, _, msg), = doctor.check_memory(cfg)
    assert lv == "ok" and "host-streamed" in msg
    cfg.data_on_device, cfg.dataset = True, "synthetic"
    (lv, _, msg), = doctor.check_memory(cfg)
    assert lv == "ok" and "synthetic" in msg
