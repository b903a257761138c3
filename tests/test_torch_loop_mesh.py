"""The port's train driver (``train/loop.py``) on a mesh of 2 gloo ranks on
the CPU (``run_local_ranks``), against itself on one process: the ports of
JAX's ``tests/test_loop_mesh.py`` (cross-topology restore and resume) and
of ``test_multihost.py``'s end-to-end cases (coordinator-only outputs, one
stop for every rank, a partial mesh refused).

Setting: ``tests/helpers.py::deterministic_config`` (16 px, no noise,
dropout or augmentation) with argmax pseudo-labels and host-streamed
batches (each rank's sampler draws the global batch and keeps its rows,
so both topologies train on the same global batches), 2 steps an epoch, an
eval, a grid and a checkpoint every epoch. One module-scoped 2-rank job
runs every mesh run, in order, on run dirs the parent prepared.

Tolerances: a restore on another topology bitwise (the state is
replicated and a checkpoint holds no trace of the mesh); a resume
continued on one process and on two ranks for N = 4 steps differs only by
the order of float32 sums: every parameter within 2·N·lr (Adam turns a
near-zero gradient into a ±lr step whose sign the last bits decide) and
99% of them within lr/100, as ``tests/test_torch_step.py`` holds the port
to JAX.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tests import torch_mesh_ranks as R  # noqa: E402
from tests.helpers import deterministic_config, tiny_data  # noqa: E402
from triplegan_tpu.configs.base import save_config  # noqa: E402
from triplegan_tpu_torch.configs import base as port_base  # noqa: E402
from triplegan_tpu_torch.parallel import mesh as pm  # noqa: E402

torch.set_num_threads(1)
N_RESUMED = 4


def _cfg(tmp, name, mesh, epochs, json_dir):
    jcfg = deterministic_config()
    path = os.path.join(json_dir, f"{name}-{mesh[0]}-{epochs}.json")
    save_config(jcfg, path)
    cfg = port_base.merge_saved(port_base.base_config(), path)
    cfg.name, cfg.workdir, cfg.mesh_shape = name, str(tmp), mesh
    cfg.epochs, cfg.steps_per_epoch = epochs, 2
    cfg.eval_every_epochs = cfg.ckpt_every_epochs = cfg.log_every = 1
    cfg.pseudo_label_mode = "argmax"
    cfg.data_on_device = False
    return cfg


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop_mesh")
    jd = str(tmp_path_factory.mktemp("cfgs"))
    data = R.data_arrays(tiny_data(deterministic_config()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # metrics.jsonl only
        single = {"restore_src": R._run(_cfg(tmp, "restore", (1,), 2, jd), data)}
        for name in ("resume", "resume_single"):
            shutil.copytree(tmp / "restore", tmp / name)
        runs = {"fresh": (_cfg(tmp, "fresh", (2,), 2, jd), data),
                "restore": (_cfg(tmp, "restore", (2,), 2, jd), data),
                "resume": (_cfg(tmp, "resume", (2,), 4, jd), data),
                "stop_file": (_cfg(tmp, "stop_file", (2,), 4, jd), data),
                "sigterm": (_cfg(tmp, "sigterm", (2,), 4, jd), data),
                "wrong_world": (_cfg(tmp, "wrong_world", (4,), 2, jd), data)}
        ranks = pm.run_local_ranks(R.loop_job, 2, "cpu", tmpdir=str(tmp), args=(runs,), timeout=600)
        shutil.copytree(tmp / "fresh", tmp / "fresh_restored")
        single["fresh_restored"] = R._run(_cfg(tmp, "fresh_restored", (1,), 2, jd), data)
        single["resume"] = R._run(_cfg(tmp, "resume_single", (1,), 4, jd), data)
    return {"ranks": ranks, "single": single, "tmp": tmp, "lr": float(runs["fresh"][0].lr_c)}


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_on_a_mesh_of_two_writes_host_outputs_once(job):
    r0, r1 = job["ranks"]
    assert r0["fresh"]["steps"] == r1["fresh"]["steps"] == 4
    assert not r0["fresh"]["preempted"] and r0["fresh"]["digest"] == r1["fresh"]["digest"]
    assert r0["fresh"]["test_error"] == r1["fresh"]["test_error"]  # the eval is collective
    assert 0.0 <= r0["fresh"]["test_error"] <= 1.0
    assert all(np.isfinite(v) for v in r0["fresh"]["metrics"].values())
    run_dir = job["tmp"] / "fresh"
    recs = _records(run_dir)
    keys = [(r["step"], tuple(sorted(r))) for r in recs]
    assert len(keys) == len(set(keys)), "a record was written twice: a second rank logged"
    assert [r["step"] for r in recs if "loss_d" in r] == [1, 2, 3, 4]
    assert [r["step"] for r in recs if "test_error" in r] == [2, 4]
    assert sorted(os.listdir(run_dir / "ckpt")) == ["2", "4"]
    assert sorted(n for n in os.listdir(run_dir) if n.endswith(".png")) == \
        ["samples_00000002.png", "samples_00000004.png"]
    assert json.load(open(run_dir / "config.json"))["mesh_shape"] == [2]
    assert not any(".tmp" in n for n in os.listdir(run_dir) + os.listdir(run_dir / "ckpt"))


@pytest.mark.parametrize("direction", ["one_to_two", "two_to_one"])
def test_cross_topology_restore_is_exact(job, direction):
    """A checkpoint written on one process restores bitwise on 2 ranks and
    one written on 2 ranks bitwise on one process (a resume with no
    epochs left: zero steps run)."""
    if direction == "one_to_two":
        src, dst = job["single"]["restore_src"], [r["restore"] for r in job["ranks"]]
    else:
        src, dst = job["ranks"][0]["fresh"], [job["single"]["fresh_restored"]]
    for d in dst:
        assert d["steps"] == src["steps"] == 4
        assert d["digest"] == src["digest"]


def test_cross_topology_resume_continues_equivalently(job):
    lr = job["lr"]
    mesh, single = job["ranks"][0]["resume"], job["single"]["resume"]
    assert mesh["steps"] == single["steps"] == 8
    assert job["ranks"][1]["resume"]["digest"] == mesh["digest"]
    errs = np.concatenate([np.abs(np.asarray(mesh["flat"][k]) - np.asarray(single["flat"][k])).ravel()
                           for k in single["flat"] if k.startswith("params/")])
    assert errs.max() <= 2 * N_RESUMED * lr, errs.max()
    assert np.mean(errs <= lr / 100) >= 0.99, np.mean(errs <= lr / 100)


@pytest.mark.parametrize("how", ["stop_file", "sigterm"])
def test_one_stop_stops_every_rank_at_the_same_step(job, how):
    """The coordinator's STOP file, or a SIGTERM to the other rank alone,
    stops both ranks at the same step (the next sync point: the epoch
    boundary), with a checkpoint there and exit-75 semantics."""
    r0, r1 = (r[how] for r in job["ranks"])
    want = 4 if how == "stop_file" else 2
    assert r0["preempted"] and r1["preempted"]
    assert r0["steps"] == r1["steps"] == want
    assert r0["digest"] == r1["digest"]
    run_dir = job["tmp"] / how
    assert max(int(n) for n in os.listdir(run_dir / "ckpt")) == want
    assert not os.path.exists(run_dir / "STOP") or how == "stop_file"
    assert max(r["step"] for r in _records(run_dir)) <= want


def test_a_partial_mesh_is_refused(job):
    for r in job["ranks"]:
        assert "requested 4 devices but the process group holds 2 ranks" in r["wrong_world"]
    assert not os.path.exists(job["tmp"] / "wrong_world")  # raised before any work


@pytest.mark.slow  # two torchrun launches of 2 ranks each: about 30 s on 8 cores
def test_torchrun_cli_trains_and_evaluates_on_a_mesh_of_two(tmp_path):
    """``torchrun --nproc-per-node 2 -m triplegan_tpu_torch.cli train --device
    cpu --set 'mesh_shape=(2,)'`` (a localhost rendezvous): the coordinator
    alone prints ``done``; ``eval`` on the same mesh and on one process
    print the error train reported."""
    import subprocess

    sets = ["--set", "dataset=synthetic", "--set", "batch_size=16", "--set", "steps_per_epoch=2",
            "--set", "eval_every_epochs=1", "--set", "ckpt_every_epochs=1", "--set", "mesh_shape=(2,)"]
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "triplegan_tpu_torch.cli"]
    common = ["--config", "mnist100", "--workdir", str(tmp_path), "--device", "cpu"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    train = subprocess.run(run + ["train", *common, *sets, "--max-steps", "4"], cwd=root, env=env,
                           capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, train.stderr[-3000:]
    done = [line for line in train.stdout.splitlines() if line.startswith("done:")]
    assert done == ["done: step=4 " + done[0].split(" ", 2)[2]], train.stdout[-2000:]
    err = done[0].split("test_error=")[1]
    mesh_eval = subprocess.run(run + ["eval", *common, "--set", "mesh_shape=(2,)"], cwd=root, env=env,
                               capture_output=True, text=True, timeout=300)
    one_eval = subprocess.run([sys.executable, "-m", "triplegan_tpu_torch.cli", "eval", *common], cwd=root,
                              env=env, capture_output=True, text=True, timeout=300)
    for out in (mesh_eval, one_eval):
        assert out.returncode == 0, out.stderr[-3000:]
        assert [line for line in out.stdout.splitlines() if line.startswith("test error")] == \
            [f"test error: {err}"]
