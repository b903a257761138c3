"""The port's data parallelism (``triplegan_tpu_torch/parallel/mesh.py``) on
the CPU: 2 gloo ranks (``run_local_ranks``: spawned processes joined by a
FileStore) against the port's single-device step on the global batch and
against the JAX package's ``shard_map`` step on ``make_mesh(2)`` (2 of its
fake CPU devices), from the same weights (carried by the bridge) and the
same global batch (JAX's ``BatchSampler``). The ports of JAX's
``tests/test_parallel.py`` and of ``test_multihost.py``'s single-process
cases.

Setting: ``tests/helpers.py::deterministic_config`` (16 px, no noise,
dropout or augmentation), batch 8 (4 a rank), argmax pseudo-labels, the
kernel arm (``use_pallas``; its plain versions on the CPU).

One module-scoped 2-rank job computes what the cases read, so each rank
imports torch once.

Tolerances, as JAX's ``test_parallel.py``: after one step parameters and
batch-norm statistics within 5e-4 (rtol and atol: the ranks sum in
another order than one process, and Adam's first step is ≈lr·sign(g), so a
near-zero gradient coordinate may flip; JAX's comment measured ≈1.4e-4),
metrics within 1e-5; gradients compared directly (no Adam between) within
rtol 1e-5 and atol 1e-6; eval counts exactly; an eager scan chunk against
the same steps one by one, and the ranks against each other, bitwise.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests import torch_mesh_ranks as R  # noqa: E402
from tests.helpers import deterministic_config, tiny_config, tiny_data  # noqa: E402
from triplegan_tpu.configs.base import make_networks as jax_make_networks  # noqa: E402
from triplegan_tpu.configs.base import save_config  # noqa: E402
from triplegan_tpu.data.pipeline import BatchSampler as JaxBatchSampler  # noqa: E402
from triplegan_tpu.parallel import mesh as jmesh  # noqa: E402
from triplegan_tpu.train.schedule import make_optimizers as jax_make_optimizers  # noqa: E402
from triplegan_tpu.train.state import create_state as jax_create_state  # noqa: E402
from triplegan_tpu.train.step import make_train_step as jax_make_train_step  # noqa: E402
from triplegan_tpu.utils.logging import MetricsLogger as JaxMetricsLogger  # noqa: E402
from triplegan_tpu_torch import bridge  # noqa: E402
from triplegan_tpu_torch.configs import base as port_base  # noqa: E402
from triplegan_tpu_torch.data.pipeline import BatchSampler  # noqa: E402
from triplegan_tpu_torch.parallel import mesh as pm  # noqa: E402
from triplegan_tpu_torch.utils import platform  # noqa: E402
from triplegan_tpu_torch.utils.logging import MetricsLogger  # noqa: E402

torch.set_num_threads(1)
WORLD = 2


def _port_cfg(jcfg, path):
    save_config(jcfg, str(path))
    return port_base.merge_saved(port_base.base_config(), str(path))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_init(params, bn):
    """JAX (params, bn) → the port's (params, bn) trees of numpy arrays."""
    state = bridge.from_jax(params, bn)
    trees = {p: bridge.nested(sd) for p, sd in state.items()}
    to_np = lambda t: {layer: {k: v.numpy() for k, v in a.items()} for layer, a in t.items()}  # noqa: E731
    return ({p: to_np(t[0]) for p, t in trees.items()}, {p: to_np(t[1]) for p, t in trees.items()})


def _to_jax_layout(flat):
    """A rank's flat port state → JAX (params, bn) trees."""
    sds = {}
    for key, a in flat.items():
        kind, player, layer, name = key.split("/")
        if kind in ("params", "bn"):
            sds.setdefault(player, {})[f"{layer}.{name}"] = torch.as_tensor(a)
    return bridge.to_jax(sds)


def _allclose_trees(t1, t2, rtol=5e-4, atol=5e-4):
    l1, l2 = jax.tree.leaves(t1), jax.tree.leaves(t2)
    assert len(l1) == len(l2)
    for a, b in zip(l1, l2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _allclose_flat(a, b, rtol=5e-4, atol=5e-4):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), rtol=rtol, atol=atol, err_msg=k)


def _metrics_close(a, b, tol=1e-5):
    assert sorted(a) == sorted(b)
    for k in a:
        assert abs(a[k] - b[k]) <= tol, (k, a[k], b[k])


def _device_data(cfg):
    d = tiny_data(cfg)
    return {"x_l": d.x_label, "y_l": d.y_label, "x_u": d.x_unlabel}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    cases, single = {"steps": {}}, {}
    jcfg = deterministic_config()
    nets = jax_make_networks(jcfg)
    opts = jax_make_optimizers(jcfg, R.TOTAL)
    jstate = jax_create_state(jcfg, nets, opts)
    init = _port_init(_np(jstate.params), _np(jstate.bn))
    data = tiny_data(jcfg)
    for name, share, fused in (("default", False, False), ("share", True, False), ("fused", False, True)):
        c = deterministic_config()
        c.share_pseudo_forward, c.fused_clf_forward = share, fused
        batch = JaxBatchSampler(data, c.batch_size, seed=0).next_triple(c.z_dim, c.num_classes,
                                                                         skip_c_unlabeled=share)
        cfg = _port_cfg(c, tmp / f"{name}.json")
        cases["steps"][name] = (cfg, init, batch)
        single[name] = R.one_step(cfg, init, batch)

    dcfg = _port_cfg(deterministic_config(data_on_device=True), tmp / "device.json")
    dcfg.pseudo_label_mode = "argmax"
    cases["device"] = (dcfg, _device_data(deterministic_config()))
    scfg = _port_cfg(tiny_config(data_on_device=True), tmp / "stochastic.json")
    cases["stochastic"] = (scfg, _device_data(tiny_config()))

    rng = np.random.RandomState(0)
    bn_case = (rng.normal(size=(8, 3, 3, 5)).astype(np.float32) * 2 + 1,
               rng.normal(size=(8, 3, 3, 5)).astype(np.float32),
               (rng.normal(size=5) * 0.3 + 1).astype(np.float32), (rng.normal(size=5) * 0.2).astype(np.float32))
    cases["bn"] = bn_case
    single["bn"] = [t.numpy() for t in R.bn_layer_grads(*bn_case)]
    c_adv_case = (rng.normal(size=(16,)).astype(np.float32), rng.normal(size=(16, 10)).astype(np.float32),
                  rng.randint(0, 10, size=16).astype(np.int64))
    cases["c_adv"] = c_adv_case
    single["c_adv"] = R.c_adv_grad(*c_adv_case).numpy()
    ecfg = cases["steps"]["default"][0]
    test_batch = next(iter(BatchSampler(data, ecfg.batch_size).test_batches()))
    cases["eval"] = (ecfg, init, test_batch)
    single["eval"] = R.eval_counts(ecfg, init, test_batch)

    ranks = pm.run_local_ranks(R.step_job, WORLD, "cpu", tmpdir=str(tmp), args=(cases,), timeout=600)
    return {"ranks": ranks, "single": single, "jax_init": jstate, "jcfg": jcfg, "jnets": nets,
            "jopts": opts, "batch": cases["steps"]["default"][2], "c_adv_case": c_adv_case}


def test_two_rank_step_equals_single_device_global_batch_step(job):
    for r in job["ranks"]:
        flat, metrics = r["default"]
        _allclose_flat(flat, job["single"]["default"][0])
        _metrics_close(metrics, job["single"]["default"][1])


def test_two_rank_step_equals_jax_shard_map_step(job):
    """The port on 2 gloo ranks against ``pmesh.shard_train_step`` on
    ``make_mesh(2)``: the same update, from the same weights and batch."""
    jcfg, nets, opts = job["jcfg"], job["jnets"], job["jopts"]
    sharded = jmesh.shard_train_step(
        jax_make_train_step(jcfg, nets, opts, R.TOTAL, axis_name=jmesh.AXIS, pseudo_label_mode="argmax"),
        jmesh.make_mesh(WORLD))
    s_jax, m_jax = sharded(job["jax_init"], job["batch"])
    m_jax = {k: float(v) for k, v in m_jax.items()}
    for r in job["ranks"]:
        flat, metrics = r["default"]
        params, bn = _to_jax_layout(flat)
        _allclose_trees(params, _np(s_jax.params))
        _allclose_trees({p: v for p, v in bn.items() if v}, {p: v for p, v in _np(s_jax.bn).items() if v})
        _metrics_close(metrics, m_jax)


@pytest.mark.parametrize("case", ["share", "fused"])
def test_share_pseudo_forward_and_fused_classifier_sharded_equal_single(job, case):
    for r in job["ranks"]:
        flat, metrics = r[case]
        _allclose_flat(flat, job["single"][case][0])
        _metrics_close(metrics, job["single"][case][1])


def test_ranks_hold_bitwise_equal_states(job):
    """Deterministic and stochastic alike: every collective gives each rank
    the same bits, so the replicated state stays replicated."""
    r0, r1 = job["ranks"]
    for case in ("default", "share", "fused", "sequential"):
        a, b = r0[case][0], r1[case][0]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{case} {k}")
    assert r0["stochastic"][1] == r1["stochastic"][1]
    assert r0["stochastic"][2] == r1["stochastic"][2]
    assert all(np.isfinite(v) for v in r0["stochastic"][2].values())


def test_sync_bn_input_and_parameter_gradients_equal_single_device(job):
    """A batch-norm layer on synced moments: each rank's dx of its rows,
    and the averaged dscale and dbias, equal the single-device gradients
    of the same global loss."""
    want = job["single"]["bn"]
    for r in job["ranks"]:
        dx, ds, db = r["bn"]
        rows = slice(r["rank"] * 4, (r["rank"] + 1) * 4)
        np.testing.assert_allclose(dx, want[0][rows], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ds, want[1], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(db, want[2], rtol=1e-5, atol=1e-6)


def test_c_adv_baseline_is_the_global_mean(job):
    """JAX's ``test_c_adv_baseline_global_mean``: the REINFORCE surrogate's
    gradient with the baseline averaged over the ranks equals the
    single-device gradient; a rank-local baseline does not."""
    got = np.concatenate([r["c_adv"] for r in job["ranks"]])
    np.testing.assert_allclose(got, job["single"]["c_adv"], rtol=1e-5, atol=1e-6)
    ld, lc, yc = job["c_adv_case"]
    local = np.concatenate([R.c_adv_grad(ld[h], lc[h], yc[h]).numpy() / WORLD
                            for h in (slice(0, 8), slice(8, 16))])
    assert np.abs(local - job["single"]["c_adv"]).max() > 1e-4  # a rank-local baseline is another gradient


def test_sharded_eval_counts_equal_single_device(job):
    for r in job["ranks"]:
        assert r["eval"] == job["single"]["eval"]
    assert job["single"]["eval"]["count"] == 8


def test_eager_scan_chunk_under_a_mesh_equals_sequential_sharded_steps(job):
    for r in job["ranks"]:
        seq, chunk = r["sequential"], r["chunk"]
        assert seq[1] == chunk[1]
        for k in seq[0]:
            np.testing.assert_array_equal(seq[0][k], chunk[0][k], err_msg=k)
        assert seq[2] == chunk[2]


def test_a_world_of_another_size_than_the_mesh_raises(job):
    for r in job["ranks"]:
        assert "requested 3 devices but the process group holds 2 ranks" in r["refusal"]


def test_a_mesh_without_a_process_group_raises_naming_torchrun(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    cfg = port_base.base_config()
    cfg.mesh_shape = (4,)
    with pytest.raises(RuntimeError, match=r"needs 4 processes.*torchrun --nproc-per-node 4"):
        pm.mesh_for(cfg, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        pm.make_mesh(4, "cpu")
    cfg.mesh_shape = (1,)
    assert pm.mesh_for(cfg, torch.device("cpu")) is None and pm.is_coordinator()


def test_local_rank_past_the_device_count_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=1 but this machine has 1 CUDA device"):
        platform.resolve_device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert platform.resolve_device("cuda") == torch.device("cuda", 0)
    assert platform.resolve_device("cuda:3") == torch.device("cuda", 3)  # explicit: taken as it is


def test_rank_rows_of_the_sampler_concatenate_to_the_global_batch_bitwise():
    """Each rank's sampler, seeded alike, draws JAX's global batch and
    gathers its rows: the ranks' batches concatenated are JAX's, bitwise."""
    cfg = tiny_config()
    data = tiny_data(cfg)
    want = [JaxBatchSampler(data, 8, seed=3).next_triple(cfg.z_dim, cfg.num_classes) for _ in range(1)]
    port = [BatchSampler(data, 8, seed=3, rows=slice(r * 4, r * 4 + 4)) for r in range(WORLD)]
    got = [s.next_triple(cfg.z_dim, cfg.num_classes) for s in port]
    for stream in ("d", "c", "g"):
        for k, a in want[0][stream].items():
            np.testing.assert_array_equal(np.concatenate([g[stream][k] for g in got]), a, err_msg=(stream, k))


def test_metrics_logger_disabled_writes_nothing(tmp_path):
    """JAX's ``test_multihost.py::test_metrics_logger_disabled_writes_nothing``
    for the port's logger: a disabled logger opens no file."""
    for cls, where in ((JaxMetricsLogger, tmp_path / "jax"), (MetricsLogger, tmp_path / "port")):
        log = cls(str(where), use_tensorboard=False, enabled=False)
        log.scalars(1, {"loss": 1.0})
        log.image(1, "samples", np.zeros((4, 4, 3), np.uint8))
        log.close()
        assert not where.exists() or not any(where.iterdir())


def test_a_failing_rank_fails_the_call_with_its_traceback(tmp_path):
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed:(.|\n)*ZeroDivisionError"):
        pm.run_local_ranks(R.fail_on_rank_1, WORLD, "cpu", tmpdir=str(tmp_path), timeout=120)


_MULTIHOST_RANK = """
import sys, torch
from triplegan_tpu_torch.configs import get_config
from triplegan_tpu_torch.parallel import mesh as pm
cfg = get_config("mnist100")
cfg.multihost, cfg.mesh_shape = True, (2,)
cfg.multihost_coordinator, cfg.multihost_num_processes = sys.argv[1], 2
cfg.multihost_process_id = int(sys.argv[2])
mesh = pm.mesh_for(cfg, torch.device("cpu"))
t = mesh.psum(torch.tensor([mesh.rank + 1.0]))
print(mesh.rank, mesh.world, mesh.backend, float(t[0]), pm.is_coordinator())
"""


def test_multihost_fields_join_a_tcp_process_group(tmp_path):
    """``multihost_coordinator``, ``multihost_num_processes`` and
    ``multihost_process_id`` map onto ``init_process_group``'s tcp://
    rendezvous (on localhost here), as JAX's onto ``jax.distributed``."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["OMP_NUM_THREADS"] = "1"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", _MULTIHOST_RANK, f"localhost:{port}", str(r)], cwd=root,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        outs.append(out.split())
    assert outs == [["0", "2", "gloo", "3.0", "True"], ["1", "2", "gloo", "3.0", "False"]]
