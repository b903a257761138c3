"""What the ranks of the port's data-parallel CPU tests run
(``tests/test_torch_parallel.py``, ``tests/test_torch_loop_mesh.py``):
functions of ``(mesh, ...)`` for ``parallel/mesh.py::run_local_ranks``,
which spawns each rank as a fresh process that imports this module by
name. It imports torch and the port only (no JAX), so a rank starts in a
few seconds; its results cross back as numpy arrays and Python values.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys

import numpy as np
import torch

from triplegan_tpu_torch.configs.base import make_networks
from triplegan_tpu_torch.data.datasets import SemiSupervisedData
from triplegan_tpu_torch.nn import layers as L
from triplegan_tpu_torch.parallel.mesh import make_mesh, state_digest
from triplegan_tpu_torch.train import losses
from triplegan_tpu_torch.train import step as S
from triplegan_tpu_torch.train.schedule import make_optimizers
from triplegan_tpu_torch.train.state import PLAYERS, create_state

TOTAL = 16


def tensors(tree):
    """A nested dict of numpy arrays as tensors."""
    return {k: tensors(v) if isinstance(v, dict) else torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


def flat_state(state) -> dict:
    """Every tensor of a state by its path: params/, bn/, mu/, nu/."""
    out = {}
    trees = {"params": state.params, "bn": state.bn, "mu": {p: o.mu for p, o in state.opt.items()},
             "nu": {p: o.nu for p, o in state.opt.items()}}
    for kind, tree in trees.items():
        for p in PLAYERS:
            for layer, arrays in tree[p].items():
                for name, t in arrays.items():
                    out[f"{kind}/{p}/{layer}/{name}"] = t.detach().clone()
    return out


def digest(state) -> str:
    return state_digest({"params": state.params, "bn": state.bn,
                         "mu": {p: o.mu for p, o in state.opt.items()},
                         "nu": {p: o.nu for p, o in state.opt.items()}})


def _state(cfg, init=None):
    nets = make_networks(cfg)
    opts = make_optimizers(cfg, TOTAL)
    if init is None:
        return nets, opts, create_state(cfg, nets, opts, device="cpu")
    params, bn = tensors(init[0]), tensors(init[1])
    return nets, opts, create_state(cfg, nets, opts, device="cpu", params=params, bn=bn)


def one_step(cfg, init, batch, mesh=None):
    """One ``make_train_step`` step from ``init`` on ``batch`` (this rank's
    rows of it under ``mesh``), argmax pseudo-labels: (flat state, metrics)."""
    nets, opts, state = _state(cfg, init)
    step = S.make_train_step(cfg, nets, opts, TOTAL, pseudo_label_mode="argmax", mesh=mesh)
    b = tensors(batch)
    state, m = step(state, b if mesh is None else mesh.rank_rows(b))
    return flat_state(state), {k: float(v) for k, v in m.items()}


def device_steps(cfg, data, n, mesh=None, chunk=False):
    """``n`` device-data steps from a fresh state (one chunk of ``n`` if
    ``chunk``): (flat state, digest, last metrics)."""
    nets, opts, state = _state(cfg)
    dev_data = {"x_l": torch.as_tensor(data["x_l"]), "y_l": torch.as_tensor(data["y_l"]).long(),
                "x_u": torch.as_tensor(data["x_u"])}
    if chunk:
        scan = S.make_scan_device_train_step(cfg, nets, opts, TOTAL, n, pseudo_label_mode="argmax",
                                             log=lambda *a, **k: None, mesh=mesh)
        state, m = scan(state, dev_data)
    else:
        step = S.make_device_train_step(cfg, nets, opts, TOTAL, pseudo_label_mode=cfg.pseudo_label_mode,
                                        mesh=mesh)
        for _ in range(n):
            state, m = step(state, dev_data)
    return flat_state(state), digest(state), {k: float(v) for k, v in m.items()}


def bn_layer_grads(x, c, scale, bias, mesh=None):
    """The gradients (dx, dscale, dbias) of the global batch's loss
    mean(batch-norm-act(x)·c). Under ``mesh`` each rank takes its rows,
    normalizes with the synced moments and differentiates its own rows'
    mean: its dx divided by the world is its rows of the global dx (the
    global loss is the mean of the ranks'), and its parameter gradients
    averaged over the ranks, as the train step averages them, are the
    global ones."""
    x, c = torch.as_tensor(x).requires_grad_(True), torch.as_tensor(c)
    p = {"scale": torch.as_tensor(scale).requires_grad_(True), "bias": torch.as_tensor(bias).requires_grad_(True)}
    s = {"mean": torch.zeros(x.shape[-1]), "var": torch.ones(x.shape[-1])}
    rows = slice(None) if mesh is None else mesh.rows(x.shape[0])
    y, _ = L.batchnorm_act_apply(p, s, x[rows], train=True, act="leaky_relu", mesh=mesh)
    dx, ds, db = torch.autograd.grad(torch.mean(y * c[rows]), [x, p["scale"], p["bias"]])
    if mesh is None:
        return dx, ds, db
    return dx[rows] / mesh.world, mesh.pmean(ds), mesh.pmean(db)


def c_adv_grad(logit_d, logits_c, y_c, mesh=None):
    """The gradient of the global batch's c_adv surrogate with respect to
    the logits (under ``mesh``: this rank's rows of it, from this rank's
    loss, whose baseline is the global mean, divided by the world: the
    global loss is the mean of the ranks')."""
    if mesh is not None:
        rows = mesh.rows(len(logit_d))
        logit_d, logits_c, y_c = logit_d[rows], logits_c[rows], y_c[rows]
    lc = torch.as_tensor(logits_c).requires_grad_(True)
    loss = losses.c_adversarial_loss(torch.as_tensor(logit_d), lc, torch.as_tensor(y_c).long(), 0.5, mesh)
    (g,) = torch.autograd.grad(loss, [lc])
    return g if mesh is None else g / mesh.world


def eval_counts(cfg, init, batch, mesh=None):
    nets, _, state = _state(cfg, init)
    b = tensors(batch)
    out = S.make_eval_step(cfg, nets, mesh=mesh)(state, b if mesh is None else mesh.rank_rows(b))
    return {k: float(v) for k, v in out.items()}


def step_job(mesh, cases: dict):
    """The 2-rank job of ``tests/test_torch_parallel.py``: each case's
    result on this rank."""
    torch.set_num_threads(1)
    out = {"rank": mesh.rank, "world": mesh.world}
    for name, (cfg, init, batch) in cases["steps"].items():
        out[name] = one_step(cfg, init, batch, mesh)
    cfg, data = cases["device"]
    out["sequential"] = device_steps(cfg, data, 4, mesh)
    out["chunk"] = device_steps(cfg, data, 4, mesh, chunk=True)
    cfg, data = cases["stochastic"]
    out["stochastic"] = device_steps(cfg, data, 2, mesh)
    out["bn"] = bn_layer_grads(*cases["bn"], mesh=mesh)
    out["c_adv"] = c_adv_grad(*cases["c_adv"], mesh=mesh)
    out["eval"] = eval_counts(*cases["eval"], mesh=mesh)
    try:
        make_mesh(mesh.world + 1, "cpu")
    except ValueError as e:
        out["refusal"] = str(e)
    return out


def fail_on_rank_1(mesh):
    return mesh.rank / (1 - mesh.rank)


# ---------------------------------------------------------------------------
# the train driver on ranks (tests/test_torch_loop_mesh.py)
# ---------------------------------------------------------------------------


def _quiet_tensorboard():
    sys.modules["torch.utils.tensorboard"] = None  # the logger then writes metrics.jsonl only


def _data(arrays) -> SemiSupervisedData:
    return SemiSupervisedData(**arrays)


def _run(cfg, data, **kw):
    from triplegan_tpu_torch.train import loop

    res = loop.train(cfg, data=_data(data), verbose=False, device="cpu", **kw)
    state = res["state"]
    return {"steps": res["steps"], "preempted": res["preempted"], "test_error": res["test_error"],
            "metrics": res["metrics"], "digest": digest(state), "flat": flat_state(state)}


class _StopAt:
    """Wraps ``loop.make_train_step``: the step it returns calls ``act``
    after its ``at``-th call on the rank ``rank``."""

    def __init__(self, mesh, rank, at, act):
        from triplegan_tpu_torch.train import loop

        self.loop, self.real = loop, loop.make_train_step
        self.mesh, self.rank, self.at, self.act = mesh, rank, at, act

    def __enter__(self):
        def make(*a, **k):
            step = self.real(*a, **k)
            calls = [0]

            def wrapped(state, batch):
                out = step(state, batch)
                calls[0] += 1
                if calls[0] == self.at and self.mesh.rank == self.rank:
                    self.act()
                return out

            return wrapped

        self.loop.make_train_step = make

    def __exit__(self, *exc):
        self.loop.make_train_step = self.real


def loop_job(mesh, runs: dict):
    """The 2-rank job of ``tests/test_torch_loop_mesh.py``: train() runs
    at mesh (2,) on the run dirs the parent prepared, in order."""
    torch.set_num_threads(1)
    _quiet_tensorboard()
    out = {}
    cfg, data = runs["fresh"]
    out["fresh"] = _run(cfg, data)
    cfg, data = runs["restore"]
    out["restore"] = _run(cfg, data)
    cfg, data = runs["resume"]
    out["resume"] = _run(cfg, data)
    cfg, data = runs["stop_file"]
    stop_file = os.path.join(cfg.workdir, cfg.name, "STOP")
    with _StopAt(mesh, 0, 3, lambda: open(stop_file, "w").close()):
        out["stop_file"] = _run(cfg, data)
    cfg, data = runs["sigterm"]
    with _StopAt(mesh, 1, 1, lambda: os.kill(os.getpid(), signal.SIGTERM)):
        out["sigterm"] = _run(cfg, data)
    cfg, data = runs["wrong_world"]
    try:
        _run(cfg, data)
    except ValueError as e:
        out["wrong_world"] = str(e)
    return out


def data_arrays(data) -> dict:
    return {f.name: getattr(data, f.name) for f in dataclasses.fields(data)}
