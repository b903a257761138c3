"""Generator of training cells: the program's training path on data held
on the card, as ``train/loop.py`` builds it, timed over a window.

The traffic file says how many steps a call runs (``scan_steps``: K > 1,
one CUDA graph replay on the card), and how many calls a traced run makes
on an idle device to time their host side (``host_calls``) and how many
its traced window holds (``trace_calls``). Every run starts at the first
step whose pseudo-label term is on, so that C's whole loss is live.

Set-up makes the images and weights from the seed on the card, fits ZCA
where the configuration asks for it, builds the state and the call, and
drives that same call through its first ``CHECK_STEPS`` steps, which the
output check follows. The window then runs the same object on: calls back
to back, at most two in flight, for ``--seconds``, and ends on a
device→host read of the last call's metrics. After the window (and a
traced one) the program's state is freed, and the plain reference follows
the first ``CHECK_STEPS`` steps from the same weights, images and seeds.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import compare
import inputs
import program
import traced as tracing
from harness import Outcome
from reference import triplegan as reference

LOSSES = ("loss_d", "loss_g", "loss_c")
CHECK_STEPS = 4  # the steps the output check follows: one call of the cell's K = 4


def _host(tree):
    return {p: {l: {a: t.detach().to("cpu", copy=True) for a, t in arr.items()} for l, arr in layers.items()}
            for p, layers in tree.items()}


def _log(*args, **kw):
    kw.pop("flush", None)
    print(*args, file=sys.stderr, flush=True, **kw)


@dataclasses.dataclass
class Inputs:
    """What both sides get: images, the initial weights, and the program's
    ZCA statistics (its own fit, which the reference redoes)."""
    data: dict
    p0: dict
    stats0: dict
    zca: object
    start: int
    k: int


def make_inputs(cell, seed: int, dev) -> Inputs:
    from triplegan_tpu_torch.data.zca import fit_zca

    sz, tr = cell.sizes, cell.traffic
    data = inputs.train_images(sz, cell.config["data"], seed, dev)
    zca = fit_zca(data["x_u"].cpu().numpy()) if sz["zca"] else None
    p0, stats0 = reference.make_weights(sz, seed, dev)
    k = int(tr["scan_steps"])
    if k < 2 or CHECK_STEPS % k:
        raise ValueError(f"scan_steps {k}: a graphed call of K > 1 steps that divides the {CHECK_STEPS} the check "
                         f"follows")
    return Inputs(data, p0, stats0, zca, int(sz["alpha_p_warmup_epochs"]) * steps_per_epoch(cell), k)


def steps_per_epoch(cell) -> int:
    return max(cell.config["data"]["n_train"] // int(cell.sizes["batch_size"]), 1)


def build(cell, seed: int, dev, ins: Inputs):
    """The program's state and its training call, as ``train/loop.py``
    builds them, on ``ins``."""
    from triplegan_tpu_torch.configs.base import apply_runtime, make_networks
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state
    from triplegan_tpu_torch.train.step import make_scan_device_train_step

    cfg = program.config(cell)
    apply_runtime(cfg)
    total = int(cfg.epochs) * steps_per_epoch(cell)
    nets = make_networks(cfg)
    opts = make_optimizers(cfg, total)
    program.check_layout(nets, ins.p0, ins.stats0)
    state = create_state(cfg, nets, opts, seed=seed, device=dev, params=ins.p0, bn=ins.stats0)
    state.step = ins.start
    call = make_scan_device_train_step(cfg, nets, opts, total, ins.k, ins.zca,
                                       pseudo_label_mode=cfg.get("pseudo_label_mode", "sample"), log=_log)
    return state, call


def first_calls(call, state, ins: Inputs):
    """Drive the call through its first ``CHECK_STEPS`` steps: (state, the
    readings the check compares: each step's losses, Adam's first moments
    and the parameters after them, copied to the host)."""
    losses = []
    while len(losses) < CHECK_STEPS:
        state, _ = call(state, ins.data)
        losses += [tuple(float(call.step_metrics[n][i]) for n in LOSSES) for i in range(ins.k)]
    readings = {"losses": losses, "mu": _host({p: o.mu for p, o in state.opt.items()}),
                "params": _host(state.params)}
    return state, readings


def reference_readings(cell, seed: int, ins: Inputs, tf32: bool = False):
    """The plain reference's readings of the first ``CHECK_STEPS`` steps
    (``tf32``: computed in TF32, the control)."""
    ref_zca = reference.fit_zca(ins.data["x_u"]) if cell.sizes["zca"] else None
    return reference.train_steps(ins.p0, ins.data, ref_zca, cell.sizes, seed, ins.start, CHECK_STEPS, tf32)


def run(cell, seed: int, seconds: float, traced: bool, device: str, window_started) -> Outcome:
    import torch

    from triplegan_tpu_torch.utils.platform import resolve_device

    tr = cell.traffic
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    ins = make_inputs(cell, seed, dev)
    state, call = build(cell, seed, dev, ins)
    state, prog = first_calls(call, state, ins)
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    sync()

    k, steps, inflight = ins.k, 0, []
    t_start = time.perf_counter()
    window_started(t_start)
    end = t_start + seconds
    while steps == 0 or time.perf_counter() < end:
        if len(inflight) >= 2:
            inflight.pop(0).synchronize()
        state, metrics = call(state, ins.data)
        steps += k
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
    last = [float(metrics[n]) for n in LOSSES]  # the device→host read that ends the window
    window_s = time.perf_counter() - t_start

    trace, trace_steps, host_s = None, 0, None
    if traced:
        if not cuda:
            raise RuntimeError("a traced window needs the card")
        # the host's work a call, each call made on an idle device: in the
        # window a call also waits for room in the launch queue
        host_s = 0.0
        for _ in range(int(tr["host_calls"])):
            sync()
            t = time.perf_counter()
            state, _ = call(state, ins.data)
            host_s += time.perf_counter() - t
        sync()
        box = [state]

        def work():
            for _ in range(int(tr["trace_calls"])):
                box[0], _ = call(box[0], ins.data)

        trace = tracing.record(work, sync)
        trace_steps = int(tr["trace_calls"]) * k
        state, box[0] = box[0], None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    graph = dict(getattr(call, "graph_stats", {}))
    batch = int(cell.sizes["batch_size"])
    del call, state, metrics
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = reference_readings(cell, seed, ins)
    numbers, where = compare.train_numbers(prog, ref, ins.p0, float(cell.sizes["lr_d"]))
    _log(f"check: worst adam_mu leaf {where['adam_mu_leaf']}, worst change leaf {where['change_leaf']}, "
         f"{where['leaves']} leaves compared, left out (gradient nought to rounding): {where['left_out']}")
    _log(f"check: program losses {prog['losses']}; reference {ref['losses']}")
    checks = [(n, numbers[n], cell.limits[n]) for n in cell.limits]
    failed = 0 if all(math.isfinite(v) for v in last) else k
    ctx = {"kind": "train", "sizes": cell.sizes, "window_s": window_s, "steps": steps,
           "host_s": host_s, "host_steps": int(tr["host_calls"]) * k,
           "trace_steps": trace_steps}
    return Outcome(values={"train_img_s": steps * batch / window_s}, ctx=ctx, attempted=steps,
                   failed=failed, checks=checks, memory_peak_bytes=peak,
                   device_kind=torch.cuda.get_device_name(dev) if cuda else "cpu", device_count=1,
                   trace=trace, notes={"graph": graph, "window_s": window_s, "steps": steps})
