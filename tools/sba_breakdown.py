#!/usr/bin/env python3
"""Where the time of the PyTorch port's epilogue kernels goes, on one NVIDIA
card (``triplegan_tpu_torch/ops/csrc/scale_bias_act.cu``: ``act(x·k + b)``
and its backward).

    python3 tools/sba_breakdown.py [--other NAME=PATH ...] [--per-step FILE] [--reps N] [--out FILE]
    python3 tools/sba_breakdown.py --ab NAME=TREE [--out FILE]

At the widest epilogues of cifar10_4k's train steps (float32 at the
shipped batch of 100, bfloat16 at the bench batch of 384) and a few narrow
ones, times each call three ways, to tell the kernel's own time from what
the timing adds:

  cold      chip_smoke.py's ``time_ms``: CUDA events around one call after
            a 256 MB read flush and a ≈0.5 ms device spin (median, p10,
            p90 of ``--reps``);
  warm      the mean of back-to-back calls (x, y in L2 where they fit;
            ``time_ms`` too);
  kernel    the kernels' own device time per call from torch.profiler's
            records (chip_smoke.py's ``profile_calls``), after the same
            flush and spin: no event or launch latency in it.

Beside the kernels it times ``y.copy_(x)`` (the same bytes as the forward:
what a plain streaming pass reaches on this card) and an empty window (two
events after the flush and spin: the yardstick's own floor). Each ``--other
NAME=PATH`` builds another version of the source (a .cu file with the same
C entry points; one without the backward's is timed forward only) and
times it through the same wrapper, given its entry points, in turns with
the shipped one (shipped, others, shipped again).

With ``--per-step FILE`` (the JSON that ``chip_smoke.py --out FILE``
wrote) it times instead every epilogue shape that run's train steps
launched, forward and backward, for the shipped source and each other one,
and sums them per step at each setting (launches × time).

With ``--ab NAME=TREE`` it compares this tree with another checkout of the
repo (an earlier commit unpacked with ``git archive``), each in a process
of its own that imports its own package, in turns (this, NAME, NAME,
this): the epilogue wrapper's host time per call (the forward without
autograd, as serving calls it; forward and backward through autograd, as
training does; at a shape whose device time is far below it), the serving
functions' img/s per chunk of 100 (float32 and bfloat16, kernel and plain
arms), and cifar10_4k's train step at chip_smoke.py's two settings (kernel
and plain arms: ms/step of 7 steps after an untimed one, and one profiled
step: device time, kernels launched, the epilogue kernels' in-step time).
The plain arms run the same code in both trees: they are the control for
the host's speed.

Prints the card's name and power limit, then one JSON line per result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (shape, dtype, act, slope): the widest epilogues of each train setting,
# the Generator's RGB output, and narrow ones
CASES = [((100, 32, 32, 128), "float32", "leaky_relu", 0.1),
         ((100, 16, 16, 256), "float32", "leaky_relu", 0.1),
         ((100, 32, 32, 3), "float32", "tanh", 0.2),
         ((100, 4, 4, 512), "float32", "relu", 0.1),
         ((384, 32, 32, 128), "bfloat16", "leaky_relu", 0.1),
         ((1152, 32, 32, 32), "bfloat16", "leaky_relu", 0.2),
         ((384, 32, 32, 3), "bfloat16", "tanh", 0.2)]
HOST_SHAPE = (2, 4, 4, 128)  # the wrapper's host time: ≈3 µs of device work a call
# the epilogue kernels' names in a profile: this source's, and the first
# source's (sba_vec16, sba_scalar; its backward was plain PyTorch)
EPILOGUE_KERNELS = {"epilogue_fwd": ("sba_fwd", "sba_vec16", "sba_scalar"), "epilogue_bwd": ("sba_bwd",)}


def build_other(path: str):
    """(forward, backward or None, backward's plan or None) entry points of
    another .cu source, built with the port's nvcc flags into a temporary
    library and bound as the wrapper binds its own."""
    from triplegan_tpu_torch.ops import build

    out = os.path.join(tempfile.mkdtemp(), "libsba_other.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", out, path], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed on {path}:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fwd = lib.scale_bias_act_launch
    fwd.argtypes, fwd.restype = [p, p, p, p, ll, i, i, i, f, p], i
    bwd = getattr(lib, "scale_bias_act_bwd_launch", None)
    plan = getattr(lib, "scale_bias_act_bwd_plan", None)
    if bwd is None or plan is None:
        return fwd, None, None
    bwd.argtypes, bwd.restype = [p, p, p, p, p, p, p, p, i, ll, i, i, i, f, i, p], i
    plan.argtypes, plan.restype = [ll, i, i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(ll)], i
    return fwd, bwd, plan


def time_modes(fn, flush, reps, frags):
    """{mode: times} of one call of fn: cold and warm (``time_ms``), and
    kernel, the device time of the kernels whose names hold one of
    ``frags``."""
    import torch

    import chip_smoke as cs

    t = cs.time_ms(fn, flush, reps=reps)
    prof = cs.profile_calls(lambda: (flush.sum(), torch.cuda._sleep(cs.SPIN_CYCLES), fn()), reps=reps, top=0,
                            groups={"kernel": frags})["groups"]["kernel"]
    return {"cold": {"ms": t["cold"], "p10_ms": t["p10"], "p90_ms": t["p90"]}, "warm": {"ms": t["warm"]},
            "kernel": {"ms": prof["us"] / 1e3, "launches": prof["launches"]}}


def seeded(shape, dtype, gen):
    import torch

    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=dev) * 2.0).to(dt)
    g = torch.randn(shape, generator=gen, device=dev).to(dt)
    k = (torch.randn(c, generator=gen, device=dev) * 0.5 + 1.0).to(dt)
    b = (torch.randn(c, generator=gen, device=dev) * 0.3).to(dt)
    return x, k, b, g


def per_step(path, sources, sba, flush, gen, reps, emit):
    """Per-step sums (launches × cold time; launches × kernel time) of every
    train epilogue in a chip_smoke.py JSON, for each source in turn."""
    with open(path) as f:
        run = json.load(f)
    sums = {}
    for kind, rows in (("forward", run["sba_rows"]), ("backward", run["sba_bwd_rows"])):
        for row in rows:
            steps = {k.split(" ", 1)[1]: n for k, n in row["launches"].items() if k.startswith("train ")}
            if not steps:
                continue
            shape, act, slope = tuple(row["shape"]), row["act"], row["slope"]
            x, k, b, g = seeded(shape, row["dtype"], gen)
            mask = tuple(n in row.get("needs", "") for n in "xkb")
            for name, lib in sources:
                if kind == "backward" and lib[1] is None:
                    continue
                fn = ((lambda: sba._forward(x, k, b, act, slope, lib)) if kind == "forward"
                      else (lambda: sba._backward(x, k, b, g, act, slope, mask, lib)))
                modes = time_modes(fn, flush, reps, ("sba_",))
                emit({"shape": list(shape), "dtype": row["dtype"], "act": act, "what": f"{kind}, {name}",
                      "needs": row.get("needs"), "launches": steps, **modes})
                for setting, n in steps.items():
                    acc = sums.setdefault(f"{kind}, {name}, {setting}", {"launches": 0, "ms": 0.0, "kernel_ms": 0.0})
                    acc["launches"] += n
                    acc["ms"] += n * modes["cold"]["ms"]
                    acc["kernel_ms"] += n * modes["kernel"]["ms"]
    emit({"what": "per step", "sums": sums})


def cases(sources, sba, flush, gen, reps, emit):
    """Every shape of CASES, each source in turn, with copy_ beside."""
    import torch

    import chip_smoke as cs

    for shape, dtype, act, slope in CASES:
        x, k, b, g = seeded(shape, dtype, gen)
        y = torch.empty_like(x)
        nbytes = 2 * x.numel() * x.element_size()
        want = sba._forward(x, k, b, act, slope)
        whats = [("copy_", lambda: y.copy_(x), nbytes, ("Memcpy", "copy"))]
        for name, lib in sources:
            assert torch.equal(sba._forward(x, k, b, act, slope, lib), want), f"{name}'s forward disagrees"
            whats.append((f"forward, {name}", lambda lib=lib: sba._forward(x, k, b, act, slope, lib), nbytes,
                          ("sba_",)))
            if lib[1] is not None:
                whats.append((f"backward, {name}",
                              lambda lib=lib: sba._backward(x, k, b, g, act, slope, (True, True, True), lib),
                              3 * x.numel() * x.element_size(), ("sba_",)))
        for what, fn, nb, frags in whats:
            modes = time_modes(fn, flush, reps, frags)
            bound = nb / cs.HBM_BYTES_PER_S * 1e3
            emit({"shape": list(shape), "dtype": dtype, "act": act, "what": what, "bytes": nb,
                  "bound_ms": bound, **modes,
                  "share_of_bound": {m: bound / v["ms"] for m, v in modes.items() if v["ms"] > 0}})


# ---------------------------------------------------------------------------
# --ab: this tree against another, each in a process of its own
# ---------------------------------------------------------------------------


def host_us(fn, calls=2000, turns=5) -> float:
    """Median host time of one call of fn, in µs, over ``turns`` loops of
    ``calls`` calls (the device kept ahead of: each call's device work is a
    few µs)."""
    import torch

    per = []
    for _ in range(turns + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(per[1:])


def tree_worker(tree: str):
    """One turn of --ab: this tree's harness (chip_smoke.py) over the
    package of ``tree``."""
    sys.path.insert(0, tree)
    import triplegan_tpu_torch  # noqa: F401  (the package of `tree`)

    assert os.path.dirname(os.path.dirname(os.path.abspath(triplegan_tpu_torch.__file__))) == os.path.abspath(tree)
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import chip_smoke as cs
    from triplegan_tpu_torch import bridge
    from triplegan_tpu_torch.configs import get_config, make_networks
    from triplegan_tpu_torch.data.datasets import synthetic_dataset
    from triplegan_tpu_torch.data.zca import fit_zca
    from triplegan_tpu_torch.ops import scale_bias_act as sba
    from triplegan_tpu_torch.serve import app_from_state
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state
    from triplegan_tpu_torch.train.step import make_device_train_step, upload_device_data

    out = {"build_s": cs.build_phase()}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    x, k, b, g = seeded(HOST_SHAPE, "float32", gen)
    with torch.no_grad():
        out["host_us_forward"] = host_us(lambda: sba.scale_bias_act(x, k, b, "leaky_relu", 0.1))
    xr, kr, br = (v.clone().requires_grad_() for v in (x, k, b))
    out["host_us_forward_backward"] = host_us(
        lambda: torch.autograd.grad(sba.scale_bias_act(xr, kr, br, "leaky_relu", 0.1), (xr, kr, br), g),
        calls=500)

    cfg0 = get_config("cifar10_4k")
    d = cfg0.image_size * cfg0.image_size * cfg0.channels
    zca = cs.seeded_zca(d, cs.SEED)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "params.npz")
        np.savez(path, **cs.seeded_jax_export(make_networks(cfg0), cs.SEED))
        state = bridge.load_npz(path)
    images = np.random.RandomState(cs.SEED).randint(0, 256, size=(cs.BATCH, 32, 32, 3), dtype=np.uint8)
    z = np.random.RandomState(3).normal(size=(cs.BATCH, cfg0.z_dim)).astype(np.float32)
    y = (np.arange(cs.BATCH) % cfg0.num_classes).astype(np.int32)
    for dtype in ("float32", "bfloat16"):
        for use_pallas in (True, False):
            cfg = get_config("cifar10_4k")
            cfg.compute_dtype, cfg.use_pallas = dtype, use_pallas
            app = app_from_state(cfg, make_networks(cfg), state, zca_stats=zca, batch_size=cs.BATCH,
                                 device="cuda", meta={"config": cfg.name})
            for name, fn, args in (("classify", app.classify, (images,)), ("generate", app.generate, (z, y))):
                for _ in range(2):
                    fn(*args)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    fn(*args)
                torch.cuda.synchronize()
                out[f"serve {dtype} {'kernel' if use_pallas else 'plain'} {name} img/s"] = (
                    20 * cs.BATCH / (time.perf_counter() - t0))
            del app

    data = synthetic_dataset(image_size=32, channels=3, num_classes=10, n_train=4096, n_test=256,
                             num_labeled=512)
    zca = fit_zca(data.x_unlabel)
    dev_data = upload_device_data(data, "cuda")
    for setting, dtype, batch, share in cs.SETTINGS:
        for use_pallas in (True, False):
            arm = f"train {setting} {'kernel' if use_pallas else 'plain'}"
            cfg = cs.train_cfg(dtype, batch, share, use_pallas)
            nets = make_networks(cfg)
            opts = make_optimizers(cfg, cs.TOTAL_STEPS)
            state = create_state(cfg, nets, opts, device="cuda")
            step = make_device_train_step(cfg, nets, opts, cs.TOTAL_STEPS, zca_stats=zca)
            secs = []
            for _ in range(8):
                t0 = time.perf_counter()
                state, m = step(state, dev_data)
                float(m["loss_c"])
                secs.append(time.perf_counter() - t0)
            prof = cs.profile_calls(lambda: float(step(state, dev_data)[1]["loss_c"]), reps=1, top=0,
                                    groups=EPILOGUE_KERNELS)
            out[arm] = {"ms_per_step": 1e3 * statistics.mean(secs[1:]), "device_ms": prof["device_us"] / 1e3,
                        "kernels": prof["kernels"], "profiled_wall_ms": prof["wall_us"] / 1e3,
                        "epilogue_ms": {k: v["us"] / 1e3 for k, v in prof["groups"].items()}}
            del state, step
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def ab(name: str, tree: str, emit):
    """This tree and ``tree`` in turns (this, name, name, this), a process
    each; the per-key mean of each tree's two turns."""
    turns = []
    for label, path in (("this", REPO), (name, tree), (name, tree), ("this", REPO)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree-worker", path],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"the {label} turn failed:\n{proc.stderr[-4000:]}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        emit({"what": "ab turn", "tree": label, **row})
        turns.append((label, row))

    def mean(rows, key):
        vals = [r[key] for r in rows]
        if isinstance(vals[0], dict):
            return {k: mean(vals, k) for k in vals[0]}
        return statistics.mean(vals)

    for label in ("this", name):
        rows = [r for lab, r in turns if lab == label]
        emit({"what": "ab mean", "tree": label, **{k: mean(rows, k) for k in rows[0] if k != "build_s"}})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=PATH of another scale_bias_act.cu to time beside the shipped one")
    ap.add_argument("--per-step", default=None, help="chip_smoke.py --out JSON: time its train epilogues")
    ap.add_argument("--ab", default=None, metavar="NAME=TREE",
                    help="compare this tree with another checkout: wrapper host time, serving, train step")
    ap.add_argument("--tree-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--reps", type=int, default=60)
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/sba_breakdown.py runs only on a CUDA device")
    if args.tree_worker:
        tree_worker(args.tree_worker)
        return
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    smi = cs.smi_line()
    print(smi, flush=True)
    lines = []

    def emit(row):
        row["smi"] = smi
        lines.append(row)
        print(json.dumps(row), flush=True)

    if args.ab:
        ab(*args.ab.split("=", 1), emit)
    else:
        from triplegan_tpu_torch.ops import scale_bias_act as sba

        shipped = sba._lib()
        others = [(name, build_other(path)) for name, path in (o.split("=", 1) for o in args.other)]
        sources = [("shipped", shipped)] + others + [("shipped (2)", shipped)]
        gen = torch.Generator(device="cuda").manual_seed(0)
        flush = torch.zeros(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
        v = []
        for _ in range(args.reps):
            flush.sum()
            torch.cuda._sleep(cs.SPIN_CYCLES)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            e.record()
            torch.cuda.synchronize()
            v.append(s.elapsed_time(e))
        d = statistics.quantiles(v, n=10)
        emit({"what": "empty window", "ms": statistics.median(v), "p10_ms": d[0], "p90_ms": d[-1]})
        if args.per_step:
            per_step(args.per_step, sources, sba, flush, gen, args.reps, emit)
        else:
            cases(sources, sba, flush, gen, args.reps, emit)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
