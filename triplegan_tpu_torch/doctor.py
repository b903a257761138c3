"""Deployment diagnostics: ``python -m triplegan_tpu_torch.cli doctor``, the
port of ``triplegan_tpu/doctor.py``.

One command that checks what a training or serving run is about to depend
on, and names what is broken instead of hanging or failing later:

  * **device**: a probe in a subprocess with a timeout, so that a hung
    driver or build is a finding, not a hang. On ``cuda`` it finds the
    card, builds the port's kernels (``ops/csrc/scale_bias_act.cu``,
    ``conv3x3.cu``, ``conv3x3_sm90.cu`` through ``ops/build.py``, and
    ``data/csrc/batch_gather.cpp`` through ``data/native.py``), launches
    each once and holds it to its plain twin (``PROBE``); on ``cpu`` it runs
    the plain versions alone and says so. A card that was asked for and is
    missing, or a kernel that does not build, launch or agree, is a fail:
    the probe never reports a CPU run as a card run.
  * **versions**: torch, its CUDA, numpy.
  * **config**: the run dir's persisted ``config.json``.
  * **data**: the prepared ``train.npz``/``test.npz`` of the config's
    dataset, their dtype and counts; ZCA statistics for zca configs.
  * **mesh**: ``prod(mesh_shape)`` against the visible cards and
    torchrun's ``WORLD_SIZE``; batch divisibility.
  * **memory**: the train split's bytes against the card's memory when the
    dataset lives on the card (``data_on_device``).
  * **workdir**: checkpoints (``<run>/ckpt/<step>``), the latest step, and
    torn saves (``<step>.tmp-<pid>``, ``ckpt/manager.py``).

Each check yields ``(level, check, message)``, level ok|warn|fail; the CLI
exits 1 if and only if one is a fail.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from typing import List, Optional, Tuple

Finding = Tuple[str, str, str]  # level, check, message

# Seconds before the device probe counts as hung: its subprocess imports
# torch (≈10 s on an H100 machine), builds three .cu sources with nvcc in
# parallel (4–6 s each from cold) and the gather with g++, and runs a few
# small kernels; 180 leaves several times that.
DEVICE_TIMEOUT_S = 180

# The probe's calls, each launched once on the card and held to its plain
# twin: (kernel, dtype, shape). scale_bias_act: x's shape, forward and
# backward (dx, dk, db) through autograd; conv3x3_fwd: x (N, H, W, Cin) and
# Cout, a SAME conv (halo 1); conv3x3_wgrad: its filter gradient.
PROBE_ACT, PROBE_SLOPE = "leaky_relu", 0.1
PROBE = (
    ("scale_bias_act", "float32", (4, 8, 8, 32)),
    ("scale_bias_act", "bfloat16", (4, 8, 8, 32)),
    ("conv3x3", "float32", (2, 8, 8, 32, 64)),
    ("conv3x3", "bfloat16", (2, 8, 8, 32, 64)),
)
CONV_SOURCE = {"float32": "conv3x3.cu", "bfloat16": "conv3x3_sm90.cu"}


# ---------------------------------------------------------------------------
# the device probe (runs in a subprocess)
# ---------------------------------------------------------------------------


def _bf16_ulp(v):
    import torch

    return torch.exp2(torch.floor(torch.log2(torch.clamp_min(v.abs().double(), 2.0 ** -126))) - 7)


def _excess(got, want, lim) -> Tuple[float, float]:
    """(max |got − want|, max of |got − want| − lim): ≤ 0 agrees."""
    err = (got.double() - want.double()).abs()
    return float(err.max()), float((err - lim).max())


def _elementwise_lim(got, want):
    """chip_smoke.py's epilogue tolerance: float32 1e-6·(1 + |want|),
    bfloat16 one ulp of the larger magnitude."""
    import torch

    if got.dtype == torch.float32:
        return 1e-6 * (1.0 + want.double().abs())
    return _bf16_ulp(torch.maximum(got.abs(), want.abs()))


def _probe_sba(dtype: str, shape, dev) -> dict:
    import torch

    from triplegan_tpu_torch.ops import scale_bias_act as sba

    gen = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype)
    c = shape[-1]
    x, g = (torch.randn(shape, generator=gen).to(dt).to(dev) for _ in range(2))
    k = (torch.randn(c, generator=gen) * 0.5 + 1.0).to(dt).to(dev)
    b = (torch.randn(c, generator=gen) * 0.3).to(dt).to(dev)
    f0, b0 = sba.launches.total(), sba.bwd_launches.total()
    xr, kr, br = (t.clone().requires_grad_(True) for t in (x, k, b))
    y = sba.scale_bias_act(xr, kr, br, PROBE_ACT, PROBE_SLOPE)
    dx, dk, db = torch.autograd.grad(y, (xr, kr, br), g)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {"scale_bias_act": sba.launches.total() - f0,
                "scale_bias_act_bwd": sba.bwd_launches.total() - b0}
    want_launches = 1 if dev.type == "cuda" else 0
    if any(n != want_launches for n in launches.values()):
        raise RuntimeError(f"scale_bias_act {dtype}: launches {launches}, want {want_launches} of each")
    want_y = sba.reference_scale_bias_act(x, k, b, PROBE_ACT, PROBE_SLOPE)
    want_dx, _, _ = sba.reference_scale_bias_act_bwd(x, k, b, g, PROBE_ACT, PROBE_SLOPE)
    errs = {}
    for name, got, want in (("forward", y.detach(), want_y), ("dx", dx, want_dx)):
        errs[name], over = _excess(got, want, _elementwise_lim(got, want))
        if over > 0:
            raise RuntimeError(f"scale_bias_act {dtype} {name}: max err {errs[name]} exceeds its tolerance")
    # dk, db against the exact sums of their terms, within γ_n·Σ|terms| for
    # the kernel's summation depth n (one bfloat16 ulp more at bfloat16)
    t = sba.reference_bwd_t(x, k, b, g, PROBE_ACT, PROBE_SLOPE).reshape(-1, c)
    depth = sba.bwd_plan(t.shape[0], c, dt, PROBE_ACT, 7, True)[1] if dev.type == "cuda" else t.shape[0]
    u = depth * 2.0 ** -24 / (1.0 - depth * 2.0 ** -24)
    for name, got, terms in (("dk", dk, t * x.reshape(-1, c)), ("db", db, t)):
        exact = terms.double().sum(0)
        lim = u * terms.double().abs().sum(0)
        if got.dtype == torch.bfloat16:
            lim = lim + _bf16_ulp(torch.maximum(got.double().abs(), exact.abs()))
        errs[name], over = _excess(got, exact, lim)
        if over > 0:
            raise RuntimeError(f"scale_bias_act {dtype} {name}: max err {errs[name]} exceeds its tolerance")
    return {"kernel": "scale_bias_act", "dtype": dtype,
            "source": "scale_bias_act.cu" if dev.type == "cuda" else "plain", "launches": launches,
            "max_abs_err": errs}


def _probe_conv(dtype: str, shape, dev) -> dict:
    import torch

    from triplegan_tpu_torch.ops import conv3x3 as cv

    n, h, w, cin, cout = shape
    gen = torch.Generator().manual_seed(1)
    dt = getattr(torch, dtype)
    x = torch.randn((n, h, w, cin), generator=gen).to(dt).to(dev)
    wt = (torch.randn((3, 3, cin, cout), generator=gen) / math.sqrt(9 * cin)).to(dt).to(dev)
    g = torch.randn((n, h, w, cout), generator=gen).to(dt).to(dev)
    f0, w0 = cv.fwd_launches.total(), cv.wgrad_launches.total()
    y = cv.conv3x3_nopad(x, wt, 1)
    dw = cv.conv3x3_wgrad(x, g, 1)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {"conv3x3_fwd": cv.fwd_launches.total() - f0, "conv3x3_wgrad": cv.wgrad_launches.total() - w0}
    want_launches = 1 if dev.type == "cuda" else 0
    if any(v != want_launches for v in launches.values()):
        raise RuntimeError(f"conv3x3 {dtype}: launches {launches}, want {want_launches} of each")
    xp = cv._pad_hw(x, 1)
    errs = {}
    # chip_smoke.py's conv tolerance: 8·sqrt(K)·2⁻²⁴·(the plain op on |inputs|),
    # K the length of each sum, plus one bfloat16 ulp of a bfloat16 output
    for name, got, want, mag, k_len in (
            ("forward", y, cv.reference_conv3x3_nopad(xp, wt),
             cv.reference_conv3x3_nopad(xp.abs(), wt.abs()).float(), 9 * cin),
            ("wgrad", dw, cv.reference_conv3x3_wgrad(xp, g),
             cv.reference_conv3x3_wgrad(xp.abs(), g.abs()), n * h * w)):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise RuntimeError(f"conv3x3 {dtype} {name}: {tuple(got.shape)} {got.dtype}, want "
                               f"{tuple(want.shape)} {want.dtype}")
        lim = 8.0 * math.sqrt(k_len) * 2.0 ** -24 * mag.double()
        if got.dtype == torch.bfloat16:
            lim = lim + _bf16_ulp(torch.maximum(got.abs(), want.abs()))
        errs[name], over = _excess(got, want, lim)
        if not bool(torch.isfinite(got).all()) or over > 0:
            raise RuntimeError(f"conv3x3 {dtype} {name}: max err {errs[name]} exceeds its tolerance")
    return {"kernel": "conv3x3", "dtype": dtype, "source": CONV_SOURCE[dtype] if dev.type == "cuda" else "plain",
            "launches": launches, "max_abs_err": errs}


def _probe(device: str, build_dir: str) -> None:
    """The probe's body (``check_device`` runs it in a subprocess): prints
    ``DOCTOR_DEVICES``, ``DOCTOR_MEM``, one ``DOCTOR_BUILD`` a source (its
    seconds), one ``DOCTOR_KERNEL`` JSON a ``PROBE`` entry, then
    ``DOCTOR_OK``; raises at the first fault."""
    import concurrent.futures

    import torch

    from triplegan_tpu_torch.data import native
    from triplegan_tpu_torch.ops import build
    from triplegan_tpu_torch.utils.cache import enable_build_cache
    from triplegan_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)  # raises without a card when one is asked for
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        print("DOCTOR_DEVICES", "cuda", torch.cuda.device_count(), name, flush=True)
        print("DOCTOR_MEM", torch.cuda.get_device_properties(dev).total_memory, flush=True)
        enable_build_cache(build_dir)

        def timed(fn, *a):
            t0 = time.perf_counter()
            fn(*a)
            return time.perf_counter() - t0

        jobs = {f"{n}.cu": (build.load, n) for n in ("scale_bias_act", "conv3x3", "conv3x3_sm90")}
        jobs["batch_gather.cpp"] = (native._load,)
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
            futs = {src: ex.submit(timed, *job) for src, job in jobs.items()}
            for src, fut in futs.items():
                print("DOCTOR_BUILD", src, f"{fut.result():.2f}", flush=True)
    else:
        print("DOCTOR_DEVICES", "cpu", 1, "cpu", flush=True)
        print("DOCTOR_MEM", 0, flush=True)
    for kernel, dtype, shape in PROBE:
        rec = (_probe_sba if kernel == "scale_bias_act" else _probe_conv)(dtype, shape, dev)
        print("DOCTOR_KERNEL", json.dumps(rec), flush=True)
    print("DOCTOR_OK", flush=True)


def _kernel_summary(rec: dict) -> str:
    return (f"{rec['kernel']} {rec['dtype']} ({rec['source']}, launches "
            + ", ".join(f"{k} {v}" for k, v in rec["launches"].items())
            + "; max err " + ", ".join(f"{k} {v:.3g}" for k, v in rec["max_abs_err"].items()) + ")")


def check_device(timeout_s: int = DEVICE_TIMEOUT_S, device: str = "cuda"):
    """Run the device probe (``_probe``) in a subprocess, ``timeout_s``
    seconds at most. Returns ``(findings, visible, memory_bytes)``:
    ``visible`` the card count (None unless the probe found the device),
    ``memory_bytes`` the card's total memory (None on the CPU). The probe
    builds into the current build directory (``ops/build.py::build_dir``)."""
    from triplegan_tpu_torch.ops import build

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    code = "import sys; from triplegan_tpu_torch.doctor import _probe; _probe(sys.argv[1], sys.argv[2])"
    try:
        out = subprocess.run([sys.executable, "-c", code, device, build.build_dir()], capture_output=True,
                             text=True, timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired:
        return [("fail", "device", f"the {device} probe hung > {timeout_s} s (device init, a kernel "
                                   "build or a launch); rerun with a longer --device-timeout to tell "
                                   "a slow machine from a hung one")], None, None
    visible = memory = None
    what, builds, kernels, ok = "", [], [], False
    for line in out.stdout.splitlines():
        head, _, rest = line.partition(" ")
        if head == "DOCTOR_DEVICES":
            backend, n, name = rest.split(" ", 2)
            visible = int(n)
            what = f"{n} card(s), {name}" if backend == "cuda" else "the CPU"
        elif head == "DOCTOR_MEM":
            memory = int(rest) or None
        elif head == "DOCTOR_BUILD":
            src, secs = rest.split()
            builds.append(f"{src} {float(secs):.1f} s")
        elif head == "DOCTOR_KERNEL":
            kernels.append(_kernel_summary(json.loads(rest)))
        elif head == "DOCTOR_OK":
            ok = out.returncode == 0
    if not ok:
        tail = (out.stderr or out.stdout).strip().splitlines()
        return [("fail", "device", f"{device} probe failed (exit {out.returncode}): "
                                   f"{tail[-1] if tail else 'no output'}")], visible, memory
    if device == "cpu":
        msg = (f"cpu, as asked: the kernels' plain versions ran (nothing built, no kernel launched): "
               + "; ".join(kernels))
    else:
        msg = (f"{what}, {memory / 2 ** 30:.1f} GiB; built " + ", ".join(builds)
               + "; each kernel launched and held to its plain twin: " + "; ".join(kernels))
    return [("ok", "device", msg)], visible, memory


# ---------------------------------------------------------------------------
# the other checks (in process)
# ---------------------------------------------------------------------------


def check_versions() -> List[Finding]:
    """torch (and the CUDA it was built for) and numpy. A package that does
    not import is a fail finding, not a traceback. (A missing ``nvcc`` is
    the device check's to report.)"""
    import importlib

    parts, findings = [], []
    for label in ("torch", "numpy"):
        try:
            mod = importlib.import_module(label)
        except Exception as e:
            findings.append(("fail", "versions", f"{label} unavailable: {type(e).__name__}: {e}"))
            continue
        parts.append(f"{label} {mod.__version__}")
        if label == "torch":
            parts.append(f"cuda {mod.version.cuda or 'none (a CPU build of torch)'}")
    if parts:
        findings.insert(0, ("ok", "versions", ", ".join(parts)))
    return findings


def check_config(cfg, workdir: str) -> List[Finding]:
    saved = os.path.join(workdir, "config.json")
    if os.path.exists(saved):
        return [("ok", "config", f"{cfg.name}: run-dir {saved} merged")]
    return [("warn", "config", f"{cfg.name}: no persisted config.json under {workdir} "
                               "(a fresh run dir, or the wrong --workdir)")]


def check_data(cfg) -> List[Finding]:
    import numpy as np

    if cfg.dataset == "synthetic":
        return [("ok", "data", "synthetic dataset (no files needed)")]
    d = os.path.join(cfg.data_dir, cfg.dataset)
    findings: List[Finding] = []
    for split in ("train", "test"):
        path = os.path.join(d, f"{split}.npz")
        if not os.path.exists(path):
            findings.append(("fail", "data", f"missing {path} — run: python -m triplegan_tpu_torch.cli "
                                             f"prepare --dataset {cfg.dataset} --raw-dir <raw> "
                                             f"--data-dir {cfg.data_dir}"))
            continue
        try:
            with np.load(path, allow_pickle=False) as f:
                x, y = f["images"], f["labels"]
        except Exception as e:
            findings.append(("fail", "data", f"{path}: unreadable ({e})"))
            continue
        if x.dtype != np.uint8 or x.ndim != 4:
            findings.append(("fail", "data", f"{path}: images must be uint8 NHWC, got {x.dtype} {x.shape}"))
        elif len(x) != len(y):
            findings.append(("fail", "data", f"{path}: {len(x)} images vs {len(y)} labels"))
        else:
            findings.append(("ok", "data", f"{path}: {len(x)} images {x.shape[1:]}"))
    if cfg.zca:
        cache = os.path.join(cfg.workdir, cfg.name, "zca_stats.npz")
        prepared = os.path.join(d, "zca_stats.npz")
        if os.path.exists(cache):
            findings.append(("ok", "zca", f"stats cache {cache}"))
        elif os.path.exists(prepared):
            findings.append(("ok", "zca", f"stats fitted at prepare time, {prepared}"))
        else:
            findings.append(("warn", "zca", f"no {cache} or {prepared} — the first run fits ZCA on the "
                                            "train set (a one-time cost)"))
    return findings


def check_mesh(cfg, visible_devices: Optional[int] = None, env=None) -> List[Finding]:
    """``prod(mesh_shape)`` ranks, one a card: the batch must divide over
    them; under torchrun (``WORLD_SIZE`` set) the world must be that many
    and this machine's processes (``LOCAL_WORLD_SIZE``) must each find a
    card; otherwise, on one machine, the cards must number at least that
    many."""
    env = os.environ if env is None else env
    n = math.prod(cfg.mesh_shape)
    findings: List[Finding] = []
    if cfg.batch_size % n:
        findings.append(("fail", "mesh", f"batch_size={cfg.batch_size} not divisible by the "
                                         f"{n}-rank mesh {tuple(cfg.mesh_shape)}"))
    else:
        findings.append(("ok", "mesh", f"mesh {tuple(cfg.mesh_shape)}, {cfg.batch_size // n} images a rank"))
    need = n
    if "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
        if world != n:
            findings.append(("fail", "mesh", f"mesh needs {n} processes but torchrun started {world} "
                                             f"(WORLD_SIZE)"))
        need = int(env.get("LOCAL_WORLD_SIZE", world))
    elif cfg.get("multihost", False):
        need = 1  # one process a machine, joined through the multihost_* fields
    if visible_devices is not None and visible_devices < need:
        findings.append(("fail", "mesh", f"mesh needs {need} cards on this machine but only "
                                         f"{visible_devices} visible"))
    return findings


def _npz_nbytes(path: str) -> int:
    """The uncompressed bytes of the arrays in an .npz, read from the npy
    headers of its members: no array is loaded."""
    import zipfile

    import numpy as np
    from numpy.lib import format as npy_format

    total = 0
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            with z.open(name) as f:
                # (1, 0) headers have a 2-byte length, later ones a 4-byte length
                read = npy_format.read_array_header_1_0 if npy_format.read_magic(f) == (1, 0) \
                    else npy_format.read_array_header_2_0
                shape, _, dtype = read(f)
            total += int(np.prod(shape)) * dtype.itemsize
    return total


def check_memory(cfg, memory_bytes: Optional[int] = None) -> List[Finding]:
    """With ``data_on_device`` (the default) the whole train split is
    uploaded to the card at start: its bytes against the card's memory, a
    warning above half of it, a fail above 0.9."""
    if not cfg.get("data_on_device", False):
        return [("ok", "memory", "host-streamed batches (data_on_device=False): the dataset stays on "
                                 "the host")]
    if cfg.dataset == "synthetic":
        return [("ok", "memory", "synthetic dataset (negligible on the card)")]
    path = os.path.join(cfg.data_dir, cfg.dataset, "train.npz")
    if not os.path.exists(path):
        return []  # the data check has failed already
    try:
        resident = _npz_nbytes(path)
    except Exception as e:
        return [("warn", "memory", f"could not size {path} ({e})")]
    human = f"{resident / 2 ** 30:.2f} GiB"
    if memory_bytes:
        frac = resident / memory_bytes
        msg = (f"dataset on the card ≈ {human} = {frac:.0%} of its "
               f"{memory_bytes / 2 ** 30:.1f} GiB")
        if frac > 0.9:
            return [("fail", "memory", msg + " — will run out of memory at start; set "
                                             "data_on_device=False")]
        if frac > 0.5:
            return [("warn", "memory", msg + " — leaves little room for activations; consider "
                                             "data_on_device=False")]
        return [("ok", "memory", msg)]
    return [("ok", "memory", f"dataset on the device ≈ {human} (the device's memory is not known "
                             "here)")]


def check_workdir(workdir: str) -> List[Finding]:
    from triplegan_tpu_torch.ckpt.manager import _TMP

    ckpt_dir = os.path.join(workdir, "ckpt")
    if not os.path.isdir(ckpt_dir):
        return [("warn", "workdir", f"no checkpoints yet under {ckpt_dir}")]
    steps, torn = [], []
    for name in os.listdir(ckpt_dir):
        if _TMP in name:
            torn.append(name)
        elif name.isdigit():
            steps.append(int(name))
    findings: List[Finding] = []
    if steps:
        findings.append(("ok", "workdir", f"{len(steps)} checkpoint(s), latest step {max(steps)}"))
    else:
        findings.append(("warn", "workdir", f"{ckpt_dir} exists but holds no steps"))
    if torn:
        findings.append(("warn", "workdir", f"{len(torn)} torn checkpoint tmp file(s) (a save cut off "
                                            "before its rename; the next training run deletes them)"))
    return findings


def run_doctor(cfg=None, workdir: Optional[str] = None, skip_device: bool = False,
               device_timeout_s: int = DEVICE_TIMEOUT_S, device: str = "cuda") -> List[Finding]:
    findings: List[Finding] = []
    findings += check_versions()
    visible = memory = None
    if not skip_device:
        device_findings, visible, memory = check_device(device_timeout_s, device)
        findings += device_findings
    if cfg is not None:
        findings += check_config(cfg, workdir)
        findings += check_data(cfg)
        findings += check_mesh(cfg, visible_devices=visible)
        findings += check_memory(cfg, memory_bytes=memory)
        findings += check_workdir(workdir)
    return findings


def format_findings(findings: List[Finding]) -> str:
    mark = {"ok": "✓", "warn": "!", "fail": "✗"}
    return "\n".join(f"{mark[lv]} {name:<9} {msg}" for lv, name, msg in findings)
