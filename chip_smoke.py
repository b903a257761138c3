#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Phases, each fatal on failure (exit code 1, and no result line):

  1. device: a CUDA device must be present; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles every kernel of the path from the sources in this
     checkout (triplegan_tpu_torch/ops/csrc) and prints the seconds;
  3. kernels: runs each kernel's wrapper at every shape the serving path
     gives it, float32 and bfloat16, holds it to its plain PyTorch version
     on the same inputs, and times both with CUDA events (L2 flushed
     before each run; median of 30 after 5 warm-up runs);
  4. serve: builds cifar10_4k at full width from seeded weights (written
     and read back in the JAX package's npz export format), seeded batch
     norm statistics and seeded ZCA statistics, for each compute dtype and
     each epilogue arm (use_pallas True: the kernel; False: plain PyTorch),
     starts the port's HTTP server on an ephemeral port in a thread and
     drives /healthz, /classify (250 images: three chunks of the static
     batch of 100, the last padded), /generate (JSON, with and without
     pixels) and /metrics. The kernel's launch count is set to 0 just
     before and read just after, and must rise by 9 per classify chunk and
     4 per generate chunk; the plain arm must launch nothing. Outputs are
     checked for shape, dtype and finiteness, the two arms against each
     other, and the float32 card outputs against the plain path on the
     CPU on a few inputs. Images/s are timed per arm.

The last three lines of standard output are the kernels' JSON summary,
nvidia-smi's line again, and ``{"ok": true, "device": {...}}``.

Tolerances: a kernel against its plain version, float32:
|kernel − plain| ≤ 1e-6·(1 + |plain|); bfloat16: at most one bfloat16 ulp.
Kernel arm against plain arm on the card, float32: logits within
1e-4·(1 + max|logit|), images within 1e-4 (the weight-norm output deconv
folds its norm into the epilogue in one arm and into the kernel in the
other); bfloat16 logits within 16 bfloat16 ulps of the largest logit (the
plain arm rounds x·k and then +b to bfloat16 at each of 9 layers, the
kernel rounds once). Card against CPU, float32: within 1e-3·(1 + max|ref|)
(cuDNN and the CPU library may pick different conv algorithms).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
SEED = 0
BATCH = 100
N_REQ = 250                   # images per request: chunks 100, 100, 50 (+50 pad)
CLF_SHAPES = [(100, 32, 32, 128)] * 3 + [(100, 16, 16, 256)] * 3 + [
    (100, 6, 6, 512), (100, 6, 6, 256), (100, 6, 6, 128)]
GEN_SHAPES = [(100, 4, 4, 512), (100, 8, 8, 256), (100, 16, 16, 128)]
GEN_OUT_SHAPE = (100, 32, 32, 3)
RAGGED_SHAPE = (7, 13, 11, 37)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------


def bf16_ulp(v):
    import torch

    mag = torch.clamp_min(v.abs().double(), 2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def max_excess(got, want, dtype) -> tuple:
    """(max |got − want|, max of (|got − want| − tolerance)): ≤ 0 passes."""
    import torch

    err = (got.double() - want.double()).abs()
    if dtype == torch.float32:
        lim = 1e-6 * (1.0 + want.double().abs())
    else:
        lim = bf16_ulp(torch.maximum(got.abs(), want.abs()))
    return float(err.max()), float((err - lim).max())


def time_ms(fn, flush, reps=30, warm=5) -> dict:
    """Median device time of one call, L2 flushed before each (cold), and
    the mean of a back-to-back loop of ``reps`` calls (warm L2)."""
    import torch

    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return {
        "cold": statistics.median(a.elapsed_time(b) for a, b in pairs),
        "warm": s.elapsed_time(e) / reps,
    }


def kernel_phase(sba) -> list:
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    cases = []
    for shape in sorted(set(CLF_SHAPES)):
        cases.append(("clf", "leaky_relu", 0.1, shape))
    for shape in GEN_SHAPES:
        cases.append(("gen", "relu", 0.1, shape))
    cases.append(("gen_out", "tanh", 0.1, GEN_OUT_SHAPE))
    cases.append(("ragged", "linear", 0.1, RAGGED_SHAPE))
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for where, act, slope, shape in cases:
            c = shape[-1]
            x = (torch.randn(shape, generator=gen, device=dev) * 2.0).to(dtype)
            k = torch.randn(c, generator=gen, device=dev) * 0.5 + 1.0
            b = torch.randn(c, generator=gen, device=dev) * 0.3
            got = sba.scale_bias_act(x, k, b, act, slope)
            torch.cuda.synchronize()
            want = sba.reference_scale_bias_act(x, k, b, act, slope)
            check(got.dtype == dtype and got.shape == x.shape, f"kernel output {got.dtype} {tuple(got.shape)}")
            err, excess = max_excess(got, want, dtype)
            check(excess <= 0, f"scale_bias_act {act} {shape} {dtype}: max err {err} exceeds tolerance")
            tk = time_ms(lambda: sba.scale_bias_act(x, k, b, act, slope), flush)
            tp = time_ms(lambda: sba.reference_scale_bias_act(x, k, b, act, slope), flush)
            # Host time to issue one call (no device wait): what a chain of
            # small epilogues costs when the host, not the card, is the limit.
            for fn, t in ((lambda: sba.scale_bias_act(x, k, b, act, slope), tk),
                          (lambda: sba.reference_scale_bias_act(x, k, b, act, slope), tp)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(100):
                    fn()
                t["host_us"] = (time.perf_counter() - t0) * 1e4
                torch.cuda.synchronize()
            esize = x.element_size()
            nbytes = 2 * x.numel() * esize + 2 * c * esize  # x read, y written, k and b read
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 3 * x.numel() / F32_FLOPS_PER_S * 1e3  # mul, add, activation
            rows.append({
                "where": where, "act": act, "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                "max_abs_err": err, "ms": tk["cold"], "warm_ms": tk["warm"],
                "plain_ms": tp["cold"], "plain_warm_ms": tp["warm"],
                "host_us": tk["host_us"], "plain_host_us": tp["host_us"],
                "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            })
    del flush
    return rows


# ---------------------------------------------------------------------------
# phase 4: serving end to end
# ---------------------------------------------------------------------------


def seeded_jax_export(nets, seed: int) -> dict:
    """Every weight and batch-norm statistic of the port's nets drawn from
    ``seed`` at scales that keep activations O(1) through the full-width
    stack (He-normal kernels; gains, biases and statistics near their
    identities), in the JAX package's flat npz export layout."""
    import torch

    from triplegan_tpu_torch import bridge

    g = torch.Generator().manual_seed(seed)
    state = {}
    for player, net in zip(("gen", "clf"), nets):
        sd = {}
        for key, t in net.state_dict().items():
            name = key.split(".")[1]
            if name in ("w", "v"):
                if t.dim() == 4 and player == "gen":   # (k, k, in, out), stride-2 deconv
                    fan_in = t.shape[0] * t.shape[1] * t.shape[2] / 4
                elif t.dim() == 4:                      # OIHW conv
                    fan_in = t.shape[1] * t.shape[2] * t.shape[3]
                else:                                   # (in, out) dense
                    fan_in = t.shape[0]
                sd[key] = torch.randn(t.shape, generator=g) * (2.0 / fan_in) ** 0.5
            elif name in ("g", "scale"):
                sd[key] = 0.8 + 0.4 * torch.rand(t.shape, generator=g)
            elif name == "var":
                sd[key] = 0.5 + torch.rand(t.shape, generator=g)
            else:  # b, bias, mean
                sd[key] = 0.1 * torch.randn(t.shape, generator=g)
        state[player] = sd
    params, bn = bridge.to_jax(state)
    flat = {}
    for kind, tree in (("params", params), ("bn", bn)):
        for player, layers in tree.items():
            for layer, arrays in layers.items():
                for name, a in arrays.items():
                    flat[f"{kind}/{player}/{layer}/{name}"] = a
    return flat


def seeded_zca(d: int, seed: int):
    from triplegan_tpu_torch.data.zca import ZCAStats

    rng = np.random.RandomState(seed)
    a = rng.normal(size=(d, d)).astype(np.float32) * (0.1 / d ** 0.5)
    return ZCAStats(mean=(rng.normal(size=d) * 0.05).astype(np.float32),
                    whiten=(np.eye(d, dtype=np.float32) + (a + a.T) / 2))


def http(method: str, url: str, body: bytes = None, ctype: str = None):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers={"Content-Type": ctype} if ctype else {})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read()


def load_npy(body: bytes) -> np.ndarray:
    return np.load(io.BytesIO(body), allow_pickle=False)


def npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def start_arm(cfg, state, zca, images, sba) -> dict:
    """Start one server for one (compute dtype, use_pallas) arm and drive
    the main path through it: /healthz, /classify, /generate twice,
    /metrics, with the kernel's launch count set to 0 just before and read
    just after. The server keeps running for the timing turns."""
    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.serve import app_from_state, make_server

    app = app_from_state(cfg, make_networks(cfg), state, zca_stats=zca, batch_size=BATCH,
                         device="cuda", meta={"config": cfg.name})
    server = make_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    arm = {"dtype": cfg.compute_dtype, "use_pallas": bool(cfg.use_pallas),
           "_app": app, "_server": server, "_thread": thread, "_base": base}
    chunks = -(-N_REQ // BATCH)

    sba.launches = 0  # the main path starts here
    status, body = http("GET", base + "/healthz")
    health = json.loads(body)
    check(status == 200 and health["status"] == "ok" and health["backend"] == "cuda",
          f"/healthz: {health}")
    status, body = http("POST", base + "/classify", npy(images), "application/x-npy")
    logits = load_npy(body)
    n_classify = sba.launches
    status, body = http("POST", base + "/generate",
                        json.dumps({"n": N_REQ, "seed": 3}).encode(), "application/json")
    imgs = load_npy(body)
    n_generate = sba.launches - n_classify
    status, body = http("POST", base + "/generate",
                        json.dumps({"n": N_REQ, "seed": 3, "pixels": True}).encode(),
                        "application/json")
    pixels = load_npy(body)
    status, body = http("GET", base + "/metrics")
    metrics = body.decode()
    arm["launches"] = sba.launches  # the main path ends here

    check(logits.shape == (N_REQ, cfg.num_classes) and logits.dtype == np.float32,
          f"/classify gave {logits.shape} {logits.dtype}")
    check(bool(np.isfinite(logits).all()), "/classify gave non-finite logits")
    shape = (N_REQ, cfg.image_size, cfg.image_size, cfg.channels)
    check(imgs.shape == shape and imgs.dtype == np.float32, f"/generate gave {imgs.shape} {imgs.dtype}")
    check(bool(np.isfinite(imgs).all()) and float(np.abs(imgs).max()) <= 1.0,
          "/generate gave values outside [-1, 1]")
    check(pixels.shape == shape and pixels.dtype == np.uint8, f"/generate pixels gave {pixels.dtype}")
    expect = np.clip((imgs + 1.0) * 127.5, 0, 255).astype(np.uint8)
    check(bool((pixels == expect).all()), "pixels disagree with the [-1, 1] images")
    check('triplegan_requests_total{endpoint="classify"} 1' in metrics
          and 'triplegan_requests_total{endpoint="generate"} 2' in metrics, "/metrics counters")
    if cfg.use_pallas:
        check(n_classify == 9 * chunks, f"classify launched the kernel {n_classify} times, want {9 * chunks}")
        check(n_generate == 4 * chunks, f"generate launched the kernel {n_generate} times, want {4 * chunks}")
        check(arm["launches"] == 9 * chunks + 2 * 4 * chunks, f"main path launches {arm['launches']}")
    else:
        check(arm["launches"] == 0, f"the plain arm launched the kernel {arm['launches']} times")
    arm["_logits"], arm["_imgs"] = logits, imgs
    return arm


def stop_arm(arm):
    arm["_server"].shutdown()
    arm["_server"].server_close()
    arm["_thread"].join(timeout=30)
    check(not arm["_thread"].is_alive(), "server thread did not stop")


def time_arm(arm, images, z, y) -> dict:
    """Images/s of one arm, warm: the server's per-chunk function at the
    static batch (host→device copy, forward, device→host copy; 20 chunks
    after 3 warm-up chunks), and whole HTTP requests of 250 (median of 3)."""
    import torch

    app, base = arm["_app"], arm["_base"]
    out = {}
    for name, fn, args in (("classify", app.classify, (images[:BATCH],)),
                           ("generate", app.generate, (z[:BATCH], y[:BATCH]))):
        for _ in range(3):
            fn(*args)
        torch.cuda.synchronize()
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
        out[f"{name}_img_s"] = reps * BATCH / (time.perf_counter() - t0)
    for name, body, ctype in (
        ("classify", npy(images), "application/x-npy"),
        ("generate", json.dumps({"n": N_REQ, "seed": 3}).encode(), "application/json"),
    ):
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            http("POST", base + "/" + name, body, ctype)
            secs.append(time.perf_counter() - t0)
        out[f"http_{name}_img_s"] = N_REQ / statistics.median(secs)
    return out


def profile_arm(arm, images, z, y) -> dict:
    """torch.profiler over 10 chunks of each function: the device's busy
    share of the wall time and the five kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    app = arm["_app"]
    out = {}
    for name, fn, args in (("classify", app.classify, (images[:BATCH],)),
                           ("generate", app.generate, (z[:BATCH], y[:BATCH]))):
        fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                fn(*args)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        stats = prof.key_averages()
        # Device work is the kernel and memcpy events themselves; the host
        # ops that launched them carry the same time again, so skip those.
        kernels = [e for e in stats if e.device_type == DeviceType.CUDA]
        host = [e for e in stats if e.device_type == DeviceType.CPU]
        busy_us = sum(e.self_device_time_total for e in kernels)
        out[name] = {
            "wall_us_per_chunk": wall_us / 10, "device_us_per_chunk": busy_us / 10,
            "device_busy_share": busy_us / wall_us,
            "top_device": [{"name": e.key[:70], "us_per_chunk": e.self_device_time_total / 10,
                            "calls_per_chunk": e.count / 10}
                           for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]],
            "top_host": [{"name": e.key[:70], "self_us_per_chunk": e.self_cpu_time_total / 10,
                          "calls_per_chunk": e.count / 10}
                         for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:6]],
        }
    return out


def cpu_reference(cfg, state, zca, images, z, y):
    """The plain path on the CPU (float32, use_pallas off) on a few inputs."""
    import torch

    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.export import make_serving_fns

    classify, generate = make_serving_fns(cfg, make_networks(cfg), state, zca_stats=zca, device="cpu")
    return (classify(torch.from_numpy(images)).numpy(),
            generate(torch.from_numpy(z), torch.from_numpy(y)).numpy())


def serve_phase(sba, profile: bool) -> list:
    from triplegan_tpu_torch import bridge
    from triplegan_tpu_torch.configs import get_config, make_networks

    cfg0 = get_config("cifar10_4k")
    d = cfg0.image_size * cfg0.image_size * cfg0.channels
    zca = seeded_zca(d, SEED)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "params.npz")
        np.savez(path, **seeded_jax_export(make_networks(cfg0), SEED))
        state = bridge.load_npz(path)
    images = np.random.RandomState(SEED).randint(
        0, 256, size=(N_REQ, cfg0.image_size, cfg0.image_size, cfg0.channels), dtype=np.uint8)
    z = np.random.RandomState(3).normal(size=(N_REQ, cfg0.z_dim)).astype(np.float32)
    y = (np.arange(N_REQ) % cfg0.num_classes).astype(np.int32)

    arms = {}
    try:
        for dtype in ("float32", "bfloat16"):
            for use_pallas in (True, False):
                cfg = get_config("cifar10_4k")
                cfg.compute_dtype, cfg.use_pallas = dtype, use_pallas
                arms[dtype, use_pallas] = start_arm(cfg, state, zca, images, sba)

        # Timing in turns within each dtype (kernel, plain, plain, kernel),
        # so a drift of clocks or host load over the run falls on both arms.
        for dtype in ("float32", "bfloat16"):
            for use_pallas in (True, False, False, True):
                arm = arms[dtype, use_pallas]
                for key, v in time_arm(arm, images, z, y).items():
                    arm.setdefault("_turns", {}).setdefault(key, []).append(v)
        for arm in arms.values():
            for key, vals in arm.pop("_turns").items():
                arm[key] = statistics.mean(vals)
                arm[key + "_turns"] = vals
            if profile:
                arm["profile"] = profile_arm(arm, images, z, y)
    finally:
        for arm in arms.values():
            stop_arm(arm)
    for arm in arms.values():
        print(json.dumps({"serve": {k: v for k, v in arm.items() if not k.startswith("_")}}),
              flush=True)

    for dtype in ("float32", "bfloat16"):
        k, p = arms[dtype, True], arms[dtype, False]
        scale = float(np.abs(p["_logits"]).max())
        dl = float(np.abs(k["_logits"] - p["_logits"]).max())
        di = float(np.abs(k["_imgs"] - p["_imgs"]).max())
        lim = 1e-4 * (1.0 + scale) if dtype == "float32" else 16 * 2.0 ** -8 * scale
        print(json.dumps({"arms_agree": {"dtype": dtype, "max_logit": scale, "logits_max_abs_diff": dl,
                                         "logits_limit": lim, "images_max_abs_diff": di,
                                         "images_limit": 1e-4}}), flush=True)
        check(dl <= lim, f"{dtype}: kernel and plain arms' logits differ by {dl} > {lim}")
        check(di <= 1e-4, f"{dtype}: kernel and plain arms' images differ by {di}")

    cfg = get_config("cifar10_4k")
    cfg.use_pallas = False
    n = 4
    ref_logits, ref_imgs = cpu_reference(cfg, state, zca, images[:n], z[:n], y[:n])
    card = arms["float32", True]
    for name, got, ref in (("logits", card["_logits"][:n], ref_logits), ("images", card["_imgs"][:n], ref_imgs)):
        diff = float(np.abs(got - ref).max())
        lim = 1e-3 * (1.0 + float(np.abs(ref).max()))
        print(json.dumps({"card_vs_cpu": {"what": name, "max_abs_diff": diff, "limit": lim}}), flush=True)
        check(diff <= lim, f"card and CPU {name} differ by {diff} > {lim}")
    return list(arms.values())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write every result as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also trace each serving arm with torch.profiler (device busy share, top kernels)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only on a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from triplegan_tpu_torch.ops import build
    from triplegan_tpu_torch.ops import scale_bias_act as sba
    from triplegan_tpu_torch.utils.platform import resolve_device

    # 1. device
    dev = resolve_device(None)
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} (count {torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda})", flush=True)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.build("scale_bias_act")
    sba._lib()
    build_s = time.perf_counter() - t0
    print(json.dumps({"build": {"kernel": "scale_bias_act", "seconds": build_s}}), flush=True)

    # 3. kernels
    rows = kernel_phase(sba)
    for r in rows:
        print(json.dumps({"scale_bias_act": r}), flush=True)

    # 4. serve
    arms = serve_phase(sba, args.profile)
    torch.cuda.synchronize(dev)

    # 5. summary: per served batch pair (one classify chunk and one generate
    # chunk of 100) at the shipped float32, the sum over its 13 epilogues.
    f32 = {(r["where"], tuple(r["shape"])): r for r in rows if r["dtype"] == "float32"}
    path = [("clf", s) for s in CLF_SHAPES] + [("gen", s) for s in GEN_SHAPES] + [("gen_out", GEN_OUT_SHAPE)]
    total = {key: sum(f32[w, s][key] for w, s in path) for key in ("ms", "plain_ms", "bound_ms")}
    kernels = [{
        "name": "scale_bias_act",
        "route": "cuda",
        "source": "triplegan_tpu_torch/ops/csrc/scale_bias_act.cu",
        "replaces": "triplegan_tpu/ops/pallas_fused.py:59",
        "launches": sum(a["launches"] for a in arms),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_err": max(r["max_abs_err"] for r in rows),
        "ms": total["ms"],
        "kernel_ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "basis": "sum over the 13 epilogues of one classify and one generate batch of 100, float32",
    }]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"smi": smi, "kind": kind, "build_s": build_s, "kernel_rows": rows,
                       "serve": [{k: v for k, v in a.items() if not k.startswith("_")} for a in arms],
                       "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
