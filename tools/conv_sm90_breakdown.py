#!/usr/bin/env python3
"""Where the time of the PyTorch port's conv kernels goes, on one NVIDIA
card: the bfloat16 kernels (``triplegan_tpu_torch/ops/csrc/conv3x3_sm90.cu``)
and the float32 ones (``conv3x3.cu``).

    python3 tools/conv_sm90_breakdown.py [--source conv3x3_sm90|conv3x3|all] [--out FILE]

Builds variants of each source with parts of the work removed and times
the raw launches (no weight packing or channel padding; the float32
kernels with the wrapper's plans) at the widest convs of cifar10_4k's train
steps, forward and filter gradient: for the bfloat16 source at the bench
step's C (384,32,32,128)->128 and (384,16,16,256)->256, for the float32
source at the shipped step's C (100,32,32,128)->128 and (100,16,16,256)->256.

  full         the kernels as shipped;
  no_gather    (bfloat16) the im2col copies (cp.async) read nothing and
               write zeros;
  no_copies    (float32) every global->shared copy (cp.async, both
               operands, and the forward's register-staged reads of x)
               reads nothing and writes zeros;
  no_products  no wgmma is issued (bfloat16), no FMA tile is computed
               (float32);
  neither      both removed: what is left is each thread's address work,
               the issue of its copies, the barriers and (bfloat16) the TMA
               box of the other operand, (float32) the split's sum.
  sgemm        (float32, a yardstick only) cuBLAS's float32 matrix product
               of the same size, M x K by K x N with TF32 off: what a
               library GEMM on the CUDA cores reaches on this card.

For ``full`` and ``sgemm`` it also runs each call back to back for about
two seconds and reports the median SM clock and power draw that
nvidia-smi reads meanwhile (``clock_mhz``, ``power_w``), since a float32
FMA loop can meet the card's power limit before its peak rate.

Only ``full`` computes the conv (chip_smoke.py holds it to the plain
version); the others are for timing. Device time per call: CUDA events
around 30 back-to-back calls after 3 warm-up calls, in two turns (variants
in order, then reversed). Prints the card's name and power limit, then one
JSON line per (source, shape, op, variant).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (text in the source, its replacement) per removed part
_SM90_GATHER = [
    ("cp_async16(sa + swz(ar + kPass * i, ac), ok ? x + pix[i] + koff : x, ok);",
     "cp_async16(sa + swz(ar + kPass * i, ac), x, false);"),
    ("cp_async16(sa + a_off + swz(p, kc & 7), ok ? x + off : x, ok);",
     "cp_async16(sa + a_off + swz(p, kc & 7), x, false);"),
]
_SM90_PRODUCTS = [
    ("Wgmma<BN, 0, 0>::mma(", "if (s.n < 0) Wgmma<BN, 0, 0>::mma("),
    ("Wgmma<BN, 1, 1>::mma(", "if (s.n < 0) Wgmma<BN, 1, 1>::mma("),
]
_F32_COPIES = [
    ('"r"(valid ? 16 : 0)', '"r"(0)'),
    ('"r"(valid ? 4 : 0)', '"r"(0)'),
    ("const float4 f = ok ? __ldg(", "const float4 f = false ? __ldg("),  # the register-staged reads
]
_F32_PRODUCTS = [
    ("tile_products<BM, BN, TM, TN, kAS>(sa,", "if (s.n < 0) tile_products<BM, BN, TM, TN, kAS>(sa,"),
    ("m_major_products<BM, BN, TM, TN>(sa,", "if (s.n < 0) m_major_products<BM, BN, TM, TN>(sa,"),
    ("tile_products<BM, BN, TM, TN, BM>(sa,", "if (s.n < 0) tile_products<BM, BN, TM, TN, BM>(sa,"),
]
SOURCES = {
    "conv3x3_sm90": {
        "dtype": "bfloat16", "peak": 989e12,
        "variants": {"full": [], "no_gather": _SM90_GATHER, "no_products": _SM90_PRODUCTS,
                     "neither": _SM90_GATHER + _SM90_PRODUCTS},
        "shapes": [(384, 32, 32, 128, 128, 1), (384, 16, 16, 256, 256, 1)],
    },
    "conv3x3": {
        "dtype": "float32", "peak": 67e12,
        "variants": {"full": [], "no_copies": _F32_COPIES, "no_products": _F32_PRODUCTS,
                     "neither": _F32_COPIES + _F32_PRODUCTS},
        "shapes": [(100, 32, 32, 128, 128, 1), (100, 16, 16, 256, 256, 1)],
    },
}


def build_variant(source: str, name: str) -> str:
    from triplegan_tpu_torch.ops import build

    with open(build.source_path(source)) as f:
        src = f.read()
    for old, new in SOURCES[source]["variants"][name]:
        if old not in src:
            raise SystemExit(f"{source}.cu no longer contains {old!r}: update {__file__}")
        src = src.replace(old, new)
    out_dir = os.path.join(build.build_dir(), "breakdown")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{source}-{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{source}-{name}.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {source} {name}:\n{proc.stderr[-4000:]}")
    return lib


def device_ms(fn, reps=30, warm=3) -> float:
    import torch

    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sustained(fn, seconds=2.0) -> dict:
    """Median SM clock (MHz) and power draw (W) over ``seconds`` of ``fn``
    called back to back, sampled by nvidia-smi every 0.2 s."""
    import threading
    import time

    import torch

    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                  "--format=csv,noheader,nounits"], capture_output=True, text=True)
            samples.append([float(v) for v in out.stdout.split(",")])
            time.sleep(0.2)

    fn()
    torch.cuda.synchronize()
    thread = threading.Thread(target=sample)
    thread.start()
    t0 = time.time()
    while time.time() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    stop.set()
    thread.join()
    late = sorted(samples[len(samples) // 2:])  # once the clock has settled
    return {"clock_mhz": late[len(late) // 2][0], "power_w": sorted(p for _, p in late)[len(late) // 2]}


def bind(source: str, path: str):
    """(forward, wgrad) C entry points of a built variant, argtypes set."""
    lib = ctypes.CDLL(path)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if source == "conv3x3_sm90":
        fwd, wgrad = lib.conv3x3_fwd_sm90_launch, lib.conv3x3_wgrad_sm90_launch
        fwd.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p]
        wgrad.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, i, ll, p]
    else:
        fwd, wgrad = lib.conv3x3_fwd_launch, lib.conv3x3_wgrad_launch
        fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        wgrad.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, ll, p]
    return fwd, wgrad


def launches(source, fwd, wgrad, n, h, w, cin, cout, pad, gen, stream):
    """Raw (forward, wgrad) launch closures on seeded inputs of one shape,
    with every operand, plan and workspace the kernels take made ahead
    (returned too, to keep them alive)."""
    import torch

    from triplegan_tpu_torch.ops import conv3x3 as cv

    dev = torch.device("cuda")
    dt = getattr(torch, SOURCES[source]["dtype"])
    x = torch.randn((n, h, w, cin), generator=gen, device=dev).to(dt)
    wt = (torch.randn((3, 3, cin, cout), generator=gen, device=dev) / math.sqrt(9 * cin)).to(dt)
    ho, wo = h + 2 * pad - 2, w + 2 * pad - 2
    g = torch.randn((n, ho, wo, cout), generator=gen, device=dev).to(dt)
    y = torch.empty((n, ho, wo, cout), device=dev, dtype=dt)
    out = torch.empty((3, 3, cin, cout), device=dev)
    m = n * ho * wo
    keep = [x, wt, g, y, out]
    if source == "conv3x3_sm90":
        bn = cv.fwd_block_n(cout)
        wp = cv.pack_weight_sm90(wt, cin, bn)
        wbn, splits, chunk = cv.sm90_wgrad_plan(m, cin, cout)
        ws = out if splits == 1 else torch.empty((splits, 9 * cin * cout), device=dev)
        keep += [wp, ws]
        run_f = lambda: fwd(x.data_ptr(), wp.data_ptr(), y.data_ptr(), n, h, w, cin, cout,  # noqa: E731
                            pad, bn, wp.shape[0], wp.shape[1], stream)
        run_w = lambda: wgrad(x.data_ptr(), g.data_ptr(), ws.data_ptr(), out.data_ptr(),  # noqa: E731
                              n, h, w, cin, cout, cin, cout, pad, wbn, splits, chunk, stream)
    else:
        bn, full, per, ws_len = cv.f32_fwd_plan(m, cin, cout)
        fws = torch.empty(max(1, ws_len), device=dev)
        wbm, wbn, splits, chunk = cv.f32_wgrad_plan(m, cin, cout)
        ws = out if splits == 1 else torch.empty((splits, 9 * cin * cout), device=dev)
        keep += [fws, ws]
        run_f = lambda: fwd(x.data_ptr(), wt.data_ptr(), y.data_ptr(), fws.data_ptr(), n, h, w,  # noqa: E731
                            cin, cout, pad, bn, full, per, stream)
        run_w = lambda: wgrad(x.data_ptr(), g.data_ptr(), ws.data_ptr(), out.data_ptr(),  # noqa: E731
                              n, h, w, cin, cout, pad, wbm, wbn, splits, chunk, stream)
    return run_f, run_w, keep


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default="all", choices=[*SOURCES, "all"],
                    help="which kernel source to take apart")
    ap.add_argument("--out", default=None, help="also write the rows as JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, REPO)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    sources = list(SOURCES) if args.source == "all" else [args.source]
    jobs = [(src, name) for src in sources for name in SOURCES[src]["variants"]]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(zip(jobs, ex.map(lambda job: build_variant(*job), jobs)))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for src in sources:
        spec = SOURCES[src]
        calls = {name: bind(src, libs[src, name]) for name in spec["variants"]}
        for n, h, w, cin, cout, pad in spec["shapes"]:
            runs = {name: launches(src, *calls[name], n, h, w, cin, cout, pad, gen, stream)
                    for name in spec["variants"]}
            flops = 2.0 * n * (h + 2 * pad - 2) * (w + 2 * pad - 2) * 9 * cin * cout
            times = {}
            for turn in (list(spec["variants"]), list(reversed(spec["variants"]))):
                for name in turn:
                    run_f, run_w, _ = runs[name]
                    for op, run in (("fwd", run_f), ("wgrad", run_w)):
                        if run() != 0:
                            raise SystemExit(f"{src} {name} {op} launch failed")
                        times.setdefault((op, name), []).append(device_ms(run))
            power = {}
            if src == "conv3x3":
                a = torch.randn((n * (h + 2 * pad - 2) * (w + 2 * pad - 2), 9 * cin), generator=gen, device=dev)
                b = torch.randn((9 * cin, cout), generator=gen, device=dev)
                torch.backends.cuda.matmul.allow_tf32 = False
                sgemm = lambda: torch.mm(a, b)  # noqa: E731
                times["sgemm", "sgemm"] = [device_ms(sgemm)]
                power["sgemm", "sgemm"] = sustained(sgemm)
                for op, run in zip(("fwd", "wgrad"), runs["full"][:2]):
                    power[op, "full"] = sustained(run)
            for (op, name), ts in times.items():
                ms = sum(ts) / len(ts)
                row = {"source": src, "dtype": spec["dtype"], "input": [n, h, w, cin], "cout": cout,
                       "halo": pad, "op": op, "variant": name, "ms_turns": ts, "ms": ms,
                       "tflop_s": flops / (ms * 1e9), "ops_bound_ms": flops / spec["peak"] * 1e3,
                       **power.get((op, name), {})}
                rows.append(row)
                print(json.dumps(row), flush=True)
            del runs
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"smi": smi, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
