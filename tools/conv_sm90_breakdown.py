#!/usr/bin/env python3
"""Where the time of the PyTorch port's bfloat16 conv kernels
(``triplegan_tpu_torch/ops/csrc/conv3x3_sm90.cu``) goes, on one NVIDIA card.

    python3 tools/conv_sm90_breakdown.py [--out FILE]

Builds variants of the source with parts of the work removed and times the
raw launches (no weight packing or channel padding) at the widest convs of
cifar10_4k's bench train step (C's (384,32,32,128)->128 and
(384,16,16,256)->256, forward and filter gradient):

  full         the kernels as shipped;
  no_gather    the im2col copies (cp.async) read nothing and write zeros;
  no_products  no wgmma is issued;
  neither      both removed: what is left is each thread's address work,
               the issue of its copies, the TMA box of the other operand
               and the barriers.

Only ``full`` computes the conv (chip_smoke.py holds it to the plain
version); the others are for timing. Device time per call: CUDA events
around 30 back-to-back calls after 3 warm-up calls, in two turns (variants
in order, then reversed). Prints the card's name and power limit, then one
JSON line per (shape, op, variant).
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
_GATHER = [
    ("cp_async16(sa + swz(ar + kPass * i, ac), ok ? x + pix[i] + koff : x, ok);",
     "cp_async16(sa + swz(ar + kPass * i, ac), x, false);"),
    ("cp_async16(sa + a_off + swz(p, kc & 7), ok ? x + off : x, ok);",
     "cp_async16(sa + a_off + swz(p, kc & 7), x, false);"),
]
_PRODUCTS = [
    ("Wgmma<BN, 0, 0>::mma(", "if (s.n < 0) Wgmma<BN, 0, 0>::mma("),
    ("Wgmma<BN, 1, 1>::mma(", "if (s.n < 0) Wgmma<BN, 1, 1>::mma("),
]
VARIANTS = {"full": [], "no_gather": _GATHER, "no_products": _PRODUCTS,
            "neither": _GATHER + _PRODUCTS}
SHAPES = [(384, 32, 32, 128, 128, 1), (384, 16, 16, 256, 256, 1)]


def build_variant(name: str) -> str:
    from triplegan_tpu_torch.ops import build

    with open(build.source_path("conv3x3_sm90")) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"conv3x3_sm90.cu no longer contains {old!r}: update {__file__}")
        src = src.replace(old, new)
    out_dir = os.path.join(build.BUILD_DIR, "breakdown")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the rows as JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, REPO)
    from triplegan_tpu_torch.ops import conv3x3 as cv

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(build_variant, VARIANTS)))
    p, i = ctypes.c_void_p, ctypes.c_int
    calls = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        fwd, wgrad = lib.conv3x3_fwd_sm90_launch, lib.conv3x3_wgrad_sm90_launch
        fwd.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p]
        wgrad.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, i, ctypes.c_longlong, p]
        calls[name] = (fwd, wgrad)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for n, h, w, cin, cout, pad in SHAPES:
        x = torch.randn((n, h, w, cin), generator=gen, device=dev).bfloat16()
        wt = (torch.randn((3, 3, cin, cout), generator=gen, device=dev) / math.sqrt(9 * cin)).bfloat16()
        g = torch.randn((n, h, w, cout), generator=gen, device=dev).bfloat16()
        bn = cv.sm90_fwd_block_n(cout)
        wp = cv.pack_weight_sm90(wt, cin, bn)
        y = torch.empty((n, h, w, cout), device=dev, dtype=torch.bfloat16)
        wbn, splits, chunk = cv.sm90_wgrad_plan(n * h * w, cin, cout)
        out = torch.empty((3, 3, cin, cout), device=dev)
        ws = out if splits == 1 else torch.empty((splits, 9 * cin * cout), device=dev)
        flops = 2.0 * n * h * w * 9 * cin * cout
        times = {}
        for turn in (list(VARIANTS), list(reversed(VARIANTS))):
            for name in turn:
                fwd, wgrad = calls[name]
                run_f = lambda: fwd(x.data_ptr(), wp.data_ptr(), y.data_ptr(), n, h, w, cin, cout,  # noqa: E731
                                    pad, bn, wp.shape[0], wp.shape[1], stream)
                run_w = lambda: wgrad(x.data_ptr(), g.data_ptr(), ws.data_ptr(), out.data_ptr(),  # noqa: E731
                                      n, h, w, cin, cout, cin, cout, pad, wbn, splits, chunk, stream)
                for op, run in (("fwd", run_f), ("wgrad", run_w)):
                    if run() != 0:
                        raise SystemExit(f"{name} {op} launch failed")
                    times.setdefault((op, name), []).append(device_ms(run))
        for (op, name), ts in times.items():
            row = {"input": [n, h, w, cin], "cout": cout, "halo": pad, "op": op, "variant": name,
                   "ms_turns": ts, "ms": sum(ts) / len(ts), "tflop_s": flops / (sum(ts) / len(ts) * 1e9),
                   "mma_bound_ms": flops / 989e12 * 1e3}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"smi": smi, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
