"""Run one cell of the benchmark once, on the card, and print its result as
the last line of standard output.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, from a run that adds a traced window after the measured
one. Every run ends with the output check: the numbers it compared, each
beside its limit, as the last lines of standard error and under "checks"
in the result. A run exits non-zero, printing no result, without a CUDA
card, when a module of JAX or of the JAX package has been loaded, or when
anything fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_cache")


def paths() -> None:
    """The benchmark's modules and the checkout's packages importable."""
    for p in (ROOT, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)


def run_cell(root: str, workload: str, seed: int, seconds: float, traced: bool, device: str,
             age0: float = 0.0, t_entry: float = None):
    """One run of ``workload``: (result line, check lines). ``age0`` is the
    process's age at ``t_entry`` (``time.perf_counter``)."""
    import harness

    t_entry = time.perf_counter() if t_entry is None else t_entry
    cell = harness.load_cell(root, workload)
    started = {}

    def window_started(t):
        started["t"] = t

    out = harness.kind_module(cell).run(cell, seed, seconds, traced, device, window_started)
    out.values["setup_s"] = age0 + started["t"] - t_entry
    line = harness.result_line(cell, out, traced)
    checks = [f"check {n}: {v!r} (limit {lim!r})" for n, v, lim in out.checks]
    return line, checks, out


def main(argv=None) -> int:
    t_entry = time.perf_counter()
    paths()
    import harness

    age0 = harness.process_age_s()
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()

    import torch

    cell = harness.load_cell(ROOT, args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from triplegan_tpu_torch.utils.cache import enable_build_cache

    enable_build_cache(os.path.join(CACHE, "build"))
    line, checks, out = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                                 age0, t_entry)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"notes": out.notes, "power_limit": _power_limit()}, default=str), flush=True)
    for c in checks:
        print(c, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread: {e}"


if __name__ == "__main__":
    sys.exit(main())
