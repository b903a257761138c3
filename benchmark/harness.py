"""One run of one cell: find its configuration, traffic mix, limits and
per-layer readers by name, run its kind's generator, and print the result.

Everything that belongs to one cell lives in files the harness finds by
the names in ``BENCHMARK.json``:

* ``configs/<config>.json`` (the ``file`` of the configuration entry): the
  sizes as run, overlaid on the program's registry entry of that name;
* ``traffic/<traffic>.json``: the mix, whose ``kind`` names the generator
  (``kinds/<kind>.py``) that reads it;
* ``limits/<workload>.json``: the limit of each number the output check
  compares;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``,
  returning a number or None (nothing to read), with any data files under
  ``metrics/<metric>/``.

So a cell, a configuration, a mix, a metric or a kernel-name pattern is
added by adding files and entries, never by editing one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
NOT_LOADED = ("jax", "jaxlib", "flax", "triplegan_tpu")


@dataclasses.dataclass
class Cell:
    root: str                 # the checkout: BENCHMARK.json and the benchmark's folder
    name: str
    workload: dict
    config: dict              # the configuration file
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]    # BENCHMARK.json entries this cell reports
    per_layer: List[dict]

    @property
    def sizes(self) -> dict:
        """The configuration as this cell runs it: the file's sizes with
        the traffic's ``set`` over them."""
        return {**self.config["config"], **self.traffic.get("set", {})}

    def folder(self, *parts) -> str:
        return os.path.join(self.root, "benchmark", *parts)


def load_bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _in(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root: str, name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_bench(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    wl = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", f"{wl['traffic']}.json")) as f:
        traffic = json.load(f)
    limits_path = os.path.join(root, "benchmark", "limits", f"{name}.json")
    with open(limits_path) as f:
        limits = {k: float(v) for k, v in json.load(f)["limits"].items()}
    e2e = [m for m in bench["end_to_end"] if _in(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(root, name, wl, config, traffic, limits, e2e, per_layer)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def kind_module(cell: Cell):
    kind = cell.traffic["kind"]
    return load_module(os.path.join(HERE, "kinds", f"{kind}.py"), f"benchmark_kind_{kind}")


def reader(cell: Cell, metric: str) -> Callable[[dict], Optional[float]]:
    path = cell.folder("metrics", f"{metric}.py")
    return load_module(path, "benchmark_metric_" + metric.replace(".", "_").replace("-", "_")).read


def loaded_forbidden() -> List[str]:
    """Modules whose whole top-level name is one the run may not load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in NOT_LOADED})


@dataclasses.dataclass
class Outcome:
    """What a kind's generator hands back: end-to-end values, the context
    the per-layer readers read, and the output check."""
    values: Dict[str, float]
    ctx: dict
    attempted: int
    failed: int
    checks: List[tuple]       # (name, value, limit)
    memory_peak_bytes: int
    device_kind: str
    device_count: int
    trace: object = None      # trace.Trace of the traced window, or None
    notes: dict = dataclasses.field(default_factory=dict)


def result_line(cell: Cell, out: Outcome, traced: bool) -> dict:
    """The run's last line. With ``traced`` the metrics are the cell's
    per-layer metrics, else its end-to-end ones."""
    metrics = {}
    if traced:
        ctx = dict(out.ctx, trace=out.trace, cell=cell, device_kind=out.device_kind)
        for m in cell.per_layer:
            v = reader(cell, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] not in out.values:
                raise RuntimeError(f"{cell.name}: the generator gave no value of {m['name']}")
            metrics[m["name"]] = {"value": float(out.values[m["name"]]), "unit": m["unit"]}
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in out.checks) and out.failed == 0
    device = {"platform": "gpu", "kind": out.device_kind, "count": out.device_count,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": bool(correct), "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device}
    if traced and out.trace is not None:
        device["busy_s"] = out.trace.busy_s()
        device["window_s"] = out.trace.window_s
        line["breakdown"] = {"device_ops": out.trace.device_ops(), "idle_gaps": out.trace.idle_gaps()}
    line["checks"] = {name: {"value": float(v), "limit": float(lim)} for name, v, lim in out.checks}
    return line


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def peaks(device_kind: str) -> dict:
    """The published peaks of the card named ``device_kind``."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)
    for key, entry in table.items():
        if key != "about" and key in device_kind:
            return entry
    raise KeyError(f"no peaks for {device_kind!r} in peaks.json")
