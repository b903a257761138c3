"""The campaign's plumbing: the port's CLI as subprocesses, the digits
recipe's per-seed stage commands, and what is read back from a train run.

``cli_cmd`` and ``run_cli`` run ``python -m triplegan_tpu_torch.cli`` from
this checkout, one stage at a time; ``stage_cmds`` gives a seed's prepare,
train and eval commands at the ``mnist100`` recipe on digits, as the JAX
package's ``tools/digits_experiment.py`` gives them, with two additions
that the port needs: ``--device`` (the port runs on the card unless told
otherwise) and ``--set scan_steps=K`` (K steps a CUDA graph replay; a
graphed chunk computes what K eager steps compute, bitwise, and K = 4
divides digits' 12 steps an epoch, so no chunk straddles an eval or a
checkpoint).
"""

from __future__ import annotations

import json
import os
import re
import shlex
import statistics
import subprocess
import sys
from typing import Dict, List, Optional

# the directory that holds the package: the subprocesses import this checkout
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLI_MODULE = "triplegan_tpu_torch.cli"
SCAN_STEPS = 4

ERROR_RE = re.compile(r"test error: ([0-9.]+)%")
# the loop's metrics line: "step N/M [X img/s] k=v ..."
METRICS_RE = re.compile(r"^step \d+/\d+ \[[0-9.]+ img/s\] (.+)$")
# cmd_train's last line, printed only when a run ends without a stop: the
# final test error, which `cli eval` of the last checkpoint reproduces
DONE_RE = re.compile(r"^done: step=\d+ .*test_error=([0-9.]+)%", re.M)
# datasets whose prepare needs no raw files ('synthetic' is never prepared)
PREPARE_RAW_FREE = ("digits", "shapes", "shapes16")


def cli_cmd(args: List[str]) -> List[str]:
    return [sys.executable, "-m", CLI_MODULE, *args]


def run_cli(args: List[str], log_path: Optional[str] = None,
            extra_env: Optional[Dict[str, str]] = None) -> str:
    """One CLI stage as a subprocess: its output appended to ``log_path``
    (returns ""), or captured, echoed and returned. ``extra_env`` overlays
    the environment (a variant with no config key, e.g.
    ``TRIPLEGAN_DROPOUT_BITS=8``). A non-zero exit raises
    ``CalledProcessError``."""
    cmd = cli_cmd(args)
    print("+ " + shlex.join(cmd)
          + (f"  [env {' '.join(f'{k}={v}' for k, v in extra_env.items())}]" if extra_env else ""),
          flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra_env or {})
    if log_path:
        with open(log_path, "a") as log:
            proc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, env=env)
        if proc.returncode != 0:
            print(f"stage failed (rc={proc.returncode}): see {log_path}", file=sys.stderr, flush=True)
            raise subprocess.CalledProcessError(proc.returncode, cmd)
        return ""
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        raise subprocess.CalledProcessError(proc.returncode, cmd, output=proc.stdout)
    return proc.stdout


def stage_cmds(seed: int, *, workdir: str, data_dir: str, num_labeled: int, epochs: int,
               warmup_epochs: int, eval_every_epochs: int, ckpt_every_epochs: int, device: str,
               scan_steps: int = SCAN_STEPS) -> Dict[str, List[str]]:
    """One seed's stages of the digits recipe: ``prepare`` (the packaged
    digits file to shards), ``train`` (``mnist100`` on digits, run
    ``digits_n<labels>_s<seed>``) and ``eval`` (its newest checkpoint)."""
    common = ["--workdir", workdir, "--data-dir", data_dir]
    overrides = [
        "--set", "dataset=digits",
        "--set", f"name=digits_n{num_labeled}_s{seed}",
        "--set", f"seed={seed}",
        "--set", f"num_labeled={num_labeled}",
    ]
    return {
        "prepare": ["prepare", "--dataset", "digits", "--data-dir", data_dir],
        "train": ["train", "--config", "mnist100", *common, *overrides,
                  "--set", f"epochs={epochs}",
                  "--set", f"alpha_p_warmup_epochs={warmup_epochs}",
                  "--set", f"eval_every_epochs={eval_every_epochs}",
                  "--set", f"ckpt_every_epochs={ckpt_every_epochs}",
                  "--set", f"scan_steps={scan_steps}",
                  "--device", device],
        "eval": ["eval", "--config", "mnist100", *common, *overrides, "--device", device],
    }


def parse_train_final_error(log_path: str) -> Optional[float]:
    """The final test error (percent) of a finished train log, else None."""
    try:
        with open(log_path) as f:
            m = DONE_RE.search(f.read())
    except OSError:
        return None
    return float(m.group(1)) if m else None


def train_completed(log_path: str) -> bool:
    """Whether a train log holds the ``done: step=`` line: only a run that
    ended without a stop or a crash prints it, so it marks a finished leg."""
    return parse_train_final_error(log_path) is not None


def parse_final_metrics(log_path: str) -> dict:
    """The last metrics line of a train log as {term: value}."""
    last = None
    try:
        with open(log_path) as f:
            for line in f:
                m = METRICS_RE.match(line.strip())
                if m:
                    last = m.group(1)
    except OSError:
        return {}
    out = {}
    for kv in (last or "").split():
        k, _, v = kv.partition("=")
        try:
            out[k] = float(v)
        except ValueError:
            pass
    return out


def run_timing(run_dir: str) -> dict:
    """The loop's pace from a run dir's ``metrics.jsonl``: ms/step of each
    logged window (batch / images_per_sec), their median, and the number
    of windows. A window that holds an eval, a checkpoint or the graph's
    capture is slower than the rest: the median is the steady pace."""
    path = os.path.join(run_dir, "metrics.jsonl")
    with open(os.path.join(run_dir, "config.json")) as f:
        batch = int(json.load(f)["batch_size"])
    try:
        with open(path) as f:
            recs = [json.loads(ln) for ln in f if ln.strip()]
    except OSError:
        return {}
    ms = [1e3 * batch / r["images_per_sec"] for r in recs if r.get("images_per_sec")]
    return {"ms_per_step_median": statistics.median(ms) if ms else None, "windows": len(ms)}


def device_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them
    (``--query-gpu=name,power.limit``), or torch's name where nvidia-smi
    is missing; "cpu" for the CPU."""
    if not device.startswith("cuda"):
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    import torch

    return torch.cuda.get_device_name(0)
