"""Test helpers, imported first by every test module here (it puts the
benchmark's folder and the checkout on ``sys.path``), and a tiny checkout
for the benchmark's CPU tests: a BENCHMARK.json of small
cells whose configuration, traffic and limit files are new files beside
copies of the benchmark's own metric readers, as a later change would add
them."""

from __future__ import annotations

import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for _p in (REPO, BENCH):  # the benchmark's modules and the checkout's packages
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY = {
    "image_size": 12, "channels": 3, "num_classes": 10, "num_labeled": 40,
    "zca": True, "rescale": True, "aug_translate": 2, "aug_flip": True,
    "aug_order": "zca_first", "aug_pad_mode": "reflect", "z_dim": 16, "bn_momentum": 0.99,
    "gen": {"widths": [8, 4], "kernel": 5},
    "disc": {"widths": [4, 4, 6, 6], "strides": [1, 2, 1, 2], "input_noise": 0.05, "input_dropout": 0.2,
             "block_dropout": 0.2, "label_reconcat": True},
    "clf": {"conv_blocks": [[6, 6], [8]], "tail": [8, 6], "input_noise": 0.15, "block_dropout": 0.5},
    "alpha": 0.5, "alpha_p": 0.1, "alpha_p_warmup_epochs": 2, "alpha_p_ramp_epochs": 0,
    "non_saturating_g": True, "pseudo_label_mode": "sample", "share_pseudo_forward": False,
    "fused_clf_forward": False, "batch_size": 8, "epochs": 10, "lr_g": 3e-4, "lr_d": 3e-4, "lr_c": 3e-4,
    "adam_b1": 0.5, "adam_b2": 0.999, "adam_eps": 1e-8, "lr_decay_start_frac": 0.5,
    "lr_c_anneal_factor": 1.0, "lr_c_anneal_epochs": 0, "compute_dtype": "float32", "use_pallas": True,
}
# loose enough for sound tiny runs, far tighter than any fault reads
LIMITS = {"tiny.train": {"loss_d_step1": 1e-5, "loss": 1e-4, "adam_mu": 1e-3, "change": 1e-2, "flipped_disc": 1e-3}}


def write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def _bench() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def make_root(root: str) -> str:
    """A checkout holding a tiny train cell (graphed chunks of 2 steps,
    eager on the CPU)."""
    b = os.path.join(root, "benchmark")
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(b, "metrics"))
    write(os.path.join(b, "configs", "tiny.json"),
          {"name": "tiny", "registry": "cifar10_4k", "source": "test", "config": TINY,
           "data": {"n_train": 600, "n_labeled": 40}})
    write(os.path.join(b, "traffic", "tiny_train.json"),
          {"kind": "train", "scan_steps": 2, "trace_calls": 1, "host_calls": 1})
    for name, lim in LIMITS.items():
        write(os.path.join(b, "limits", f"{name}.json"), {"limits": lim})
    bench = _bench()
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json", "reduced": [],
                         "why": "tiny"}]
    bench["workloads"] = [{"name": "tiny.train", "config": "tiny", "traffic": "tiny_train", "chips": 1, "why": "tiny"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({w.replace("cifar10_4k", "tiny") for w in m["workloads"]})
    write(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def make_card_root(root: str) -> str:
    """A checkout for the card-only tests: cifar10_4k at its own widths
    with 2,000 training images, under its training mix and limits."""
    b = os.path.join(root, "benchmark")
    with open(os.path.join(BENCH, "configs", "cifar10_4k.json")) as f:
        conf = json.load(f)
    conf["data"] = {"n_train": 2000, "n_labeled": conf["data"]["n_labeled"]}
    write(os.path.join(b, "configs", "small.json"), conf)
    shutil.copytree(os.path.join(BENCH, "traffic"), os.path.join(b, "traffic"))
    os.makedirs(os.path.join(b, "limits"))
    shutil.copy(os.path.join(BENCH, "limits", "cifar10_4k.train.json"), os.path.join(b, "limits", "small.train.json"))
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(b, "metrics"))
    bench = _bench()
    bench["configs"] = [{"name": "small", "source": "test", "file": "benchmark/configs/small.json", "reduced": [],
                         "why": "test"}]
    bench["workloads"] = [{"name": "small.train", "config": "small", "traffic": "train", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    write(os.path.join(root, "BENCHMARK.json"), bench)
    return root
