"""One recipe over N seeds through the port's CLI → a JSON of the errors.

    python -m triplegan_tpu_torch.tools.seed_campaign --data-dir DATA --workdir RUNS \\
        [--config mnist100] [--dataset digits] [--seeds 1,2,3] [--num-labeled 100] \\
        [--epochs 300] [--warmup-epochs 100] [--override k=v] [--scan-steps 4] \\
        [--out PATH] [--resume] [--device cuda|cpu] [--dry-run]

The port of the JAX package's ``tools/seed_campaign.py``, with the same
output keys: per seed, ``cli train`` (no eval or checkpoint before the
end) and its final test error (from the train log's ``done:`` line, else
``cli eval``), then the errors' mean and std and each run's final losses.
Written to ``--out`` (default
``<workdir>/seed_campaign_<config>_<dataset>_n<labels>.json``). With
``--resume`` a finished train leg is skipped and a cached score reused.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import sys

import numpy as np

from triplegan_tpu_torch.cli import _device_arg
from triplegan_tpu_torch.tools import campaign


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--config", default="mnist100")
    ap.add_argument("--dataset", default="digits")
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--num-labeled", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--warmup-epochs", type=int, default=100)
    ap.add_argument("--override", action="append", default=[], metavar="K=V",
                    help="extra --set k=v of every train and eval leg")
    ap.add_argument("--scan-steps", type=int, default=campaign.SCAN_STEPS,
                    help="train steps a CUDA graph replay (eager steps on the CPU)")
    ap.add_argument("--device", default="cuda", type=_device_arg, help="cuda (the default), cuda:N or cpu")
    ap.add_argument("--out", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    seeds = [int(s) for s in args.seeds.split(",") if s]
    if len(set(seeds)) != len(seeds):
        ap.error(f"duplicate seeds in --seeds {args.seeds!r}")

    def stage_cmds(seed: int) -> dict:
        name = f"sc_{args.config}_{args.dataset}_n{args.num_labeled}_s{seed}"
        common = ["--workdir", args.workdir, "--data-dir", args.data_dir]
        kvs = [f"dataset={args.dataset}", f"name={name}", f"seed={seed}", f"num_labeled={args.num_labeled}",
               *args.override]
        sets = [a for kv in kvs for a in ("--set", kv)]
        return {
            "train": ["train", "--config", args.config, *common, *sets,
                      "--set", f"epochs={args.epochs}",
                      "--set", f"alpha_p_warmup_epochs={args.warmup_epochs}",
                      "--set", "eval_every_epochs=0",
                      "--set", "ckpt_every_epochs=0",
                      "--set", f"scan_steps={args.scan_steps}",
                      "--device", args.device],
            "eval": ["eval", "--config", args.config, *common, *sets, "--device", args.device],
            "log": os.path.join(args.workdir, f"{name}_train.log"),
            "eval_cache": os.path.join(args.workdir, f"{name}_eval.json"),
        }

    prepare_cmd = ["prepare", "--dataset", args.dataset, "--data-dir", args.data_dir]
    needs_prepare = args.dataset in campaign.PREPARE_RAW_FREE

    if args.dry_run:
        if needs_prepare:
            print(f"+ {shlex.join(campaign.cli_cmd(prepare_cmd))}")
        for seed in seeds:
            cmds = stage_cmds(seed)
            for leg in ("train", "eval"):
                print(f"+ {shlex.join(campaign.cli_cmd(cmds[leg]))}")
        return 0

    os.makedirs(args.workdir, exist_ok=True)
    if needs_prepare:
        campaign.run_cli(prepare_cmd)

    errors, metrics = [], []
    for seed in seeds:
        cmds = stage_cmds(seed)
        print(f"=== seed {seed} ===", flush=True)
        if args.resume and campaign.train_completed(cmds["log"]):
            print(f"  resume: {cmds['log']} already complete, skipping train", flush=True)
        else:
            campaign.run_cli(cmds["train"], log_path=cmds["log"])
        if args.resume and os.path.exists(cmds["eval_cache"]):
            with open(cmds["eval_cache"]) as f:
                err_pct = json.load(f)["test_error_pct"]
            print(f"  resume: eval cached ({err_pct}%), skipping", flush=True)
        else:
            err_pct = campaign.parse_train_final_error(cmds["log"])
            if err_pct is not None:
                print(f"  scored from train log final eval ({err_pct}%)", flush=True)
            else:
                m = campaign.ERROR_RE.search(campaign.run_cli(cmds["eval"]))
                if not m:
                    print(f"could not parse test error for seed {seed}", file=sys.stderr)
                    return 1
                err_pct = float(m.group(1))
            with open(cmds["eval_cache"], "w") as f:
                json.dump({"test_error_pct": err_pct}, f)
        errors.append(err_pct)
        metrics.append(campaign.parse_final_metrics(cmds["log"]))

    summary = {
        "implementation": "triplegan_tpu_torch",
        "recipe": f"{args.config}-on-{args.dataset}",
        "overrides": args.override,
        "num_labeled": args.num_labeled,
        "epochs": args.epochs,
        "warmup_epochs": args.warmup_epochs,
        "seeds": seeds,
        "errors_pct": [round(e, 2) for e in errors],
        "mean_pct": round(float(np.mean(errors)), 2),
        "std_pct": round(float(np.std(errors)), 2),
        "final_metrics": metrics,
    }
    out_path = args.out or os.path.join(
        args.workdir, f"seed_campaign_{args.config}_{args.dataset}_n{args.num_labeled}.json")
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    print(f"summary → {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
