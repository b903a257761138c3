"""A/B of a declared set of config keys (and environment variables) on
real data, on the port: two arms per seed through the port's CLI, differing
ONLY in that set; the paired statistics decide WITHIN_NOISE or SIGNIFICANT.

    python -m triplegan_tpu_torch.tools.flagset_ab --data-dir DATA --workdir AB --name bf16 \\
        --b-set compute_dtype=bfloat16 [--a-set k=v] [--a-env K=V] [--b-env K=V] \\
        [--seeds 1,...,10] [--dataset digits] [--config mnist100] [--epochs 300] \\
        [--scan-steps 4] [--reuse-a 'RUNS/digits_n100_s{seed}'] [--resume] [--device cuda|cpu] [--dry-run]

The port of the JAX package's ``tools/flagset_ab.py``. Arm a (control) is
the shipped config unless ``--a-set``/``--a-env`` say otherwise; arm b
applies its set. Both share the seed, config, dataset, split and schedule;
the eval leg repeats its train leg's ``--set`` and environment. A seed's
error is read from its train log's ``done:`` line (the final state's
error, which ``cli eval`` reproduces), else from an eval leg.

``--reuse-a TEMPLATE`` takes arm a's runs from earlier run dirs (``{seed}``
in the template) instead of training them again: each must be a finished
run (its ``<run dir>_train.log`` holds the ``done:`` line) whose
``config.json`` equals what arm a would run in every model key (all but
the run's name, paths and execution keys). A run on the card is a fixed
function of its config and seed (cuDNN deterministic, the kernels sum in
a fixed order, a graphed chunk equals its eager steps bitwise), so such a
run is the run arm a would make.

Output: ``<workdir>/<name>_ab_<dataset>_n<labels>.json``: per-seed errors of
both arms, their means, the paired sign and exact permutation tests, each
arm's final losses, and the verdict: ``WITHIN_NOISE`` when the permutation
p ≥ 0.05, else ``SIGNIFICANT_<ARM>_WORSE``. Exit 0 either way.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import shutil
import sys

from triplegan_tpu_torch.cli import _device_arg
from triplegan_tpu_torch.tools import campaign, stats


def arm_config(config: str, sets: list):
    """The config an arm's train leg resolves: ``config`` with its
    ``--set`` overrides."""
    from triplegan_tpu_torch.cli import _apply_overrides
    from triplegan_tpu_torch.configs import get_config

    return _apply_overrides(get_config(config), sets)


def model_keys_differ(saved: dict, want: dict) -> list:
    """The model keys (not the run's name or paths, and not the execution
    keys: ``configs/base.py::EXEC_KEYS``) where a run's saved config.json
    and a resolved config differ, as dotted names."""
    from triplegan_tpu_torch.configs.base import EXEC_KEYS

    skip = set(EXEC_KEYS) | {"name"}
    want = json.loads(json.dumps(want, default=list))  # tuples as lists, as config.json holds them
    out = []
    for k in sorted(set(saved) | set(want)):
        if k in skip:
            continue
        a, b = saved.get(k), want.get(k)
        if isinstance(a, dict) and isinstance(b, dict):
            out += [f"{k}.{kk}" for kk in sorted(set(a) | set(b)) if a.get(kk) != b.get(kk)]
        elif a != b:
            out.append(k)
    return out


def run_ab(*, workdir: str, data_dir: str, config: str, dataset: str, num_labeled: int, seeds: list,
           epochs: int, warmup_epochs: int, arms: dict, device: str, scan_steps: int = campaign.SCAN_STEPS,
           eval_every_epochs: int = 0, ckpt_every_epochs: int = 0, overrides=None, run_prefix=None,
           artifact_path=None, summary_extra=None, reuse_a=None, resume: bool = False,
           dry_run: bool = False, runner=None) -> int:
    """The paired two-arm campaign. ``arms`` maps two arm names, control
    first, to {"sets": [k=v, ...], "env": {K: V}}; ``runner`` defaults to
    ``campaign.run_cli`` (a test passes its own); ``reuse_a`` is the run-dir
    template of ``--reuse-a``."""
    if len(arms) != 2:
        raise ValueError(f"exactly two arms required, got {list(arms)}")
    overrides = overrides or []
    runner = runner or campaign.run_cli
    a_name, b_name = list(arms)
    run_prefix = run_prefix or "ab"

    def stage_cmds(seed: int, arm: str) -> dict:
        name = f"{run_prefix}_{dataset}_n{num_labeled}_s{seed}_{arm}"
        common = ["--workdir", workdir, "--data-dir", data_dir]
        kvs = [f"dataset={dataset}", f"name={name}", f"seed={seed}", f"num_labeled={num_labeled}",
               *arms[arm].get("sets", []), *overrides]
        sets = [a for kv in kvs for a in ("--set", kv)]
        return {
            "train": ["train", "--config", config, *common, *sets,
                      "--set", f"epochs={epochs}",
                      "--set", f"alpha_p_warmup_epochs={warmup_epochs}",
                      "--set", f"eval_every_epochs={eval_every_epochs}",
                      "--set", f"ckpt_every_epochs={ckpt_every_epochs}",
                      "--set", f"scan_steps={scan_steps}",
                      "--device", device],
            "eval": ["eval", "--config", config, *common, *sets, "--device", device],
            "env": dict(arms[arm].get("env", {})),
            "log": os.path.join(workdir, f"{name}_train.log"),
            "eval_cache": os.path.join(workdir, f"{name}_eval.json"),
            "model_sets": kvs + [f"epochs={epochs}", f"alpha_p_warmup_epochs={warmup_epochs}"],
        }

    prepare_cmd = ["prepare", "--dataset", dataset, "--data-dir", data_dir]
    needs_prepare = dataset in campaign.PREPARE_RAW_FREE

    if dry_run:
        if needs_prepare:
            print(f"+ {shlex.join(campaign.cli_cmd(prepare_cmd))}")
        for seed in seeds:
            for arm in (a_name, b_name):
                cmds = stage_cmds(seed, arm)
                if arm == a_name and reuse_a:
                    print(f"# seed {seed}: arm {arm} reused from {reuse_a.format(seed=seed)}")
                    continue
                for leg in ("train", "eval"):
                    env = "".join(f"{k}={v} " for k, v in cmds["env"].items())
                    print(f"+ {env}{shlex.join(campaign.cli_cmd(cmds[leg]))}")
        return 0

    os.makedirs(workdir, exist_ok=True)
    if needs_prepare:
        runner(prepare_cmd)

    reused = {}
    if reuse_a:
        for seed in seeds:
            run_dir = reuse_a.format(seed=seed)
            src_log = f"{run_dir}_train.log"
            if arms[a_name].get("env"):
                raise SystemExit(f"--reuse-a: arm {a_name} sets environment variables, which a run dir "
                                 f"does not record")
            if not campaign.train_completed(src_log):
                raise SystemExit(f"--reuse-a: {src_log} holds no finished run")
            with open(os.path.join(run_dir, "config.json")) as f:
                saved = json.load(f)
            want = arm_config(config, stage_cmds(seed, a_name)["model_sets"])
            bad = model_keys_differ(saved, want)
            if bad:
                raise SystemExit(f"--reuse-a: {run_dir} differs from arm {a_name} in {bad}")
            shutil.copyfile(src_log, stage_cmds(seed, a_name)["log"])
            reused[seed] = run_dir

    errors = {a_name: [], b_name: []}
    final_metrics = {a_name: [], b_name: []}
    timing = {a_name: [], b_name: []}
    for seed in seeds:
        for arm in (a_name, b_name):
            cmds = stage_cmds(seed, arm)
            extra_env = cmds["env"] or None
            print(f"=== seed {seed}: arm {arm} ===", flush=True)
            name = f"{run_prefix}_{dataset}_n{num_labeled}_s{seed}_{arm}"
            run_dir = os.path.join(workdir, name)
            if arm == a_name and seed in reused:
                print(f"  reused: {reused[seed]}", flush=True)
                run_dir = reused[seed]
            elif resume and campaign.train_completed(cmds["log"]):
                print(f"  resume: {cmds['log']} already complete, skipping train", flush=True)
            else:
                runner(cmds["train"], log_path=cmds["log"], extra_env=extra_env)
            if resume and os.path.exists(cmds["eval_cache"]):
                with open(cmds["eval_cache"]) as f:
                    err_pct = json.load(f)["test_error_pct"]
                print(f"  resume: eval cached ({err_pct}%), skipping", flush=True)
            else:
                err_pct = campaign.parse_train_final_error(cmds["log"])
                if err_pct is not None:
                    print(f"  scored from train log final eval ({err_pct}%)", flush=True)
                else:
                    out = runner(cmds["eval"], extra_env=extra_env)
                    m = campaign.ERROR_RE.search(out)
                    if not m:
                        print(f"could not parse test error for seed {seed} arm {arm}", file=sys.stderr)
                        return 1
                    err_pct = float(m.group(1))
                with open(cmds["eval_cache"], "w") as f:
                    json.dump({"test_error_pct": err_pct}, f)
            errors[arm].append(err_pct / 100.0)
            final_metrics[arm].append(campaign.parse_final_metrics(cmds["log"]))
            if os.path.exists(os.path.join(run_dir, "config.json")):
                timing[arm].append({"seed": seed, **campaign.run_timing(run_dir)})

    a, b = errors[a_name], errors[b_name]
    a_mean, b_mean = sum(a) / len(a), sum(b) / len(b)
    diff = b_mean - a_mean  # > 0: the variant is worse
    perm_p = stats.paired_permutation_p(a, b)
    if perm_p >= 0.05:
        verdict = "WITHIN_NOISE"
    else:
        verdict = f"SIGNIFICANT_{(b_name if diff > 0 else a_name).upper()}_WORSE"
    summary = {
        **(summary_extra or {}),
        "arms": {n: {"sets": arms[n].get("sets", []), "env": arms[n].get("env", {})} for n in (a_name, b_name)},
        "dataset": dataset,
        "config": config,
        "num_labeled": num_labeled,
        "seeds": seeds,
        f"{a_name}_errors_pct": [round(100 * e, 2) for e in a],
        f"{b_name}_errors_pct": [round(100 * e, 2) for e in b],
        f"{a_name}_mean_pct": round(100 * a_mean, 2),
        f"{b_name}_mean_pct": round(100 * b_mean, 2),
        f"{b_name}_minus_{a_name}_pct": round(100 * diff, 2),
        f"seed_wins_{b_name}": f"{sum(1 for x, y in zip(a, b) if y < x)}/{len(seeds)}",
        "sign_test_p": round(stats.sign_test_p(a, b), 4),
        "perm_test_p": round(perm_p, 4),
        "epochs": epochs,
        f"final_metrics_{a_name}": final_metrics[a_name],
        f"final_metrics_{b_name}": final_metrics[b_name],
        "verdict": verdict,
        "implementation": "triplegan_tpu_torch",
        "device": campaign.device_line(device),
        "scan_steps": scan_steps,
        f"{a_name}_reused_from": {str(k): os.path.basename(v) for k, v in reused.items()},
        "timing": timing,
    }
    if artifact_path is None:
        artifact_path = os.path.join(workdir, f"{summary.get('name', 'flagset')}_ab_{dataset}_n{num_labeled}.json")
    with open(artifact_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if not k.startswith(("final_metrics", "timing"))},
                     indent=2))
    print(f"summary → {artifact_path}\nverdict: {verdict} ({b_name} {100 * b_mean:.2f}% vs {a_name} "
          f"{100 * a_mean:.2f}%, perm p={perm_p:.3f})")
    return 0


def _parse_env(items: list, flag: str) -> dict:
    out = {}
    for kv in items:
        k, sep, v = kv.partition("=")
        if not sep or not k:
            raise SystemExit(f"{flag} wants K=V, got {kv!r}")
        out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--name", default="flagset", help="experiment name: prefixes the run dirs and the artifact")
    ap.add_argument("--a-set", action="append", default=[], metavar="K=V", help="config override of arm a only")
    ap.add_argument("--b-set", action="append", default=[], metavar="K=V", help="config override of arm b only")
    ap.add_argument("--a-env", action="append", default=[], metavar="K=V", help="environment of arm a's legs")
    ap.add_argument("--b-env", action="append", default=[], metavar="K=V", help="environment of arm b's legs")
    ap.add_argument("--seeds", default="1,2,3,4,5,6,7,8,9,10")
    ap.add_argument("--dataset", default="digits")
    ap.add_argument("--config", default="mnist100")
    ap.add_argument("--num-labeled", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--warmup-epochs", type=int, default=100)
    ap.add_argument("--eval-every-epochs", type=int, default=0, help="0: the final eval only (the compared number)")
    ap.add_argument("--ckpt-every-epochs", type=int, default=0)
    ap.add_argument("--scan-steps", type=int, default=campaign.SCAN_STEPS,
                    help="train steps a CUDA graph replay (eager steps on the CPU)")
    ap.add_argument("--override", action="append", default=[], metavar="K=V",
                    help="extra --set k=v of BOTH arms' train and eval legs")
    ap.add_argument("--reuse-a", default=None, metavar="RUN_DIR_TEMPLATE",
                    help="arm a's runs from these run dirs ('{seed}' in the path), checked to hold the "
                         "same model config: e.g. RUNS/digits_n100_s{seed} of digits_experiment")
    ap.add_argument("--resume", action="store_true",
                    help="skip an arm's train leg whose log shows a finished run, reuse cached scores")
    ap.add_argument("--device", default="cuda", type=_device_arg, help="cuda (the default), cuda:N or cpu")
    ap.add_argument("--dry-run", action="store_true", help="print the stage commands, run nothing")
    args = ap.parse_args(argv)

    seeds = [int(s) for s in args.seeds.split(",") if s]
    if len(set(seeds)) != len(seeds):
        ap.error(f"duplicate seeds in --seeds {args.seeds!r}")
    if args.num_labeled % 10 != 0 or args.num_labeled <= 0:
        ap.error(f"--num-labeled must be a positive multiple of 10, got {args.num_labeled}")
    if not (args.a_set or args.b_set or args.a_env or args.b_env):
        ap.error("the arms are identical: declare at least one --a-set/--b-set/--a-env/--b-env difference")
    if args.reuse_a and "{seed}" not in args.reuse_a:
        ap.error(f"--reuse-a needs '{{seed}}' in its template, got {args.reuse_a!r}")

    arms = {"a": {"sets": args.a_set, "env": _parse_env(args.a_env, "--a-env")},
            "b": {"sets": args.b_set, "env": _parse_env(args.b_env, "--b-env")}}
    return run_ab(
        workdir=args.workdir, data_dir=args.data_dir, config=args.config, dataset=args.dataset,
        num_labeled=args.num_labeled, seeds=seeds, epochs=args.epochs, warmup_epochs=args.warmup_epochs,
        eval_every_epochs=args.eval_every_epochs, ckpt_every_epochs=args.ckpt_every_epochs, arms=arms,
        device=args.device, scan_steps=args.scan_steps, overrides=args.override,
        run_prefix=f"ab_{args.name}",
        artifact_path=os.path.join(args.workdir, f"{args.name}_ab_{args.dataset}_n{args.num_labeled}.json"),
        summary_extra={"name": args.name}, reuse_a=args.reuse_a, resume=args.resume, dry_run=args.dry_run)


if __name__ == "__main__":
    raise SystemExit(main())
