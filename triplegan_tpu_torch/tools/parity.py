"""The port's digits campaign against the JAX package's committed
populations of the same recipe, distributionally.

    python -m triplegan_tpu_torch.tools.parity --summary RUNS/digits_summary_n100.json \\
        [--key triplegan_errors_pct] [--metrics-key final_metrics] [--extra NAME=FILE:KEY] \\
        [--runs-dir RUNS] [--assets docs/assets] [--margin 2.0] [--out PATH]

The port's per-seed Triple-GAN errors (``--key``, default
``triplegan_errors_pct`` of a ``digits_experiment`` summary) against:

* ``jax_recipe``: ``digits_summary_n100.json``'s Triple-GAN errors (the
  JAX package's 10 seeds, f32, reference semantics);
* ``jax_sharefwd_off``: ``sharefwd_ab_digits_n100.json``'s
  ``off_errors_pct`` (the same recipe, another seed→stream mapping);
* ``jax_pool``: both, 20 runs: the headline;
* ``baseline``: the port's supervised arm against the JAX one, where the
  summary has one (the same labels, seed by seed);
* each ``--extra NAME=FILE:KEY``: the errors under KEY of another
  artifact (e.g. the JAX bfloat16 arm, ``bf16_ab_digits_n100.json``'s
  ``b_errors_pct``, for a ``flagset_ab`` summary's ``b_errors_pct``).

The random streams of the two packages are unrelated (torch generators,
JAX keys), so a seed number pairs nothing: each comparison is of two
independent samples, as the JAX package compared itself with TF
(``tools/tf_parity_train.py``, docs/PARITY.md §10): the difference of the
means, ``two_sample_perm_p``, the bootstrap 90% CI and TOST at ±``margin``
points (declared before the runs: 2.0, the measurement's resolution). The
verdict is AGREE when the 90% CI lies inside ±margin (TOST-equivalent)
and the permutation test does not reject equality (p ≥ 0.05); else
DISAGREE.

Beside the errors: the final loss_d, loss_g and c_sup of the port's runs
against those of the JAX runs (``bf16_ab_digits_n100.json``'s arm a, the
runs of ``digits_summary_n100.json``, and ``sharefwd_ab``'s off arm), and,
with ``--runs-dir``, the port's loss curves at a 600-step cadence (the mean
over its runs' ``metrics.jsonl``) beside the independent TF
implementation's (``tf_parity_summary_n100.json``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from triplegan_tpu_torch.tools import campaign, stats

ASSETS = os.path.join(campaign.ROOT, "docs", "assets")
CURVE_KEYS = ("loss_d", "loss_g", "loss_c", "c_sup")
FINAL_KEYS = ("loss_d", "loss_g", "c_sup")
CADENCE = 600


def compare(port, ref, margin: float) -> dict:
    """One comparison of two independent samples of errors (percent)."""
    p = stats.two_sample_perm_p(port, ref)
    eq = stats.equivalence_analysis(port, ref, margin_pct=margin)
    return {"n_port": len(port), "n_ref": len(ref), "port_mean_pct": round(float(np.mean(port)), 3),
            "ref_mean_pct": round(float(np.mean(ref)), 3), "ref_errors_pct": list(ref),
            "perm_test_p": round(p, 4), **eq,
            "verdict": "AGREE" if eq["tost_equivalent"] and p >= 0.05 else "DISAGREE"}


def ranges(metrics: list) -> dict:
    return {k: [min(m[k] for m in metrics), max(m[k] for m in metrics)]
            for k in FINAL_KEYS if metrics and all(k in m for m in metrics)}


def port_curves(runs_dir: str, names: list) -> list:
    """The mean over the runs of each CURVE_KEYS term at every CADENCE-th
    step that every run logged."""
    per_run = []
    for name in names:
        with open(os.path.join(runs_dir, name, "metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f if ln.strip()]
        per_run.append({r["step"]: r for r in recs if "loss_d" in r and r["step"] % CADENCE == 0})
    steps = sorted(set.intersection(*(set(r) for r in per_run))) if per_run else []
    return [{"step": s, **{k: round(float(np.mean([r[s][k] for r in per_run])), 4) for k in CURVE_KEYS}}
            for s in steps]


def tf_curves(tf: dict) -> list:
    seeds = list(tf["loss_curves"].values())
    steps = sorted(set.intersection(*({p["step"] for p in c} for c in seeds)))
    return [{"step": s, **{k: round(float(np.mean([p[k] for c in seeds for p in c if p["step"] == s])), 4)
                           for k in CURVE_KEYS}} for s in steps]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--summary", required=True, help="the port's campaign summary (digits_experiment's)")
    ap.add_argument("--key", default="triplegan_errors_pct", help="its per-seed errors (percent)")
    ap.add_argument("--metrics-key", default="final_metrics", help="its per-seed final losses")
    ap.add_argument("--extra", action="append", default=[], metavar="NAME=FILE:KEY",
                    help="one more comparison: the errors under KEY of FILE in --assets, e.g. "
                         "jax_bf16=bf16_ab_digits_n100.json:b_errors_pct")
    ap.add_argument("--runs-dir", default=None,
                    help="the summary's run dirs (digits_n<labels>_s<seed>): adds the loss curves")
    ap.add_argument("--assets", default=ASSETS, help="the JAX package's committed artifacts")
    ap.add_argument("--margin", type=float, default=2.0, help="TOST margin in points (declared: 2.0)")
    ap.add_argument("--out", default=None, help="default: torch_parity_digits_n<labels>.json beside --summary")
    args = ap.parse_args(argv)

    with open(args.summary) as f:
        port = json.load(f)

    def asset(name):
        with open(os.path.join(args.assets, name)) as f:
            return json.load(f)

    n = int(port.get("num_labeled", 100))
    recipe, share, bf16 = (asset(f"{k}_n{n}.json") for k in ("digits_summary", "sharefwd_ab_digits",
                                                                  "bf16_ab_digits"))
    mine = [float(e) for e in port[args.key]]
    comparisons = {
        "jax_recipe": compare(mine, recipe["triplegan_errors_pct"], args.margin),
        "jax_sharefwd_off": compare(mine, share["off_errors_pct"], args.margin),
        "jax_pool": compare(mine, recipe["triplegan_errors_pct"] + share["off_errors_pct"], args.margin),
    }
    for spec in args.extra:
        name, _, rest = spec.partition("=")
        fname, _, key = rest.rpartition(":")
        if not (name and fname and key):
            ap.error(f"--extra wants NAME=FILE:KEY, got {spec!r}")
        comparisons[name] = compare(mine, asset(fname)[key], args.margin)
    if "baseline_errors_pct" in port:
        comparisons["baseline"] = compare([float(e) for e in port["baseline_errors_pct"]],
                                          recipe["baseline_errors_pct"], args.margin)
    out = {
        "port_summary": os.path.basename(args.summary),
        "port_key": args.key,
        "port_errors_pct": mine,
        "port_mean_pct": round(float(np.mean(mine)), 3),
        "device": port.get("device"),
        "margin_pct": args.margin,
        "verdict_rule": "AGREE iff the bootstrap 90% CI of mean(port) - mean(ref) lies inside +-margin "
                        "(TOST) and the two-sample permutation p >= 0.05",
        "comparisons": comparisons,
        "verdict": comparisons["jax_pool"]["verdict"],
        "final_losses": {
            "port": ranges(port.get(args.metrics_key, [])),
            "jax_recipe": ranges(bf16.get("final_metrics_a", [])),
            "jax_sharefwd_off": ranges(share.get("final_metrics_off", [])),
        },
    }
    if args.runs_dir:
        names = [f"digits_n{n}_s{s}" for s in port["seeds"]]
        out["curves"] = {"cadence_steps": CADENCE, "port_mean": port_curves(args.runs_dir, names),
                         "tf_mean": tf_curves(asset(f"tf_parity_summary_n{n}.json"))}
    path = args.out or os.path.join(os.path.dirname(os.path.abspath(args.summary)),
                                    f"torch_parity_digits_n{n}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    for name, c in comparisons.items():
        print(f"{name}: port {c['port_mean_pct']:.2f}% (n={c['n_port']}) vs {c['ref_mean_pct']:.2f}% "
              f"(n={c['n_ref']}): diff {c['mean_diff_pct']:+.2f}, CI90 {c['diff_ci90_pct']}, "
              f"perm p={c['perm_test_p']:.3f} → {c['verdict']}")
    print(f"final losses: {json.dumps(out['final_losses'])}")
    print(f"summary → {path}\nverdict: {out['verdict']} (against the pool of "
          f"{comparisons['jax_pool']['n_ref']} JAX runs, margin ±{args.margin})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
