"""Generative quality of trained digits runs, on the port.

    python -m triplegan_tpu_torch.tools.digits_quality --data-dir DATA --workdir RUNS \\
        --runs digits_n100_s1,...,digits_n100_s10 [--anchor digits_n100_s1] \\
        [--n-samples 500] [--seed 0] [--device cuda|cpu] [--out PATH]

The port of the JAX package's ``tools/digits_quality.py``, on the port's
own checkpoints (``ckpt/manager.py``), FID (``eval/fid.py``) and IS
(``eval/inception.py``). Per run, ``--n-samples`` class-conditional
samples of its Generator, scored in ONE feature space, the anchor run's
trained Classifier (its pooled features for FID, its logits for IS), so
that numbers compare across runs:

* FID against the real test set; IS of the samples;
* conditional fidelity: the share of samples G(z, y) that the anchor's
  Classifier labels y (cross-judged: the anchor's C never saw another
  run's G; the anchor's own row is marked self-judged);
* memorisation: each sample's pixel-space distance to its nearest
  neighbour in the train pool, against the test images' own.

References come with it: FID of a train-pool sample (the real-vs-real
floor) and of uniform noise (the ceiling); IS of the real test set
(shuffled first: the prepared test set is class-ordered, which would put
one class in each split) and of noise. z and y are drawn from a
``torch.Generator`` seeded ``--seed`` (the JAX tool's come from
``PRNGKey(seed)``: other numbers), the reference subsets from
``numpy.random.RandomState(seed)`` in the JAX tool's order.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from triplegan_tpu_torch.cli import _device_arg


def nn_distances(a, b, chunk: int = 128):
    """Per row of ``a``, the Euclidean distance of the flattened image to
    its nearest neighbour in ``b`` (float64, in chunks of ``a``'s rows)."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    b_sq = (b * b).sum(axis=1)
    out = np.empty(len(a), np.float64)
    for i in range(0, len(a), chunk):
        ai = a[i : i + chunk]
        d2 = (ai * ai).sum(axis=1)[:, None] - 2.0 * ai @ b.T + b_sq[None, :]
        out[i : i + chunk] = np.sqrt(np.clip(d2.min(axis=1), 0.0, None))
    return out


def load_run(cfg_name: str, run_dir: str, data_dir: str, workdir: str, device):
    """(cfg, networks, restored state) of a run dir: its config.json over
    ``cfg_name`` and its newest checkpoint, on ``device``."""
    from triplegan_tpu_torch.ckpt.manager import CheckpointManager
    from triplegan_tpu_torch.configs import get_config
    from triplegan_tpu_torch.configs.base import apply_runtime, make_networks, merge_saved
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state

    cfg = get_config(cfg_name)
    saved = os.path.join(run_dir, "config.json")
    if not os.path.exists(saved):
        raise SystemExit(f"no config.json under {run_dir}: not a run dir?")
    merge_saved(cfg, saved)
    cfg.data_dir, cfg.workdir, cfg.name = data_dir, workdir, os.path.basename(run_dir)
    apply_runtime(cfg)
    nets = make_networks(cfg)
    template = create_state(cfg, nets, make_optimizers(cfg, 1), device=device)
    restored = CheckpointManager(os.path.join(run_dir, "ckpt"), write=False).restore(template)
    if restored is None:
        raise SystemExit(f"no checkpoint under {run_dir}/ckpt")
    return cfg, nets, restored


def generate(cfg, gen, state, n: int, seed: int):
    """(samples in [-1, 1] as float32 numpy NHWC, their labels): z normal
    and y uniform over the classes from a CPU ``torch.Generator`` seeded
    ``seed``, G in eval mode in chunks of ``cfg.batch_size`` (the last
    padded with zeros)."""
    import torch

    dev = next(t for arrays in state.params["gen"].values() for t in arrays.values()).device
    g = torch.Generator().manual_seed(int(seed))
    z = torch.randn((n, cfg.z_dim), generator=g)
    y = torch.randint(0, cfg.num_classes, (n,), generator=g)
    b = max(int(cfg.batch_size), 1)
    out = []
    with torch.no_grad():
        for i in range(0, n, b):
            zi, yi = z[i : i + b], y[i : i + b]
            pad = b - len(zi)
            if pad:
                zi = torch.cat([zi, zi.new_zeros((pad, zi.shape[1]))])
                yi = torch.cat([yi, yi.new_zeros((pad,))])
            x, _ = gen.apply(state.params["gen"], state.bn["gen"], zi.to(dev), yi.to(dev), train=False)
            out.append(x[: b - pad].float().cpu().numpy())
    return np.concatenate(out), y.numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--workdir", required=True, help="the directory that holds the run dirs")
    ap.add_argument("--runs", required=True, help="comma-separated run names under --workdir")
    ap.add_argument("--config", default="mnist100", help="the config the runs were trained from")
    ap.add_argument("--anchor", default=None,
                    help="the run whose Classifier defines the shared feature and scoring space "
                         "(default: the first of --runs)")
    ap.add_argument("--n-samples", type=int, default=500,
                    help="generated samples a run (default: the size of the digits test set)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", type=_device_arg, help="cuda (the default), cuda:N or cpu")
    ap.add_argument("--out", default=None, help="summary JSON (default <workdir>/digits_quality.json)")
    args = ap.parse_args(argv)

    runs = [r for r in args.runs.split(",") if r]
    if len(set(runs)) != len(runs):
        ap.error(f"duplicate run names in --runs {args.runs!r}")
    anchor = args.anchor or runs[0]

    import torch

    from triplegan_tpu_torch.eval.fid import activation_stats, frechet_distance
    from triplegan_tpu_torch.eval.inception import inception_score
    from triplegan_tpu_torch.tools.campaign import device_line
    from triplegan_tpu_torch.train.loop import _resolve_data
    from triplegan_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(args.device)
    a_cfg, a_nets, a_state = load_run(args.config, os.path.join(args.workdir, anchor), args.data_dir,
                                      args.workdir, dev)
    if a_cfg.zca:
        raise SystemExit("digits_quality assumes a recipe without ZCA (the digits runs are mnist100's); "
                         "got cfg.zca=True")
    clf = a_nets[2]

    def judge(x):
        with torch.no_grad():
            (logits, feats), _ = clf.apply(a_state.params["clf"], a_state.bn["clf"],
                                           torch.as_tensor(x).to(dev), train=False, return_features=True)
        return logits, feats

    def logits_fn(x):
        return judge(x)[0]

    def features_fn(x):
        return judge(x)[1]

    batch = max(int(a_cfg.batch_size), 1)
    data = _resolve_data(a_cfg)
    rescale = bool(a_cfg.get("rescale", True))

    def to_gen_space(u8):
        x = np.asarray(u8, np.float32)
        return x / 127.5 - 1.0 if rescale else x

    rng = np.random.RandomState(args.seed)
    x_test = to_gen_space(data.x_test)
    pool = to_gen_space(data.x_unlabel)
    n = args.n_samples
    pool_sample = pool[rng.choice(len(pool), min(n, len(pool)), replace=False)]
    noise = rng.uniform(-1.0, 1.0, size=(n,) + x_test.shape[1:]).astype(np.float32)
    mu_t, cov_t = activation_stats(features_fn, x_test, batch)

    def fid_vs_test(images):
        mu, cov = activation_stats(features_fn, images, batch)
        return frechet_distance(mu, cov, mu_t, cov_t)

    x_test_shuf = x_test[rng.permutation(len(x_test))]
    refs = {
        "fid_floor_trainpool_vs_test": round(fid_vs_test(pool_sample), 3),
        "fid_ceiling_noise_vs_test": round(fid_vs_test(noise), 3),
        "is_real_test": [round(v, 3) for v in inception_score(logits_fn, x_test_shuf, batch_size=batch)],
        "is_noise": [round(v, 3) for v in inception_score(logits_fn, noise, batch_size=batch)],
        "nn_test_to_trainpool_mean": round(float(nn_distances(x_test, pool).mean()), 3),
    }
    print(f"references: {json.dumps(refs)}", flush=True)

    per_run = []
    for name in runs:
        cfg, nets, state = ((a_cfg, a_nets, a_state) if name == anchor else
                            load_run(args.config, os.path.join(args.workdir, name), args.data_dir,
                                     args.workdir, dev))
        samples, y = generate(cfg, nets[0], state, n, args.seed)
        logits = np.concatenate([logits_fn(samples[i : i + batch]).float().cpu().numpy()
                                 for i in range(0, len(samples), batch)])
        row = {
            "run": name,
            "fid_vs_test": round(fid_vs_test(samples), 3),
            "is_gen": [round(v, 3) for v in inception_score(logits_fn, samples, batch_size=batch)],
            "cond_fidelity_anchor": round(float((logits.argmax(-1) == y).mean()), 4),
            "nn_gen_to_trainpool_mean": round(float(nn_distances(samples, pool).mean()), 3),
        }
        if name == anchor:
            row["is_anchor_self_judged"] = True
        per_run.append(row)
        print(json.dumps(row), flush=True)

    fids = [r["fid_vs_test"] for r in per_run]
    cross = [r for r in per_run if r["run"] != anchor] or per_run
    summary = {
        "dataset": "digits",
        "judge": f"{anchor} classifier (GAP features / logits)",
        "n_samples": n,
        "seed": args.seed,
        "references": refs,
        "runs": per_run,
        "fid_mean": round(float(np.mean(fids)), 3),
        "fid_min": round(float(np.min(fids)), 3),
        "fid_max": round(float(np.max(fids)), 3),
        "fidelity_mean": round(float(np.mean([r["cond_fidelity_anchor"] for r in per_run])), 4),
        "nn_gen_mean": round(float(np.mean([r["nn_gen_to_trainpool_mean"] for r in per_run])), 3),
        "cross_judged": {
            "n_runs": len(cross),
            "fid_mean": round(float(np.mean([r["fid_vs_test"] for r in cross])), 3),
            "is_mean": round(float(np.mean([r["is_gen"][0] for r in cross])), 3),
            "fidelity_mean": round(float(np.mean([r["cond_fidelity_anchor"] for r in cross])), 4),
        },
        "implementation": "triplegan_tpu_torch",
        "device": device_line(str(dev)),
    }
    out = args.out or os.path.join(args.workdir, "digits_quality.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}, indent=2))
    print(f"summary → {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
