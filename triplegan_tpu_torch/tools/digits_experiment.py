"""Real-data semi-supervised validation on the digits set, on the port.

    python -m triplegan_tpu_torch.tools.digits_experiment --data-dir DATA --workdir RUNS \\
        [--seeds 1,2,3] [--epochs 300] [--num-labeled 100] [--baseline-steps 3000] \\
        [--scan-steps 4] [--device cuda|cpu] [--dry-run]

The port of the JAX package's ``tools/digits_experiment.py``. The data is
the 1,797 real 8×8 handwritten digits that ship with the port
(``data/prepare.py::prepare_digits``: 1,297 train, 500 test, upsampled to
28×28). Per seed, TWO arms on the SAME class-balanced ``--num-labeled``
subset (``semi_split`` is seeded by the seed alone, so both arms, and the
JAX package's arms of the same seed, see the same labels):

  A. **supervised baseline**: the ``mnist100`` Classifier (its input
     rescale, input noise and dropout) trained in this process with Adam on
     the labelled images alone, full batch (``supervised_baseline``);
  B. **Triple-GAN**: ``cli train`` and ``cli eval`` as subprocesses, at the
     ``mnist100`` recipe verbatim, which also use the unlabelled pool.

It writes ``<workdir>/digits_summary_n<labels>.json``: the JAX tool's keys
(per-seed errors of both arms, their means, the paired sign and exact
permutation tests, the verdict: PASS when the Triple-GAN mean error is
below the supervised one, exit 0; else FAIL, exit 2), and the port's own:
the card, each seed's final losses, and its seconds (train, eval,
baseline) and graphed ms/step.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import sys
import time

from triplegan_tpu_torch.cli import _device_arg
from triplegan_tpu_torch.tools import campaign, stats


def _noise_seed(seed: int, step: int) -> int:
    """The seed of a supervised step's noise and dropout generator."""
    return (int(seed) * 1_000_003 + int(step)) % (1 << 63)


class SupervisedBaseline:
    """The Classifier of ``cfg`` trained on (x, y) alone with Adam at a
    constant ``lr`` (``cfg``'s β1, β2, ε), the whole labelled set one batch;
    the loss is the mean softmax cross-entropy. ``x`` is uint8 NHWC,
    rescaled to [-1, 1] on the host as the JAX tool rescales it. The
    weights come from ``clf.init`` on ``torch.Generator().manual_seed(
    cfg.seed)`` unless ``params`` and ``bn`` are given. Step t's input noise
    and dropout draw from a generator on the device seeded
    ``_noise_seed(noise_seed, t)``; with ``noise_seed`` None there is no
    noise and no dropout.

    The step is a ``TrainStep`` (``train_step``) on a ``TrainState``
    (``state``: the Classifier's weights, BN statistics and Adam moments
    under "clf", its metric the loss), and ``step`` runs it as a one-step
    ``ScanChunk`` (``chunk``): on the card a CUDA graph, captured at the
    first step and replayed at each, on the CPU the eager step.

    Eval (``error``) runs in chunks of ``cfg.batch_size`` with the running
    BN statistics, as ``make_eval_step`` does."""

    def __init__(self, cfg, x, y, device, lr: float = 3e-4, params=None, bn=None, noise_seed=None):
        import numpy as np
        import torch

        from triplegan_tpu_torch.configs.base import apply_runtime, make_networks
        from triplegan_tpu_torch.train.schedule import Adam
        from triplegan_tpu_torch.train.state import TrainState
        from triplegan_tpu_torch.train.step import ScanChunk, TrainStep
        from triplegan_tpu_torch.utils.platform import resolve_device

        self.cfg, self.dev = cfg, resolve_device(device)
        apply_runtime(cfg)
        _, _, self.clf = make_networks(cfg)
        if params is None:
            params, bn = self.clf.init(torch.Generator().manual_seed(int(cfg.seed)))

        def move(tree):
            return {layer: {k: torch.as_tensor(t).to(self.dev, torch.float32).clone() for k, t in arrays.items()}
                    for layer, arrays in tree.items()}

        params = move(params)
        self.adam = Adam(lr=lambda count: lr, b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps)
        self.state = TrainState(params={"clf": params}, bn={"clf": move(bn)}, opt={"clf": self.adam.init(params)},
                                step=0, seed=0 if noise_seed is None else int(noise_seed))
        self.data = {"x": self._rescale(x),
                     "y": torch.as_tensor(np.asarray(y), dtype=torch.long, device=self.dev)}
        self.train_step = TrainStep(self._body, lambda step, counts, reg: list(self.adam.scalars(counts["clf"])),
                                    () if noise_seed is None else (0,), metrics=("loss",))
        self.train_step.seed_of = lambda seed, step, domain: _noise_seed(seed, step)
        self.chunk = ScanChunk(self.train_step, 1, log=lambda *a, **kw: None)

    @property
    def params(self):
        return self.state.params["clf"]

    @property
    def bn(self):
        return self.state.bn["clf"]

    def _rescale(self, images):
        import numpy as np
        import torch

        return torch.from_numpy(np.asarray(images).astype(np.float32) / 127.5 - 1.0).to(self.dev)

    def loss_and_grads(self, generator=None, params=None, bn=None, data=None):
        """(loss, gradients as a params-shaped tree, new BN statistics) at
        ``params`` and ``bn`` (default the current state) on ``data``
        (default the labelled set), the noise and dropout drawn from
        ``generator``."""
        import torch
        import torch.nn.functional as F

        params = {layer: {k: t.detach().requires_grad_(True) for k, t in arrays.items()}
                  for layer, arrays in (self.params if params is None else params).items()}
        data = self.data if data is None else data
        leaves = [t for arrays in params.values() for t in arrays.values()]
        logits, new_bn = self.clf.apply(params, self.bn if bn is None else bn, data["x"], train=True,
                                        generator=generator)
        loss = F.cross_entropy(logits.float(), data["y"])
        flat = iter(torch.autograd.grad(loss, leaves))
        grads = {layer: {k: next(flat) for k in arrays} for layer, arrays in params.items()}
        return loss.detach(), grads, {layer: {k: t.detach() for k, t in arrays.items()}
                                      for layer, arrays in new_bn.items()}

    def _body(self, state, data, gens, sc):
        import dataclasses

        loss, grads, new_bn = self.loss_and_grads(gens[0] if gens else None, state.params["clf"],
                                                  state.bn["clf"], data)
        new_params, new_opt = self.adam.update(state.params["clf"], grads, state.opt["clf"],
                                               scalars=tuple(sc.unbind()))
        return dataclasses.replace(state, params={"clf": new_params}, bn={"clf": new_bn}, opt={"clf": new_opt},
                                   step=state.step + 1), {"loss": loss}

    def step(self):
        """One Adam update; returns the loss before it (a device scalar)."""
        self.state, m = self.chunk(self.state, self.data)
        return m["loss"]

    def error(self, x_test, y_test) -> float:
        """The test error in [0, 1]: eval mode, in chunks of ``batch_size``
        (the last padded with zeros, its pad not scored)."""
        import numpy as np
        import torch

        b = int(self.cfg.batch_size)
        x = self._rescale(x_test)
        preds = []
        with torch.no_grad():
            for i in range(0, len(x), b):
                xi = x[i : i + b]
                pad = b - xi.shape[0]
                if pad:
                    xi = torch.cat([xi, xi.new_zeros((pad, *xi.shape[1:]))])
                logits, _ = self.clf.apply(self.params, self.bn, xi, train=False)
                preds.append(torch.argmax(logits, dim=-1)[: b - pad].cpu())
        return float((torch.cat(preds).numpy() != np.asarray(y_test)).mean())


def baseline_config(data_dir: str, seed: int, num_labeled: int):
    """``mnist100`` on digits at ``seed`` and ``num_labeled``."""
    from triplegan_tpu_torch.configs import get_config

    cfg = get_config("mnist100")
    cfg.dataset, cfg.seed, cfg.data_dir, cfg.num_labeled = "digits", seed, data_dir, num_labeled
    return cfg


def supervised_baseline(data_dir: str, seed: int, steps: int, num_labeled: int = 100, lr: float = 3e-4,
                        log_every: int = 500, device: str = "cuda") -> float:
    """Arm A: the test error in [0, 1] of ``SupervisedBaseline`` after
    ``steps`` full-batch updates on the labelled subset of ``seed``, a CUDA
    graph a step on the card. Its noise and dropout draw from generators
    seeded from (``seed``, step) (JAX's tool draws from ``PRNGKey(seed)``:
    other numbers)."""
    from triplegan_tpu_torch.data.datasets import load_dataset

    cfg = baseline_config(data_dir, seed, num_labeled)
    data = load_dataset(data_dir, "digits", num_labeled, cfg.num_classes, seed)
    run = SupervisedBaseline(cfg, data.x_label, data.y_label, device, lr=lr, noise_seed=seed)
    for i in range(steps):
        loss = run.step()
        if log_every and (i + 1) % log_every == 0:
            print(f"  baseline seed={seed} step {i + 1}/{steps} loss={float(loss):.4f}", flush=True)
    return run.error(data.x_test, data.y_test)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--seeds", default="1,2,3")
    # the mnist100 recipe verbatim (epochs 300, α_P warm-up 100), as the JAX tool
    ap.add_argument("--epochs", type=int, default=300, help="Triple-GAN epochs (12 steps each at batch 100)")
    ap.add_argument("--warmup-epochs", type=int, default=100, help="alpha_p warm-up of the Triple-GAN arm")
    ap.add_argument("--baseline-steps", type=int, default=3000)
    ap.add_argument("--num-labeled", type=int, default=100,
                    help="label budget of BOTH arms (a positive multiple of 10: class-balanced)")
    ap.add_argument("--eval-every-epochs", type=int, default=100)
    ap.add_argument("--ckpt-every-epochs", type=int, default=200)
    ap.add_argument("--scan-steps", type=int, default=campaign.SCAN_STEPS,
                    help="train steps a CUDA graph replay (eager steps on the CPU)")
    ap.add_argument("--device", default="cuda", type=_device_arg, help="cuda (the default), cuda:N or cpu")
    ap.add_argument("--dry-run", action="store_true", help="print the stage commands, run nothing")
    args = ap.parse_args(argv)

    seeds = [int(s) for s in args.seeds.split(",") if s]
    if args.num_labeled % 10 != 0 or args.num_labeled <= 0:
        ap.error(f"--num-labeled must be a positive multiple of 10, got {args.num_labeled}")
    if len(set(seeds)) != len(seeds):
        ap.error(f"duplicate seeds in --seeds {args.seeds!r}")

    def stage_cmds(seed):
        return campaign.stage_cmds(
            seed, workdir=args.workdir, data_dir=args.data_dir, num_labeled=args.num_labeled,
            epochs=args.epochs, warmup_epochs=args.warmup_epochs, eval_every_epochs=args.eval_every_epochs,
            ckpt_every_epochs=args.ckpt_every_epochs, device=args.device, scan_steps=args.scan_steps)

    if args.dry_run:
        print(f"+ {shlex.join(campaign.cli_cmd(stage_cmds(seeds[0])['prepare']))}")
        for seed in seeds:
            cmds = stage_cmds(seed)
            print(f"# seed {seed}: supervised baseline ({args.baseline_steps} steps, in-process)")
            for leg in ("train", "eval"):
                print(f"+ {shlex.join(campaign.cli_cmd(cmds[leg]))}")
        return 0

    os.makedirs(args.workdir, exist_ok=True)
    campaign.run_cli(stage_cmds(seeds[0])["prepare"])

    baseline_errors, triplegan_errors, final_metrics, timing = [], [], [], []
    for seed in seeds:
        cmds = stage_cmds(seed)
        print(f"=== seed {seed}: supervised baseline ===", flush=True)
        t0 = time.perf_counter()
        be = supervised_baseline(args.data_dir, seed, args.baseline_steps, args.num_labeled, device=args.device)
        baseline_s = time.perf_counter() - t0
        print(f"  baseline seed={seed} test error: {100 * be:.2f}%", flush=True)
        baseline_errors.append(be)

        print(f"=== seed {seed}: Triple-GAN semi-supervised ===", flush=True)
        name = f"digits_n{args.num_labeled}_s{seed}"
        log = os.path.join(args.workdir, f"{name}_train.log")
        t0 = time.perf_counter()
        campaign.run_cli(cmds["train"], log_path=log)
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = campaign.run_cli(cmds["eval"])
        eval_s = time.perf_counter() - t0
        m = campaign.ERROR_RE.search(out)
        if not m:
            print(f"could not parse test error from eval output for seed {seed}", file=sys.stderr)
            return 1
        triplegan_errors.append(float(m.group(1)) / 100.0)
        final_metrics.append(campaign.parse_final_metrics(log))
        timing.append({"seed": seed, "train_seconds": train_s, "eval_seconds": eval_s,
                       "baseline_seconds": baseline_s, "train_log_final_error_pct":
                       campaign.parse_train_final_error(log),
                       **campaign.run_timing(os.path.join(args.workdir, name))})

    b_mean = sum(baseline_errors) / len(baseline_errors)
    t_mean = sum(triplegan_errors) / len(triplegan_errors)
    gain = b_mean - t_mean
    verdict = "PASS" if gain > 0 else "FAIL"
    wins = sum(1 for b, t in zip(baseline_errors, triplegan_errors) if t < b)
    summary = {
        "dataset": "digits",
        "num_labeled": args.num_labeled,
        "seeds": seeds,
        "baseline_errors_pct": [round(100 * e, 2) for e in baseline_errors],
        "triplegan_errors_pct": [round(100 * e, 2) for e in triplegan_errors],
        "baseline_mean_pct": round(100 * b_mean, 2),
        "triplegan_mean_pct": round(100 * t_mean, 2),
        "gain_pct": round(100 * gain, 2),
        "seed_wins": f"{wins}/{len(seeds)}",
        "sign_test_p": round(stats.sign_test_p(baseline_errors, triplegan_errors), 4),
        "perm_test_p": round(stats.paired_permutation_p(baseline_errors, triplegan_errors), 4),
        "epochs": args.epochs,
        "baseline_steps": args.baseline_steps,
        "verdict": verdict,
        "implementation": "triplegan_tpu_torch",
        "device": campaign.device_line(args.device),
        "scan_steps": args.scan_steps,
        "final_metrics": final_metrics,
        "timing": timing,
    }
    path = os.path.join(args.workdir, f"digits_summary_n{args.num_labeled}.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k not in ("final_metrics", "timing")}, indent=2))
    print(f"summary → {path}\nverdict: {verdict} (semi-supervised {100 * t_mean:.2f}% vs supervised-only "
          f"{100 * b_mean:.2f}% on the same {args.num_labeled} real labels)")
    return 0 if verdict == "PASS" else 2


if __name__ == "__main__":
    raise SystemExit(main())
