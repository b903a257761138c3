"""The numbers the output check compares, each a gap between the program's
reading and the plain reference's. Limits are set from the readings of
sound runs and of the control (``calibrate.py``) and kept per cell in
``limits/<workload>.json``."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


def _norms(trees: Dict[str, Tree]) -> Dict[str, float]:
    return {f"{p}/{l}/{a}": float(torch.linalg.vector_norm(t.detach().double().cpu()))
            for p, tree in trees.items() for l, arrays in tree.items() for a, t in arrays.items()}


def _diff(a: Dict[str, Tree], b: Dict[str, Tree]) -> Dict[str, Tree]:
    return {p: {l: {k: a[p][l][k].detach().double().cpu() - b[p][l][k].detach().double().cpu() for k in arrays}
                for l, arrays in tree.items()} for p, tree in a.items()}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> Tuple[float, str]:
    """The largest gap between the two norms of a leaf, over the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[k] for k in keep)
    worst, at = 0.0, ""
    for k in keep:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med)
        if not math.isfinite(gap):
            return math.inf, k
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def moving_leaves(ref_grads: Dict[str, Tree]) -> Tuple[List[str], List[str]]:
    """(leaves compared, leaves left out): a leaf whose gradient in the
    reference's first step is under a thousandth of the median leaf's is
    nought to rounding (a bias that batch norm removes), and Adam moves it
    by round-off alone."""
    g = _norms(ref_grads)
    med = statistics.median(g.values())
    keep = sorted(k for k, v in g.items() if v >= 1e-3 * med)
    return keep, sorted(set(g) - set(keep))


def flipped_share(prog: Tree, ref: Tree, p0: Tree, keep: List[str], lr: float) -> float:
    """The share of the elements of one player's compared leaves (``keep``:
    "<player>/<layer>/<array>") whose change over the steps lies more than
    1.5 learning rates from the reference's. Adam's first step moves each element by about ±lr
    whatever the size of its gradient, so an element whose first gradient
    the two sides round to opposite signs ends about 2 lr apart, which a
    later step's flip, softened by the moments' history, seldom reaches;
    a lower precision rounds many more small gradients the other way."""
    flipped, total = 0, 0
    for key in keep:
        _, l, a = key.split("/")
        base = p0[l][a].detach().double().cpu()
        gap = ((prog[l][a].detach().double().cpu() - base) - (ref[l][a].detach().double().cpu() - base)).abs()
        flipped += int((gap > 1.5 * lr).sum())
        total += gap.numel()
    return flipped / total


def train_numbers(prog: dict, ref: dict, p0: Dict[str, Tree], lr_d: float) -> Tuple[Dict[str, float], dict]:
    """``prog`` and ``ref``: {"losses": [(loss_d, loss_g, loss_c) a step],
    "mu": Adam's first moments after the steps, "params": the parameters
    after them}; ``ref`` also "grads", its first step's gradients.

    * ``loss_d_step1``: the relative gap of the first step's D loss, the
      one loss computed from the initial state alone (G's and C's first
      losses are scored after D's first update, whose Adam step moves
      every weight by about ±lr whatever the size of its gradient, so
      they carry the two sides' rounding apart);
    * ``loss``: the largest relative gap of any step's loss;
    * ``adam_mu``: the worst leaf's gap of the norm of Adam's first moment
      (the gradients as the optimizer holds them) after the steps;
    * ``change``: the worst leaf's gap of the norm of the parameters'
      change over the steps;
    * ``flipped_disc``: ``flipped_share`` of D's parameters, whose first
      update depends on the initial state alone.

    ``lr_d`` is D's learning rate."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError(f"{len(prog['losses'])} steps of losses against the reference's {len(ref['losses'])}")
    gaps = [[abs(x - y) / max(abs(y), 1e-12) if math.isfinite(x) else math.inf for x, y in zip(a, b)]
            for a, b in zip(prog["losses"], ref["losses"])]
    keep, left_out = moving_leaves(ref["grads"])
    mu, mu_at = worst_leaf(_norms(prog["mu"]), _norms(ref["mu"]), keep)
    change, ch_at = worst_leaf(_norms(_diff(prog["params"], p0)), _norms(_diff(ref["params"], p0)), keep)
    disc = [k for k in keep if k.startswith("disc/")]
    return ({"loss_d_step1": gaps[0][0], "loss": max(map(max, gaps)), "adam_mu": mu, "change": change,
             "flipped_disc": flipped_share(prog["params"]["disc"], ref["params"]["disc"], p0["disc"], disc, lr_d)},
            {"adam_mu_leaf": mu_at, "change_leaf": ch_at, "left_out": left_out, "leaves": len(keep),
             "loss_gaps": gaps})

