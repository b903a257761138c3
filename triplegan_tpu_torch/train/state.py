"""The three-player training state: the port of
``triplegan_tpu/train/state.py``. Parameters and batch-norm running stats
are nested trees ``{player: {layer: {array: tensor}}}`` in the port's
layouts (``bridge.py``); each player has its Adam state; ``step`` counts
updates and ``seed`` seeds the per-step generators of noise, dropout,
augmentation, pseudo-label sampling and batch sampling."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from triplegan_tpu_torch.train.schedule import AdamState
from triplegan_tpu_torch.utils.platform import resolve_device

PLAYERS = ("gen", "disc", "clf")


@dataclasses.dataclass
class TrainState:
    params: Dict[str, dict]
    bn: Dict[str, dict]
    opt: Dict[str, AdamState]
    step: int
    seed: int


def create_state(cfg, nets, optimizers, seed: Optional[int] = None, device=None,
                 params: Optional[dict] = None, bn: Optional[dict] = None) -> TrainState:
    """A fresh state on ``device`` (default the card): each player's
    weights drawn by its ``init`` from one generator seeded with ``seed``
    (default ``cfg.seed``), Generator, then Discriminator, then Classifier;
    or, given ``params`` and ``bn`` trees (e.g. carried from the JAX
    package by the bridge), those."""
    dev = resolve_device(device)
    seed = int(cfg.seed if seed is None else seed)
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params, bn = {}, {}
        for name, net in zip(PLAYERS, nets):
            params[name], bn[name] = net.init(gen)

    def move(tree):
        return {layer: {k: t.to(dev, torch.float32).clone() for k, t in arrays.items()}
                for layer, arrays in tree.items()}

    params = {p: move(params[p]) for p in PLAYERS}
    bn = {p: move(bn.get(p, {})) for p in PLAYERS}
    opt = {p: optimizers[p].init(params[p]) for p in PLAYERS}
    return TrainState(params=params, bn=bn, opt=opt, step=0, seed=seed)


def param_count(state: TrainState) -> Dict[str, int]:
    """Parameters per player (batch-norm statistics not counted)."""
    return {p: sum(t.numel() for arrays in tree.values() for t in arrays.values())
            for p, tree in state.params.items()}

