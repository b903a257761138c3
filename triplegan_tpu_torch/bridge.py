"""Carry weights between the JAX package's layouts and the port's.

The JAX package keeps ``params`` and ``bn`` as nested dicts
``{player: {layer: {array: ndarray}}}`` and exports them flat to
``params.npz`` under ``params/<player>/<layer>/<array>`` and
``bn/<player>/<layer>/<array>`` (``cli export --format npz``). The port's
state is one ``state_dict`` per player, keyed ``<layer>.<array>``
(``nn/networks.py``).

Layouts: a conv kernel goes HWIO → OIHW; a dense kernel stays (in, out);
a deconv kernel (the Generator's 4-D kernels) stays (k, k, in, out);
``g``, ``b``, the Discriminator's weight-norm dense head and the
batch-norm arrays go over as they are. All three players are carried:
``gen``, ``disc`` (whose 4-D kernels are convs) and ``clf``.

The train step works on nested trees instead (``nn/networks.py``):
``nested`` and ``flat`` convert one player's state_dict to and from its
(params, stats) trees.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

PLAYERS = ("gen", "disc", "clf")
_DECONV_PLAYERS = ("gen",)  # whose 4-D kernels are transposed-conv kernels
# statistics, not parameters: batch norm's running moments, a spectrally
# normalised layer's power-iteration vector, StyleGAN2's running mean of w;
# and every array named with EMA_SUFFIX, a moving average of the parameter
# of that name (StyleGAN2's G keeps one of each)
STATS = ("mean", "var", "u", "w_avg")
EMA_SUFFIX = "_ema"


def is_stat(name: str) -> bool:
    return name in STATS or name.endswith(EMA_SUFFIX)


def _to_port(player: str, arr) -> torch.Tensor:
    a = np.asarray(arr, dtype=np.float32)
    if a.ndim == 4 and player not in _DECONV_PLAYERS:
        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return torch.tensor(a)  # a contiguous copy: the source may be read-only


def _to_jax(player: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().to("cpu", torch.float32).numpy()
    if a.ndim == 4 and player not in _DECONV_PLAYERS:
        a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    return np.ascontiguousarray(a)


def from_jax(params: dict, bn: dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX ``params``/``bn`` nested dicts (of numpy or jax arrays) → the
    port's ``{player: state_dict}``."""
    state = {}
    for player in PLAYERS:
        if player not in params:
            continue
        sd = {}
        for tree in (params[player], bn.get(player, {})):
            for layer, arrays in tree.items():
                for name, arr in arrays.items():
                    sd[f"{layer}.{name}"] = _to_port(player, arr)
        state[player] = sd
    return state


def to_jax(state: Dict[str, Dict[str, torch.Tensor]]):
    """The port's ``{player: state_dict}`` → JAX ``(params, bn)`` nested
    dicts of numpy arrays: the statistics (``is_stat``) go to ``bn``, the rest
    to ``params``."""
    params: dict = {}
    bn: dict = {}
    for player, sd in state.items():
        params[player], bn[player] = {}, {}
        for key, t in sd.items():
            layer, name = key.split(".")
            tree = bn if is_stat(name) else params
            tree[player].setdefault(layer, {})[name] = _to_jax(player, t)
    return params, bn


def nested(sd: Dict[str, torch.Tensor]):
    """One player's state_dict ``{"<layer>.<array>": t}`` → its (params,
    stats) trees ``{layer: {array: t}}``; the statistics (``is_stat``) go to
    stats."""
    params: dict = {}
    stats: dict = {}
    for key, t in sd.items():
        layer, name = key.split(".")
        (stats if is_stat(name) else params).setdefault(layer, {})[name] = t
    return params, stats


def flat(params: dict, stats: dict) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`nested`."""
    return {f"{layer}.{name}": t for tree in (params, stats)
            for layer, arrays in tree.items() for name, t in arrays.items()}


def load_npz(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """Read a JAX ``export_npz`` file into the port's ``{player: state_dict}``."""
    params: dict = {}
    bn: dict = {}
    with np.load(path, allow_pickle=False) as f:
        for key in f.files:
            parts = key.split("/")
            if len(parts) != 4 or parts[0] not in ("params", "bn"):
                raise ValueError(f"{path}: unexpected key {key!r} (want kind/player/layer/array)")
            kind, player, layer, name = parts
            tree = params if kind == "params" else bn
            tree.setdefault(player, {}).setdefault(layer, {})[name] = f[key]
    return from_jax(params, bn)
