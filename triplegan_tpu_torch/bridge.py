"""Carry weights between the JAX package's layouts and the port's.

The JAX package keeps ``params`` and ``bn`` as nested dicts
``{player: {layer: {array: ndarray}}}`` and exports them flat to
``params.npz`` under ``params/<player>/<layer>/<array>`` and
``bn/<player>/<layer>/<array>`` (``cli export --format npz``). The port's
state is one ``state_dict`` per player, keyed ``<layer>.<array>``
(``nn/networks.py``).

Layouts: a conv kernel goes HWIO → OIHW; a dense kernel stays (in, out);
a deconv kernel (the Generator's 4-D kernels) stays (k, k, in, out);
``g``, ``b`` and the batch-norm arrays go over as they are. Only the
players the port has (``gen``, ``clf``) are carried; the Discriminator
comes with the training slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

PLAYERS = ("gen", "clf")
_DECONV_PLAYERS = ("gen",)  # whose 4-D kernels are transposed-conv kernels


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
    dicts of numpy arrays: ``mean``/``var`` go to ``bn``, the rest to
    ``params``."""
    params: dict = {}
    bn: dict = {}
    for player, sd in state.items():
        params[player], bn[player] = {}, {}
        for key, t in sd.items():
            layer, name = key.split(".")
            tree = bn if name in ("mean", "var") else params
            tree[player].setdefault(layer, {})[name] = _to_jax(player, t)
    return params, bn


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
