"""Checkpoints of the whole three-player state: the port of
``triplegan_tpu/ckpt/manager.py``.

A checkpoint is one file, ``<directory>/<step>``, written by ``torch.save``
and read back by ``torch.load(weights_only=True)``. It holds all that a
resumed run needs to continue as if never stopped: every player's
parameters and batch-norm statistics, each Adam's ``count``, ``mu`` and
``nu``, and the state's ``step`` and ``seed`` (the train step's random
streams depend only on these two).

A save is published atomically: the file is written to
``<step>.tmp-<pid>``, flushed to disk and renamed to ``<step>``, so a
reader sees the whole checkpoint or none. A save interrupted before the
rename leaves its tmp file behind; readers ignore such files, and a
manager opened to write (the train driver) deletes them on opening. Only
the ``max_to_keep`` newest checkpoints are kept. Saving is synchronous.

The JAX package's checkpoints (orbax directories) are not read here;
weights cross between the packages through ``bridge.py``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from triplegan_tpu_torch.train.schedule import AdamState
from triplegan_tpu_torch.train.state import PLAYERS, TrainState

_TMP = ".tmp-"


def _payload(state: TrainState) -> dict:
    return {
        "params": state.params,
        "bn": state.bn,
        "opt": {p: {"count": int(s.count), "mu": s.mu, "nu": s.nu} for p, s in state.opt.items()},
        "step": int(state.step),
        "seed": int(state.seed),
    }


def _leaves(tree, prefix="") -> Dict[str, object]:
    """Every leaf of a nested dict by its '/'-joined path, in key order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _check_like(got: dict, want: dict, path: str) -> None:
    """Raise ``ValueError`` naming the first leaf of ``got`` whose key,
    shape or dtype differs from the template ``want``."""
    g, w = _leaves(got), _leaves(want)
    for key in sorted(set(g) | set(w)):
        if key not in g:
            raise ValueError(f"{path}: checkpoint lacks '{key}', which the template has")
        if key not in w:
            raise ValueError(f"{path}: checkpoint has '{key}', which the template lacks")
        a, b = g[key], w[key]
        if isinstance(b, torch.Tensor):
            if not isinstance(a, torch.Tensor):
                raise ValueError(f"{path}: '{key}' is {type(a).__name__}, the template's a tensor")
            if a.shape != b.shape:
                raise ValueError(f"{path}: '{key}' has shape {tuple(a.shape)}, "
                                 f"the template {tuple(b.shape)}")
            if a.dtype != b.dtype:
                raise ValueError(f"{path}: '{key}' has dtype {a.dtype}, the template {b.dtype}")
        elif not isinstance(a, int) or isinstance(a, bool):
            raise ValueError(f"{path}: '{key}' is {type(a).__name__}, the template's an int")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, write: bool = True):
        """``write=False`` opens a reader (eval, sample): it never deletes
        anything, since another process may be writing to the directory."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)
        if write:
            for name in os.listdir(self.directory):
                if _TMP in name:
                    os.remove(os.path.join(self.directory, name))

    def all_steps(self) -> List[int]:
        """The steps of the published checkpoints, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> bool:
        """Publish ``state`` as checkpoint ``step`` and drop the oldest
        beyond ``max_to_keep``. A step at or below the latest saved one is
        not saved again (False), as orbax does."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        final = os.path.join(self.directory, str(int(step)))
        tmp = f"{final}{_TMP}{os.getpid()}"
        with open(tmp, "wb") as f:
            torch.save(_payload(state), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        if self.max_to_keep > 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(os.path.join(self.directory, str(old)))
        return True

    def restore(self, template: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
        """The checkpoint ``step`` (default the latest) as a ``TrainState``
        on the device of ``template``'s tensors, which it must match key for
        key, in shape and dtype. None when there is no checkpoint;
        ``FileNotFoundError`` listing the steps there are for an explicit
        ``step`` that is not one of them."""
        steps = self.all_steps()
        target = step if step is not None else (steps[-1] if steps else None)
        if target is None:
            return None
        if target not in steps:
            raise FileNotFoundError(f"no checkpoint for step {step} (available: {steps})")
        path = os.path.join(self.directory, str(target))
        want = _payload(template)
        dev = next(iter(_leaves(want["params"]).values())).device
        got = torch.load(path, map_location=dev, weights_only=True)
        _check_like(got, want, path)
        return TrainState(
            params={p: got["params"][p] for p in PLAYERS},
            bn={p: got["bn"][p] for p in PLAYERS},
            opt={p: AdamState(got["opt"][p]["count"], got["opt"][p]["mu"], got["opt"][p]["nu"])
                 for p in PLAYERS},
            step=got["step"],
            seed=got["seed"],
        )

    def refresh(self) -> None:
        """Nothing to do: the directory is listed afresh at every call
        (kept for the JAX manager's interface)."""

    def wait(self) -> None:
        """Nothing to wait for: saves are synchronous."""

    def close(self) -> None:
        """Nothing to release."""
