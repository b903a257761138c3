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
the ``max_to_keep`` newest checkpoints are kept.

Saves are asynchronous, as the JAX manager's orbax saves are: ``save``
copies every tensor of the state to the host (into pinned buffers kept
for the next save, when the state lies on the card) and waits for those
copies, so the caller may change the state the moment ``save`` returns
(a ``ScanChunk`` writes into the state's own tensors); then one writer
thread writes, fsyncs, renames and prunes while the caller trains on. At
most one save is in flight: the next ``save`` waits for it. ``wait``
joins the writer and raises what it raised; ``close`` waits.

Under a data mesh (``parallel/mesh.py``) the state is replicated, so the
coordinator alone writes; every rank returns the same answer from
``save``, and ``wait`` and ``close`` end in a barrier after the
coordinator's file is published (every rank raises if its write failed).
Every rank restores the same file. A checkpoint holds no trace of the mesh
it was written on: one written by N ranks restores exactly on M.

The JAX package's checkpoints (orbax directories) are not read here;
weights cross between the packages through ``bridge.py``.
"""

from __future__ import annotations

import os
import threading
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
    def __init__(self, directory: str, max_to_keep: int = 3, write: bool = True, mesh=None):
        """``write=False`` opens a reader (eval, sample): it never deletes
        anything, since another process may be writing to the directory.
        Under ``mesh`` only its coordinator writes or deletes."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        self.mesh = mesh
        self._coordinator = mesh is None or mesh.coordinator
        self._writer: Optional[threading.Thread] = None
        self._inflight: Optional[int] = None
        self._error: Optional[Exception] = None
        self._staging: Dict[str, torch.Tensor] = {}
        os.makedirs(self.directory, exist_ok=True)
        if write and self._coordinator:
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
        """Start publishing ``state`` as checkpoint ``step`` (True), once the
        save in flight, if any, is published; the state's tensors are
        copied to the host before this returns. A step at or below the
        latest saved or in flight is not saved again (False), as orbax
        does. Under a mesh every rank returns the coordinator's answer."""
        saved = self._save(int(step), state) if self._coordinator else False
        if self.mesh is not None:
            saved = self.mesh.any(saved)
        return saved

    def _save(self, step: int, state: TrainState) -> bool:
        known = self.all_steps() + ([] if self._inflight is None else [self._inflight])
        if known and step <= max(known):
            return False
        self.join()
        self._raise_error()
        payload = self._host_copy(_payload(state))
        self._inflight = step
        self._writer = threading.Thread(target=self._write, args=(step, payload),
                                        name=f"ckpt-save-{step}", daemon=False)
        self._writer.start()
        return True

    def _host_copy(self, payload: dict) -> dict:
        """``payload`` with every tensor copied into a host buffer of this
        manager's, once the copies are done. The writer of the previous
        save has finished with the buffers (``_save`` joins it first)."""
        cards = set()
        for key, t in _leaves(payload).items():
            if not isinstance(t, torch.Tensor):
                continue
            buf = self._staging.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = self._staging[key] = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                                                       pin_memory=t.is_cuda)
            buf.copy_(t, non_blocking=t.is_cuda)
            if t.is_cuda:
                cards.add(t.device)
        for dev in cards:
            torch.cuda.synchronize(dev)

        def rebuild(tree, prefix=""):
            return {k: rebuild(v, f"{prefix}{k}/") if isinstance(v, dict) else
                    (self._staging[prefix + k] if isinstance(v, torch.Tensor) else v)
                    for k, v in tree.items()}

        return rebuild(payload)

    def _write(self, step: int, payload: dict) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}{_TMP}{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
            if self.max_to_keep > 0:
                for old in self.all_steps()[:-self.max_to_keep]:
                    os.remove(os.path.join(self.directory, str(old)))
        except Exception as e:  # kept for wait(), which raises it in the caller's thread
            self._error = e
            if os.path.exists(tmp):
                os.remove(tmp)

    def join(self) -> None:
        """Wait until the save in flight, if any, is published or has
        failed; no collective, and no error raised (``wait`` raises it)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = self._inflight = None

    def _raise_error(self) -> None:
        err, self._error = self._error, None
        if err is not None:
            raise err

    def restore(self, template: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
        """The checkpoint ``step`` (default the latest) as a ``TrainState``
        on the device of ``template``'s tensors, which it must match key for
        key, in shape and dtype. None when there is no checkpoint;
        ``FileNotFoundError`` listing the steps there are for an explicit
        ``step`` that is not one of them. A save of this manager's in
        flight is published first."""
        self.join()
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
        """Block until the save in flight is published; raise the error of
        its write, if it failed. Under a mesh every rank waits for the
        coordinator's (the barrier) and raises if it failed."""
        self.join()
        failed = self._error is not None
        if self.mesh is not None and self.mesh.any(failed) and not failed:
            raise RuntimeError(f"the coordinator's checkpoint save under {self.directory} failed")
        self._raise_error()

    def close(self) -> None:
        """``wait``: the last save is published when this returns."""
        self.wait()
