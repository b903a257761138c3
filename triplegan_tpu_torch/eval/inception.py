"""Inception-style score of class-conditional generation: the port of
``triplegan_tpu/eval/inception.py``.

IS = exp( E_x[ KL( p(y|x) || p(y) ) ] ) over generated samples, with a
pluggable scoring classifier. The canonical scorer is an ImageNet
Inception-v3, whose weights are not fetched here: the scorer is an
argument, any ``images -> logits`` function (the run's own eval-mode
classifier, an ``.npz`` linear probe, an exported classifier artifact, or
a TF SavedModel where TensorFlow is installed).

The scorer functions take and return tensors on the caller's device; the
score itself is float64 numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def host64(t) -> np.ndarray:
    """A tensor or array as float64 numpy on the host."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float64).numpy()
    return np.asarray(t, dtype=np.float64)


def inception_score(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    images,
    n_splits: int = 10,
    batch_size: int = 256,
) -> Tuple[float, float]:
    """Mean ± std of the score over ``n_splits`` disjoint splits (Salimans
    et al.'s protocol). The scorer is driven in ``batch_size`` chunks; a
    scorer with ``preferred_batch`` (an exported artifact's static batch)
    sets the chunk size, so that chunks land aligned. The softmax runs in
    the logits' dtype, the rest in float64."""
    batch_size = int(getattr(logits_fn, "preferred_batch", None) or batch_size)
    chunks = [
        host64(torch.softmax(torch.as_tensor(logits_fn(images[i : i + batch_size])), dim=-1))
        for i in range(0, images.shape[0], batch_size)
    ]
    probs = np.concatenate(chunks, axis=0)
    n = probs.shape[0]
    split_size = max(n // n_splits, 1)
    scores = []
    for i in range(0, n - split_size + 1, split_size):
        p = probs[i : i + split_size]
        py = p.mean(axis=0, keepdims=True)
        kl = np.sum(p * (np.log(p + 1e-12) - np.log(py + 1e-12)), axis=1)
        scores.append(float(np.exp(kl.mean())))
    return float(np.mean(scores)), float(np.std(scores))


_PREFERRED_OUTPUT_KEYS = (
    "logits", "predictions", "probs", "probabilities", "output", "outputs",
)


def _pick_output(out: dict, output_name):
    """The scoring tensor of a multi-output serving signature: by explicit
    name, the single entry, or a conventional key; never by dict order."""
    if output_name is not None:
        if output_name not in out:
            raise KeyError(
                f"scorer output '{output_name}' not in signature outputs {sorted(out)}"
            )
        return out[output_name]
    if len(out) == 1:
        return next(iter(out.values()))
    for k in _PREFERRED_OUTPUT_KEYS:
        if k in out:
            return out[k]
    raise KeyError(
        f"SavedModel signature has multiple outputs {sorted(out)} and none "
        f"matches a conventional name {_PREFERRED_OUTPUT_KEYS}; pass "
        f"output_name= (CLI: --scorer-output-name) to pick one"
    )


def _as_logits(arr: np.ndarray, outputs: str, state: dict) -> np.ndarray:
    """Something safe to softmax: probabilities (which Keras and TF-Hub
    Inception exports often emit) go through ``log``, the exact inverse
    under the softmax that follows.

    ``auto`` decides on the first batch and re-checks every later one,
    with hysteresis: the first decision is tight (row sums within 1e-3 of
    1, no entry below -1e-6), but a stream taken for probabilities is only
    declared flipped on a batch that is clearly not probabilities (an entry
    below -1e-3, or a row sum off by more than 0.05), so that a
    reduced-precision softmax export completes. A flip raises
    ``ValueError``: a first batch of logits that happened to look like
    probabilities must not commit the whole run to the log mapping."""
    if outputs == "logits":
        return arr
    if outputs == "probs":
        return np.log(np.maximum(arr, 1e-12))
    looks_probs = bool(
        np.all(arr >= -1e-6) and np.allclose(arr.sum(axis=-1), 1.0, atol=1e-3)
    )
    batch_no = state["batches"] = state.get("batches", 0) + 1
    if "is_probs" not in state:
        state["is_probs"] = looks_probs
        if looks_probs:
            import warnings

            warnings.warn(
                "scorer outputs look like probabilities (non-negative rows "
                "summing to 1); treating them as probs to avoid a double "
                "softmax — pass outputs='logits' to override",
                stacklevel=2,
            )
        return np.log(np.maximum(arr, 1e-12)) if state["is_probs"] else arr
    if state["is_probs"]:
        flipped = bool(
            np.any(arr < -1e-3)
            or not np.allclose(arr.sum(axis=-1), 1.0, atol=5e-2)
        )
    else:
        flipped = looks_probs
    if flipped:
        kinds = ("logits", "probabilities")
        raise ValueError(
            f"scorer output mode flipped mid-stream: batch {batch_no} looks "
            f"like {kinds[not state['is_probs']]} but batch 1 looked like "
            f"{kinds[state['is_probs']]} — auto-detection is unreliable for "
            f"this scorer (e.g. a near-uniform logits model masquerading as "
            f"probabilities); pass outputs='logits' or 'probs' explicitly "
            f"(CLI: --scorer-outputs)"
        )
    return np.log(np.maximum(arr, 1e-12)) if state["is_probs"] else arr


def _to_pixels(x: np.ndarray) -> np.ndarray:
    """Images as the uint8 pixels a classifier artifact takes. Float images
    are in the generator's [-1, 1] space (rescale configs) or raw [0, 255]
    pixel floats (rescale=False): told apart by their range, so that the
    latter do not saturate."""
    if x.dtype == np.uint8:
        return x
    if x.size and float(np.max(np.abs(x))) <= 1.0 + 1e-3:
        x = np.clip(np.round((x + 1.0) * 127.5), 0, 255)
    else:
        x = np.clip(np.round(x), 0, 255)
    return x.astype(np.uint8)


def load_scorer(path: str, outputs: str = "auto", output_name: Optional[str] = None,
                device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """An ``images -> logits`` scorer from a local file, for
    :func:`inception_score` (and, with ``outputs="logits"``, a feature
    extractor for ``eval/fid.py``):

      * a **TF SavedModel directory** (holding ``saved_model.pb``), e.g. an
        Inception-v3 export, through a lazy ``import tensorflow``: it must
        take a float32 NHWC batch; images are resized bilinearly to the
        model's spatial size (its input spec's, else 299) and passed as
        they come ([-1, 1]);
      * an **exported classifier artifact** (``.pt2``, ``cli export --what
        classifier``): run A's samples scored by run B's classifier. It
        takes uint8 pixels at its static batch: float [-1, 1] (or [0, 255])
        images are mapped to pixels, the last chunk is padded to the
        artifact's batch, and ``preferred_batch`` is that batch. It runs
        on ``device`` (default the card; ``export.load_pt2``), and the
        spatial shape must be the artifact's;
      * an **.npz linear probe**: ``w`` (features, classes) and optional
        ``b``; images are flattened.

    ``outputs``: ``"logits"``, ``"probs"`` (mapped through ``log``, so that
    the softmax of the score recovers them) or ``"auto"`` (``_as_logits``).
    ``output_name`` picks the tensor of a multi-output SavedModel
    signature. The scorer returns a tensor on its input's device (the
    host's for numpy input)."""
    if outputs not in ("auto", "logits", "probs"):
        raise ValueError(f"outputs must be auto|logits|probs, got {outputs!r}")

    def back(arr: np.ndarray, like) -> torch.Tensor:
        dev = like.device if isinstance(like, torch.Tensor) else "cpu"
        return torch.as_tensor(arr, device=dev)

    if os.path.isdir(path):
        if not os.path.exists(os.path.join(path, "saved_model.pb")):
            raise FileNotFoundError(f"no saved_model.pb under {path}")
        try:
            import tensorflow as tf  # a local adapter, never on a hot path
        except ImportError as e:
            raise ImportError(
                f"{path} is a TF SavedModel, which needs the tensorflow package "
                f"(not installed here): {e}"
            ) from e

        mod = tf.saved_model.load(path)
        fn = mod.signatures.get("serving_default", None) if hasattr(mod, "signatures") else None
        call = fn if fn is not None else mod
        size = 299
        specs = getattr(call, "structured_input_signature", None)
        if specs:
            flat = tf.nest.flatten(specs)
            shapes = [s.shape for s in flat if hasattr(s, "shape") and s.shape.rank == 4]
            if shapes and shapes[0][1] is not None:
                size = int(shapes[0][1])
        probe_state: dict = {}

        def tf_scorer(images):
            x = images.detach().cpu().numpy() if isinstance(images, torch.Tensor) else images
            xt = tf.image.resize(tf.convert_to_tensor(np.asarray(x, np.float32)), (size, size))
            out = call(xt)
            if isinstance(out, dict):
                out = _pick_output(out, output_name)
            return back(_as_logits(out.numpy(), outputs, probe_state), images)

        return tf_scorer

    if path.endswith(".pt2"):
        from triplegan_tpu_torch.export import load_pt2

        art = load_pt2(path, device=device)
        if len(art.in_specs) != 1:
            raise ValueError(
                f"{path} is not a classifier artifact (takes {len(art.in_specs)} inputs; "
                f"a classifier takes 1: uint8 images)"
            )
        shape = art.in_specs[0][0]
        b, expect_shape = int(shape[0]), tuple(shape[1:])
        art_state: dict = {}

        def pt2_scorer(images):
            x = images.detach().cpu().numpy() if isinstance(images, torch.Tensor) else np.asarray(images)
            if x.shape[1:] != expect_shape:
                raise ValueError(
                    f"pt2 scorer expects images of shape {expect_shape} (from the "
                    f"artifact's serving contract), got {x.shape[1:]}"
                )
            x = _to_pixels(x)
            outs = []
            for i in range(0, x.shape[0], b):
                xi = x[i : i + b]
                pad = b - xi.shape[0]
                if pad:  # the static serving batch: pad the last chunk
                    xi = np.concatenate([xi, np.repeat(xi[-1:], pad, axis=0)])
                o = art(torch.from_numpy(xi)).cpu().numpy()
                outs.append(o[: b - pad] if pad else o)
            return back(_as_logits(np.concatenate(outs, axis=0), outputs, art_state), images)

        pt2_scorer.preferred_batch = b
        return pt2_scorer

    with np.load(path) as wts:
        if "w" not in wts:
            raise KeyError(f"{path}: expected an .npz with key 'w' (features, classes)")
        w_np = np.asarray(wts["w"], np.float32)
        b_np = np.asarray(wts["b"], np.float32) if "b" in wts else np.zeros((w_np.shape[1],), np.float32)
    npz_state: dict = {}

    def npz_scorer(images):
        x = torch.as_tensor(images)
        out = x.reshape(x.shape[0], -1) @ torch.from_numpy(w_np).to(x.device)
        out = out + torch.from_numpy(b_np).to(x.device)
        if outputs == "logits":
            return out
        # probs and auto go through the host check every batch, so that a
        # flip raises (IS and FID are once-an-eval paths, not a hot loop)
        return back(_as_logits(out.cpu().numpy(), outputs, npz_state), x)

    return npz_scorer
