"""The two servable functions of a trained run, on the port's networks.

Mirrors ``triplegan_tpu/export.py::make_serving_fns``:

  * ``classify(images_u8) -> logits``: eval-mode classifier with the
    training-time input transform (rescale to [-1, 1], ZCA for zca
    configs) in the config's compute dtype; float32 logits out.
  * ``generate(z, y) -> images``: eval-mode generator in z's dtype (the
    server sends float32 z, so the generator stays float32 at a bfloat16
    config, as in the JAX package), raw [-1, 1] NHWC images out.

Both take and return tensors and run under ``torch.inference_mode()``.
int8 PTQ and the traced-artifact formats of the JAX module wait for a
later slice.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from triplegan_tpu_torch.data import ondevice
from triplegan_tpu_torch.utils.platform import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg) -> torch.dtype:
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {cfg.compute_dtype!r}")
    return _DTYPES[cfg.compute_dtype]


def make_serving_fns(cfg, nets, state, zca_stats=None, device=None) -> Tuple[Callable, Callable]:
    """Load ``state`` (``{"gen": state_dict, "clf": state_dict}``, see
    ``bridge.py``) into ``nets`` (``configs.make_networks``), move them to
    ``device`` (default CUDA; see ``resolve_device``) and return
    ``(classify, generate)``. The Generator's phase kernels and the ZCA
    arrays in the compute dtype are built here, once."""
    dev = resolve_device(device)
    gen, clf = nets
    gen.load_state_dict(state["gen"])
    clf.load_state_dict(state["clf"])
    gen.to(dev).eval()
    clf.to(dev).eval()
    cdt = compute_dtype(cfg)
    rescale = bool(cfg.get("rescale", True))
    if zca_stats is not None:
        zm = torch.as_tensor(zca_stats.mean, device=dev).to(cdt)
        zw = torch.as_tensor(zca_stats.whiten, device=dev).to(cdt)
    else:
        zm = zw = None
    with torch.no_grad():
        phase = gen.phase_kernels()

    def classify(images_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = ondevice.standard_pipeline(
                images_u8.to(dev), zca_mean=zm, zca_whiten=zw, dtype=cdt, do_rescale=rescale,
            )
            return clf(x).float()

    def generate(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return gen(z.to(dev), y.to(dev), phase=phase)

    return classify, generate
