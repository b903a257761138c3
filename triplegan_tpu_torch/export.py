"""Serving export: a trained run's two servable functions, in process and as
deployable artifacts. The port of ``triplegan_tpu/export.py``.

  * ``classify(images_u8) -> logits``: the eval-mode classifier with the
    training-time input transform inside (rescale to [-1, 1], ZCA for zca
    configs) in the config's compute dtype; float32 logits out.
  * ``generate(z, y) -> images``: the eval-mode generator in z's dtype (the
    server sends float32 z, so the generator stays float32 at a bfloat16
    config, as in the JAX package), raw [-1, 1] NHWC images out.

Both are ``nn.Module``s (``ClassifyModule``, ``GenerateModule``) holding the
weights as buffers and calling the networks' ``apply``; ``make_serving_fns``
runs them under ``torch.inference_mode()``, and ``export_pt2`` traces them.

Formats:

  * ``pt2``: ``torch.export`` of a module at a static batch (JAX's export is
    static too), saved by ``torch.export.save``. The program records the
    port's operators (``torch.ops.triplegan_torch.scale_bias_act`` and
    ``conv3x3_fwd``, ``ops/``), so on the card it launches the hand-written
    kernels, and on the CPU their plain versions. ``load_pt2`` moves an
    artifact to another device (``move_to_device_pass``): one exported on
    the card runs on the CPU, the counterpart of JAX exporting for cpu and
    tpu at once.
  * ``npz``: every player's parameters and batch-norm statistics in the JAX
    package's keys and layouts (``params/<player>/<layer>/<array>``, conv
    kernels HWIO), which the JAX package and ``bridge.load_npz`` read.

``quantize="int8"`` is weight-only post-training quantization: the
artifact stores int8 kernels and their float32 scales, and the served
function multiplies them out on each call.
"""

from __future__ import annotations

import json
import os
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from triplegan_tpu_torch import bridge
from triplegan_tpu_torch.configs.base import arch
from triplegan_tpu_torch.data import ondevice
from triplegan_tpu_torch.utils.platform import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_META = "triplegan_meta.json"  # the artifact's extra file: kind, batch, config, quantize


def compute_dtype(cfg) -> torch.dtype:
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {cfg.compute_dtype!r}")
    return _DTYPES[cfg.compute_dtype]


class QTensor(NamedTuple):
    """A weight quantized to int8: ``q * scale`` reconstructs it. ``scale``
    is float32, one per output channel, shaped to broadcast against q."""

    q: torch.Tensor
    scale: torch.Tensor


def _out_axis(player: str, t: torch.Tensor) -> int:
    """The output-channel axis of a kernel in the port's layout: 0 for the
    OIHW conv kernels of D and C, the last axis for dense (in, out) and
    the generator's (k, k, in, out) kernels; JAX's last axis in each case
    (``bridge.py``)."""
    return 0 if t.dim() == 4 and player not in bridge._DECONV_PLAYERS else t.dim() - 1


def quantize_int8(state: dict) -> dict:
    """Weight-only PTQ of ``{player: state_dict}``: every tensor of two or
    more dimensions becomes a ``QTensor``, symmetric per output channel with
    max|w| mapped to 127 and round-to-nearest-even (error ≤ scale/2 an
    element); biases, gains and batch-norm arrays stay float32. Computed on
    the host in float32 with the JAX package's operations, so q and scale
    equal JAX's ``quantize_int8`` of the bridged weights bitwise."""
    out = {}
    for player, sd in state.items():
        enc = {}
        for key, t in sd.items():
            if t.dim() < 2:
                enc[key] = t
                continue
            w = t.detach().to("cpu", torch.float32)
            axis = _out_axis(player, w)
            amax = w.abs().amax(dim=[d for d in range(w.dim()) if d != axis], keepdim=True)
            scale = torch.clamp_min(amax, 1e-12) / 127.0
            q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
            enc[key] = QTensor(q.to(t.device), scale.to(t.device))
        out[player] = enc
    return out


def dequantize(state: dict, dtype=torch.float32) -> dict:
    """The inverse of :func:`quantize_int8`: ``q·scale`` in ``dtype``."""
    return {player: {key: (v.q.to(dtype) * v.scale.to(dtype) if isinstance(v, QTensor) else v)
                     for key, v in sd.items()}
            for player, sd in state.items()}


def serving_state(state) -> dict:
    """``{"gen", "clf"}`` state dicts of a ``TrainState`` (restored from a
    checkpoint); a dict of state dicts as it is."""
    if isinstance(state, dict):
        return state
    return {p: bridge.flat(state.params[p], state.bn[p]) for p in ("gen", "clf")}


class _Weights(nn.Module):
    """One player's state dict as buffers (``<layer>__<array>``; a QTensor
    as ``..__q`` and ``..__scale``), handed back as (params, stats) trees,
    int8 kernels multiplied out to float32 on each call."""

    def __init__(self, sd: dict, device: torch.device):
        super().__init__()
        self.entries = []
        for key, v in sd.items():
            name = key.replace(".", "__")
            # contiguous copies: a saved program stores each buffer's own bytes
            if isinstance(v, QTensor):
                self.register_buffer(name + "__q", v.q.to(device).contiguous())
                self.register_buffer(name + "__scale", v.scale.to(device, torch.float32).contiguous())
            else:
                self.register_buffer(name, v.detach().to(device, torch.float32)
                                     .clone(memory_format=torch.contiguous_format))
            self.entries.append((key, name, isinstance(v, QTensor)))

    def trees(self):
        sd = {}
        for key, name, quantized in self.entries:
            if quantized:
                sd[key] = getattr(self, name + "__q").to(torch.float32) * getattr(self, name + "__scale")
            else:
                sd[key] = getattr(self, name)
        return bridge.nested(sd)


class ClassifyModule(nn.Module):
    """``images_u8 -> float32 logits``: the eval path's input transform and
    the eval-mode classifier (``nn/networks.py`` ``Classifier.apply``, whose
    module holds no weights here: only its layout)."""

    def __init__(self, cfg, clf, sd: dict, zca_stats=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        object.__setattr__(self, "net", clf)  # not a submodule: its own tensors are not served
        self.weights = _Weights(sd, dev)
        self.cdt = compute_dtype(cfg)
        self.rescale = bool(cfg.get("rescale", True))
        if zca_stats is not None:
            self.register_buffer("zca_mean", torch.as_tensor(zca_stats.mean, device=dev).to(self.cdt))
            self.register_buffer("zca_whiten", torch.as_tensor(zca_stats.whiten, device=dev).to(self.cdt))
        else:
            self.zca_mean = self.zca_whiten = None

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        x = ondevice.standard_pipeline(images_u8, zca_mean=self.zca_mean, zca_whiten=self.zca_whiten,
                                       dtype=self.cdt, do_rescale=self.rescale)
        logits, _ = self.net.apply(*self.weights.trees(), x, train=False)
        return logits.float()


class GenerateModule(nn.Module):
    """``(z, y) -> images``: the eval-mode generator in z's dtype, its
    deconvs' phase kernels built from the (multiplied-out) weights."""

    def __init__(self, gen, sd: dict, device=None):
        super().__init__()
        from triplegan_tpu_torch.nn import layers as L

        dev = resolve_device(device)
        object.__setattr__(self, "net", gen)
        self.weights = _Weights(sd, dev)
        # the phase kernels' gather index is cached per device: made here,
        # outside any trace, so that a trace reads it as a constant
        L._phase_index(gen.kernel, 2, next(self.weights.buffers()).device)

    def forward(self, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.net.apply(*self.weights.trees(), z, y, train=False)[0]


_ARCH_NAMES = {"snresnet": "the SN-ResNet G and D", "stylegan2": "the StyleGAN2 G and D"}


def check_servable(cfg) -> None:
    """Raise unless ``cfg``'s networks serve and export: the conv networks
    do; the SN-ResNet pair (``arch`` snresnet) and the StyleGAN2 pair
    (``stylegan2``) do not yet."""
    if arch(cfg) != "conv":
        raise ValueError(f"serving and .pt2 export take the conv networks; {cfg.name} has arch {arch(cfg)!r} "
                         f"({_ARCH_NAMES[arch(cfg)]})")


def serving_modules(cfg, nets, state, zca_stats=None, device=None, quantize: Optional[str] = None):
    """(ClassifyModule, GenerateModule) of ``state`` (a ``TrainState`` or
    ``{"gen", "clf"}`` state dicts, see ``bridge.py``) on ``device``
    (default the card; see ``resolve_device``), int8-quantized with
    ``quantize="int8"``."""
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    check_servable(cfg)
    st = serving_state(state)
    st = {p: st[p] for p in ("gen", "clf")}
    if quantize:
        st = quantize_int8(st)
    gen, _, clf = nets
    return (ClassifyModule(cfg, clf, st["clf"], zca_stats, device),
            GenerateModule(gen, st["gen"], device))


def make_serving_fns(cfg, nets, state, zca_stats=None, device=None,
                     quantize: Optional[str] = None) -> Tuple[Callable, Callable]:
    """``(classify, generate)`` over ``state`` on ``device`` (default the
    card), tensors in and out, run under ``torch.inference_mode()``; their
    inputs are moved to the device. ``quantize="int8"`` serves the
    weight-only PTQ variant (:func:`quantize_int8`) of both players."""
    cmod, gmod = serving_modules(cfg, nets, state, zca_stats, device, quantize)
    dev = next(cmod.weights.buffers()).device

    def classify(images_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return cmod(images_u8.to(dev))

    def generate(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return gmod(z.to(dev), y.to(dev))

    return classify, generate


# ---- the traced artifact ----


def export_pt2(module: nn.Module, example_args: tuple, path: str, meta: Optional[dict] = None) -> str:
    """``torch.export`` of ``module`` at the shapes and dtypes of
    ``example_args`` (static), saved to ``path`` with ``meta`` as JSON
    beside the program. Reload with :func:`load_pt2`."""
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args))
    torch.export.save(program, path, extra_files={_META: json.dumps(meta or {})})
    return path


class Pt2Artifact:
    """A loaded artifact: call it with tensors (or arrays), moved to its
    device, under ``torch.inference_mode()``. ``in_specs`` is its input
    contract, ((shape, dtype), ...) per user input (JAX's ``in_avals``);
    ``meta`` what the exporter wrote; ``program`` the ``ExportedProgram``."""

    def __init__(self, program, meta: dict, device: torch.device):
        self.program, self.meta, self.device = program, meta, device
        self.module = program.module()
        vals = {n.name: n.meta["val"] for n in program.graph.nodes if n.op == "placeholder"}
        self.in_specs = tuple((tuple(int(d) for d in vals[s.arg.name].shape), vals[s.arg.name].dtype)
                              for s in program.graph_signature.input_specs
                              if s.kind == torch.export.graph_signature.InputKind.USER_INPUT)

    def __call__(self, *args) -> torch.Tensor:
        with torch.inference_mode():
            return self.module(*(torch.as_tensor(a).to(self.device) for a in args))


def _program_device(program) -> torch.device:
    for n in program.graph.nodes:
        if n.op == "placeholder":
            return n.meta["val"].device
    raise ValueError("the exported program has no inputs")


def load_pt2(path: str, device=None) -> Pt2Artifact:
    """Load a :func:`export_pt2` artifact onto ``device`` (default the card;
    ``"cpu"`` for the CPU). The port's operators are registered first; an
    artifact exported on another device is moved with
    ``torch.export.passes.move_to_device_pass``, and a failed move raises."""
    from torch.export.passes import move_to_device_pass

    from triplegan_tpu_torch.ops import conv3x3, scale_bias_act  # noqa: F401 (the operators)

    dev = resolve_device(device)
    extra = {_META: ""}
    program = torch.export.load(path, extra_files=extra)
    if _program_device(program) != dev:
        program = move_to_device_pass(program, dev)
    return Pt2Artifact(program, json.loads(extra[_META] or "{}"), dev)


# ---- the npz interchange ----


def export_npz(state, path: str) -> str:
    """Every player's parameters and batch-norm statistics of ``state`` (a
    ``TrainState``, or ``{player: state_dict}``) under the JAX package's
    ``export_npz`` keys and layouts (``bridge.to_jax``: conv kernels HWIO)."""
    if not isinstance(state, dict):
        state = {p: bridge.flat(state.params[p], state.bn[p]) for p in state.params}
    flat = {}
    for kind, tree in zip(("params", "bn"), bridge.to_jax(state)):
        for player, layers in tree.items():
            for layer, arrays in layers.items():
                for name, a in arrays.items():
                    flat[f"{kind}/{player}/{layer}/{name}"] = a
    np.savez(path, **flat)
    return path


def export_artifacts(cfg, nets, state, out_dir: str, what: str = "both", fmt: str = "pt2",
                     batch_size: Optional[int] = None, zca_stats=None, quantize: Optional[str] = None,
                     device=None) -> list:
    """Export the requested servables of ``state`` into ``out_dir``; the
    paths written. ``what``: classifier|generator|both (``classify.pt2``,
    ``generate.pt2``); ``fmt``: pt2|npz (``params.npz``). A pt2 artifact is
    traced on ``device`` (default the card) at the static batch
    ``batch_size`` (default ``cfg.batch_size``); ``quantize="int8"`` stores
    int8 kernels in it."""
    if fmt in ("stablehlo", "savedmodel"):
        raise ValueError(f"fmt {fmt!r} is the JAX package's; the port exports pt2 "
                         f"(torch.export) or npz")
    if fmt not in ("pt2", "npz"):
        raise ValueError(f"fmt must be pt2|npz, got {fmt!r}")
    if quantize and fmt == "npz":
        raise ValueError("quantize applies to traced artifacts (pt2); npz stores the raw f32 parameters")
    if what not in ("classifier", "generator", "both"):
        raise ValueError(f"what must be classifier|generator|both, got {what!r}")
    os.makedirs(out_dir, exist_ok=True)
    if fmt == "npz":
        return [export_npz(state, os.path.join(out_dir, "params.npz"))]
    b = int(batch_size or cfg.batch_size)
    cmod, gmod = serving_modules(cfg, nets, state, zca_stats, device, quantize)
    dev = next(cmod.weights.buffers()).device
    meta = {"config": cfg.name, "batch": b, "quantize": quantize, "compute_dtype": cfg.compute_dtype,
            "use_pallas": bool(cfg.use_pallas), "device": str(dev)}
    size, ch = int(cfg.image_size), int(cfg.channels)
    written = []
    if what in ("classifier", "both"):
        img = torch.zeros((b, size, size, ch), dtype=torch.uint8, device=dev)
        written.append(export_pt2(cmod, (img,), os.path.join(out_dir, "classify.pt2"),
                                  {**meta, "kind": "classify"}))
    if what in ("generator", "both"):
        z = torch.zeros((b, int(cfg.z_dim)), dtype=torch.float32, device=dev)
        y = torch.zeros((b,), dtype=torch.int32, device=dev)
        written.append(export_pt2(gmod, (z, y), os.path.join(out_dir, "generate.pt2"),
                                  {**meta, "kind": "generate"}))
    return written
