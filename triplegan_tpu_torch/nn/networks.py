"""The three Triple-GAN players as ``nn.Module``s with a functional core.

Each mirrors its namesake in ``triplegan_tpu/nn/networks.py``:

* ``init(gen) -> (params, stats)`` draws fresh weights from a
  ``torch.Generator`` (JAX's shapes and scales);
* ``apply(params, stats, ..., train, generator) -> (out, new_stats)`` is the
  pure function of the JAX ``apply``: ``params`` and ``stats`` are nested
  dicts ``{layer: {array: tensor}}`` under the JAX names, ``stats`` holds the
  batch-norm running statistics, and ``generator`` feeds the Gaussian noise
  and dropout of train mode (none: they are off). In train mode batch norm
  normalizes with the batch moments and returns advanced running stats;
  nothing is written in place, so the train step decides whose stats are
  kept. G's and C's ``apply`` take a ``mesh`` (``parallel/mesh.py``), JAX's
  ``axis_name``: their batch norms then sync their moments over its ranks
  (in the kernel arm the synced moments fold into the epilogue's k and b).
* ``forward`` is eval mode on the module's own tensors (the serving path).

Submodules carry the JAX dict keys (Generator ``dense``, ``bn0``,
``deconv0``, …, ``deconv_out``; Discriminator ``conv0`` … ``conv5``,
``head``; Classifier ``b0c0``, ``b0c0_bn``, …, ``t0``, ``t0_bn``, ``head``)
and hold their arrays under JAX's names: ``w``/``v``, ``g``, ``b`` for
weights, ``scale``/``bias`` parameters and ``mean``/``var`` buffers for batch
norm. So a module's ``state_dict`` keys read ``<layer>.<array>``, the JAX
export's ``params/<player>/<layer>/<array>`` and ``bn/<player>/<layer>/<array>``
with the player dropped.

Inputs and images are NHWC. ``use_pallas`` routes every epilogue through
the Hopper ``scale_bias_act`` kernel and every 3×3 stride-1 conv through
the Hopper conv kernels (their plain versions on the CPU).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from triplegan_tpu_torch import bridge
from triplegan_tpu_torch.nn import layers as L

Tree = Dict[str, Dict[str, torch.Tensor]]


class Layer(nn.Module):
    """One JAX layer dict: its parameters and, for batch norm, its running
    statistics as buffers, each under the JAX array name."""

    def __init__(self, params: Dict[str, torch.Tensor], buffers: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        for name, t in params.items():
            self.register_parameter(name, nn.Parameter(t))
        for name, t in (buffers or {}).items():
            self.register_buffer(name, t)

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {
            **dict(self.named_parameters(recurse=False)),
            **dict(self.named_buffers(recurse=False)),
        }


def _default_gen(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class _Player(nn.Module):
    """Builds its ``Layer`` submodules from ``init`` and splits them back
    into (params, stats) trees for ``apply``."""

    def _build(self, generator: Optional[torch.Generator]):
        params, stats = self.init(_default_gen(generator))
        for name, p in params.items():
            self.add_module(name, Layer(p, stats.get(name)))

    def trees(self) -> Tuple[Tree, Tree]:
        """The module's own tensors (not copies) as (params, stats) trees."""
        return bridge.nested(self.state_dict(keep_vars=True))


# ===========================================================================
# Generator
# ===========================================================================


class Generator(_Player):
    """z ⊕ onehot(y) → dense → s0×s0×W0 → BN+ReLU → stride-2 deconvs with
    BN+ReLU → weight-norm output deconv → tanh; NHWC images in [-1, 1].
    The output dtype follows z."""

    def __init__(self, image_size: int = 32, channels: int = 3, num_classes: int = 10,
                 z_dim: int = 100, widths: Tuple[int, ...] = (512, 256, 128), kernel: int = 5,
                 bn_momentum: float = 0.99, use_pallas: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.image_size, self.channels, self.num_classes = image_size, channels, num_classes
        self.z_dim, self.widths, self.kernel = z_dim, tuple(widths), kernel
        self.bn_momentum = bn_momentum
        self.use_pallas = use_pallas
        self._build(generator)

    @property
    def base_size(self) -> int:
        s0 = self.image_size // (2 ** len(self.widths))
        if s0 * (2 ** len(self.widths)) != self.image_size:
            raise ValueError(
                f"image_size {self.image_size} not divisible by 2^{len(self.widths)}"
            )
        return s0

    def init(self, gen: torch.Generator) -> Tuple[Tree, Tree]:
        s0 = self.base_size
        params: Tree = {}
        stats: Tree = {}
        params["dense"] = L.dense_init(gen, self.z_dim + self.num_classes, s0 * s0 * self.widths[0])
        params["bn0"], stats["bn0"] = L.batchnorm_init(self.widths[0])
        prev = self.widths[0]
        for i, w in enumerate(self.widths[1:]):
            params[f"deconv{i}"] = L.deconv2d_init(gen, prev, w, kernel=self.kernel)
            params[f"bn{i + 1}"], stats[f"bn{i + 1}"] = L.batchnorm_init(w)
            prev = w
        params["deconv_out"] = L.deconv2d_init(gen, prev, self.channels, kernel=self.kernel,
                                               weight_norm=True)
        return params, stats

    def phase_kernels(self) -> Dict[str, torch.Tensor]:
        """Each deconv's subpixel phase kernel, in float32, from the module's
        weights: build once after loading and pass to ``forward``. The
        output deconv convolves raw ``v`` under ``use_pallas`` (the norm
        goes into the epilogue) and the normalized kernel otherwise."""
        out = {
            f"deconv{i}": L.phase_kernel(getattr(self, f"deconv{i}").w, 2)
            for i in range(len(self.widths) - 1)
        }
        p = self.deconv_out.tensors()
        w = p["v"] if self.use_pallas else L._wn_kernel(p["v"], p["g"], (0, 1, 2))
        out["deconv_out"] = L.phase_kernel(w, 2)
        return out

    def apply(self, params: Tree, stats: Tree, z: torch.Tensor, y: torch.Tensor, *,
              train: bool, phase: Optional[Dict[str, torch.Tensor]] = None, mesh=None):
        phase = phase or {}
        s0 = self.base_size
        bn = dict(train=train, act="relu", momentum=self.bn_momentum, use_pallas=self.use_pallas,
                  mesh=mesh)
        y1h = L.onehot(y, self.num_classes, dtype=z.dtype)
        h = L.dense_apply(params["dense"], torch.cat([z, y1h], dim=-1))
        h = h.reshape(h.shape[0], s0, s0, self.widths[0])
        new_stats: Tree = {}
        h, new_stats["bn0"] = L.batchnorm_act_apply(params["bn0"], stats["bn0"], h, **bn)
        for i in range(len(self.widths) - 1):
            name = f"deconv{i}"
            h = L.deconv2d_apply(params[name], h, stride=2, wp=phase.get(name),
                                 use_pallas=self.use_pallas)
            h, new_stats[f"bn{i + 1}"] = L.batchnorm_act_apply(
                params[f"bn{i + 1}"], stats[f"bn{i + 1}"], h, **bn)
        h = L.deconv2d_wn_act_apply(params["deconv_out"], h, stride=2, act="tanh",
                                    use_pallas=self.use_pallas, wp=phase.get("deconv_out"))
        return h, new_stats

    def forward(self, z: torch.Tensor, y: torch.Tensor,
                phase: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        return self.apply(*self.trees(), z, y, train=False, phase=phase)[0]


# ===========================================================================
# Discriminator
# ===========================================================================


class Discriminator(_Player):
    """D(x, y) → real-pair logit: label planes concatenated at the input,
    Gaussian noise and dropout, weight-norm convs with leaky-ReLU(0.2),
    dropout after each stride-2 conv and the label planes concatenated
    again there (``label_reconcat``), global average pool ⊕ onehot(y),
    weight-norm dense head. No batch norm, so its stats are empty."""

    def __init__(self, image_size: int = 32, channels: int = 3, num_classes: int = 10,
                 widths: Tuple[int, ...] = (32, 32, 64, 64, 128, 128),
                 strides: Tuple[int, ...] = (1, 2, 1, 2, 1, 2), kernel: int = 3,
                 input_noise: float = 0.05, input_dropout: float = 0.2,
                 block_dropout: float = 0.2, lrelu_slope: float = 0.2,
                 label_reconcat: bool = True, use_pallas: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(widths) != len(strides):
            raise ValueError(f"{len(widths)} widths but {len(strides)} strides")
        self.image_size, self.channels, self.num_classes = image_size, channels, num_classes
        self.widths, self.strides, self.kernel = tuple(widths), tuple(strides), kernel
        self.input_noise, self.input_dropout = input_noise, input_dropout
        self.block_dropout, self.lrelu_slope = block_dropout, lrelu_slope
        self.label_reconcat = label_reconcat
        self.use_pallas = use_pallas
        self._build(generator)

    def init(self, gen: torch.Generator) -> Tuple[Tree, Tree]:
        params: Tree = {}
        in_ch = self.channels + self.num_classes
        for i, (w, s) in enumerate(zip(self.widths, self.strides)):
            params[f"conv{i}"] = L.conv2d_init(gen, in_ch, w, kernel=self.kernel, weight_norm=True)
            in_ch = w
            if s == 2 and self.label_reconcat and i + 1 < len(self.widths):
                in_ch += self.num_classes
        params["head"] = L.dense_init(gen, self.widths[-1] + self.num_classes, 1, weight_norm=True)
        return params, {}

    def apply(self, params: Tree, stats: Tree, x: torch.Tensor, y: torch.Tensor, *,
              train: bool, generator: Optional[torch.Generator] = None):
        y1h = L.onehot(y, self.num_classes, dtype=x.dtype)
        h = L.label_concat_spatial(x, y1h)
        h = L.gaussian_noise(generator, h, self.input_noise, train=train)
        h = L.dropout(generator, h, self.input_dropout, train=train)
        for i, s in enumerate(self.strides):
            h = L.conv2d_wn_act_apply(params[f"conv{i}"], h, stride=s, act="leaky_relu",
                                      slope=self.lrelu_slope, use_pallas=self.use_pallas)
            if s == 2:
                h = L.dropout(generator, h, self.block_dropout, train=train)
                if self.label_reconcat and i + 1 < len(self.widths):
                    h = L.label_concat_spatial(h, y1h)
        h = torch.cat([L.global_avg_pool(h), y1h], dim=-1)
        return L.dense_apply(params["head"], h)[:, 0], stats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.apply(*self.trees(), x, y, train=False)[0]


# ===========================================================================
# Classifier
# ===========================================================================


class Classifier(_Player):
    """p(y|x) "conv-large": Gaussian input noise, conv blocks with BN +
    leaky-ReLU(0.1), a 2×2 max pool and dropout after each block, a 3×3
    VALID conv and NiN 1×1 tail with BN + leaky-ReLU, global average pool,
    dense head. Returns logits in x's dtype."""

    def __init__(self, image_size: int = 32, channels: int = 3, num_classes: int = 10,
                 conv_blocks: Tuple[Tuple[int, ...], ...] = ((128, 128, 128), (256, 256, 256)),
                 tail: Tuple[int, ...] = (512, 256, 128), input_noise: float = 0.15,
                 block_dropout: float = 0.5, lrelu_slope: float = 0.1,
                 bn_momentum: float = 0.99, use_pallas: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.image_size, self.channels, self.num_classes = image_size, channels, num_classes
        self.conv_blocks = tuple(tuple(b) for b in conv_blocks)
        self.tail = tuple(tail)
        self.input_noise, self.block_dropout = input_noise, block_dropout
        self.lrelu_slope, self.bn_momentum = lrelu_slope, bn_momentum
        self.use_pallas = use_pallas
        self._build(generator)

    def init(self, gen: torch.Generator) -> Tuple[Tree, Tree]:
        params: Tree = {}
        stats: Tree = {}
        in_ch = self.channels

        def conv_bn(name, out_ch, kernel):
            params[name] = L.conv2d_init(gen, in_ch, out_ch, kernel=kernel, use_bias=False)
            params[f"{name}_bn"], stats[f"{name}_bn"] = L.batchnorm_init(out_ch)

        for bi, block in enumerate(self.conv_blocks):
            for ci, w in enumerate(block):
                conv_bn(f"b{bi}c{ci}", w, 3)
                in_ch = w
        for ti, w in enumerate(self.tail):
            conv_bn(f"t{ti}", w, 3 if ti == 0 else 1)
            in_ch = w
        params["head"] = L.dense_init(gen, in_ch, self.num_classes)
        return params, stats

    def apply(self, params: Tree, stats: Tree, x: torch.Tensor, *, train: bool,
              generator: Optional[torch.Generator] = None, mesh=None):
        new_stats: Tree = {}

        def conv_bn_act(name, h, padding):
            h = L.conv2d_apply(params[name], h, padding=padding, use_pallas=self.use_pallas)
            h, new_stats[f"{name}_bn"] = L.batchnorm_act_apply(
                params[f"{name}_bn"], stats[f"{name}_bn"], h, train=train, act="leaky_relu",
                slope=self.lrelu_slope, momentum=self.bn_momentum, use_pallas=self.use_pallas,
                mesh=mesh)
            return h

        h = L.gaussian_noise(generator, x, self.input_noise, train=train)
        for bi, block in enumerate(self.conv_blocks):
            for ci in range(len(block)):
                h = conv_bn_act(f"b{bi}c{ci}", h, "SAME")
            h = L.max_pool(h)
            h = L.dropout(generator, h, self.block_dropout, train=train)
        for ti in range(len(self.tail)):
            h = conv_bn_act(f"t{ti}", h, "VALID" if ti == 0 else "SAME")
        return L.dense_apply(params["head"], L.global_avg_pool(h)), new_stats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(*self.trees(), x, train=False)[0]
