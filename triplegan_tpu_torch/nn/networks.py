"""The Generator and Classifier as eval-mode ``nn.Module``s.

Each mirrors its namesake in ``triplegan_tpu/nn/networks.py`` at
``train=False``. Submodules carry the JAX dict keys (``dense``, ``bn0``,
``deconv0``, …, ``deconv_out``; ``b0c0``, ``b0c0_bn``, …, ``t0``,
``t0_bn``, ``head``) and hold their arrays under JAX's names: ``w``/``v``,
``g``, ``b`` for weights, ``scale``/``bias`` parameters and ``mean``/``var``
buffers for batch norm. So a module's ``state_dict`` keys read
``<layer>.<array>``, the JAX export's ``params/<player>/<layer>/<array>``
and ``bn/<player>/<layer>/<array>`` with the player dropped.

Inputs and images are NHWC. ``use_pallas`` routes every epilogue through
the Hopper ``scale_bias_act`` kernel (its plain version on the CPU). The
Discriminator, train mode, noise and dropout come with the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from triplegan_tpu_torch.nn import layers as L


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


class Generator(nn.Module):
    """z ⊕ onehot(y) → dense → s0×s0×W0 → BN+ReLU → stride-2 deconvs with
    BN+ReLU → weight-norm output deconv → tanh; NHWC images in [-1, 1].
    The output dtype follows z."""

    def __init__(self, image_size: int = 32, channels: int = 3, num_classes: int = 10,
                 z_dim: int = 100, widths: Tuple[int, ...] = (512, 256, 128), kernel: int = 5,
                 use_pallas: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.image_size, self.channels, self.num_classes = image_size, channels, num_classes
        self.z_dim, self.widths, self.kernel = z_dim, tuple(widths), kernel
        self.use_pallas = use_pallas
        gen = _default_gen(generator)
        s0 = self.base_size
        self.dense = Layer(L.dense_init(gen, z_dim + num_classes, s0 * s0 * self.widths[0]))
        self.bn0 = Layer(*L.batchnorm_init(self.widths[0]))
        prev = self.widths[0]
        for i, w in enumerate(self.widths[1:]):
            self.add_module(f"deconv{i}", Layer(L.deconv2d_init(gen, prev, w, kernel=kernel)))
            self.add_module(f"bn{i + 1}", Layer(*L.batchnorm_init(w)))
            prev = w
        self.deconv_out = Layer(
            L.deconv2d_init(gen, prev, channels, kernel=kernel, weight_norm=True)
        )

    @property
    def base_size(self) -> int:
        s0 = self.image_size // (2 ** len(self.widths))
        if s0 * (2 ** len(self.widths)) != self.image_size:
            raise ValueError(
                f"image_size {self.image_size} not divisible by 2^{len(self.widths)}"
            )
        return s0

    def phase_kernels(self) -> Dict[str, torch.Tensor]:
        """Each deconv's subpixel phase kernel, in float32, from the current
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

    def forward(self, z: torch.Tensor, y: torch.Tensor,
                phase: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        phase = phase or {}
        s0 = self.base_size
        y1h = L.onehot(y, self.num_classes, dtype=z.dtype)
        h = L.dense_apply(self.dense.tensors(), torch.cat([z, y1h], dim=-1))
        h = h.reshape(h.shape[0], s0, s0, self.widths[0])
        bn = self.bn0.tensors()
        h = L.batchnorm_act_apply(bn, bn, h, act="relu", use_pallas=self.use_pallas)
        for i in range(len(self.widths) - 1):
            name = f"deconv{i}"
            h = L.deconv2d_apply(getattr(self, name).tensors(), h, stride=2, wp=phase.get(name))
            bn = getattr(self, f"bn{i + 1}").tensors()
            h = L.batchnorm_act_apply(bn, bn, h, act="relu", use_pallas=self.use_pallas)
        return L.deconv2d_wn_act_apply(
            self.deconv_out.tensors(), h, stride=2, act="tanh",
            use_pallas=self.use_pallas, wp=phase.get("deconv_out"),
        )


class Classifier(nn.Module):
    """p(y|x) "conv-large": conv blocks with BN + leaky-ReLU(0.1) and a 2×2
    max pool after each block, a 3×3 VALID conv and NiN 1×1 tail with BN +
    leaky-ReLU, global average pool, dense head. Returns logits in x's
    dtype."""

    def __init__(self, image_size: int = 32, channels: int = 3, num_classes: int = 10,
                 conv_blocks: Tuple[Tuple[int, ...], ...] = ((128, 128, 128), (256, 256, 256)),
                 tail: Tuple[int, ...] = (512, 256, 128), lrelu_slope: float = 0.1,
                 use_pallas: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.image_size, self.channels, self.num_classes = image_size, channels, num_classes
        self.conv_blocks = tuple(tuple(b) for b in conv_blocks)
        self.tail = tuple(tail)
        self.lrelu_slope = lrelu_slope
        self.use_pallas = use_pallas
        gen = _default_gen(generator)
        in_ch = channels
        for bi, block in enumerate(self.conv_blocks):
            for ci, w in enumerate(block):
                self._add_conv_bn(f"b{bi}c{ci}", gen, in_ch, w, 3)
                in_ch = w
        for ti, w in enumerate(self.tail):
            self._add_conv_bn(f"t{ti}", gen, in_ch, w, 3 if ti == 0 else 1)
            in_ch = w
        self.head = Layer(L.dense_init(gen, in_ch, num_classes))

    def _add_conv_bn(self, name, gen, in_ch, out_ch, kernel):
        self.add_module(name, Layer(L.conv2d_init(gen, in_ch, out_ch, kernel=kernel, use_bias=False)))
        self.add_module(f"{name}_bn", Layer(*L.batchnorm_init(out_ch)))

    def _conv_bn_act(self, name: str, h: torch.Tensor, padding: str) -> torch.Tensor:
        h = L.conv2d_apply(getattr(self, name).tensors(), h, padding=padding)
        bn = getattr(self, f"{name}_bn").tensors()
        return L.batchnorm_act_apply(
            bn, bn, h, act="leaky_relu", slope=self.lrelu_slope, use_pallas=self.use_pallas
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for bi, block in enumerate(self.conv_blocks):
            for ci in range(len(block)):
                h = self._conv_bn_act(f"b{bi}c{ci}", h, "SAME")
            h = L.max_pool(h)
        for ti in range(len(self.tail)):
            h = self._conv_bn_act(f"t{ti}", h, "VALID" if ti == 0 else "SAME")
        h = L.global_avg_pool(h)
        return L.dense_apply(self.head.tensors(), h)
