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
* ``forward`` is eval mode on the module's own tensors.

Submodules carry the JAX dict keys (Generator ``dense``, ``bn0``,
``deconv0``, …, ``deconv_out``; Discriminator ``conv0`` … ``conv5``,
``head``; Classifier ``b0c0``, ``b0c0_bn``, …, ``t0``, ``t0_bn``, ``head``)
and hold their arrays under JAX's names: ``w``/``v``, ``g``, ``b`` for
weights, ``scale``/``bias`` parameters and ``mean``/``var`` buffers for batch
norm. So a module's ``state_dict`` keys read ``<layer>.<array>``, the JAX
export's ``params/<player>/<layer>/<array>`` and ``bn/<player>/<layer>/<array>``
with the player dropped.

``ResNetGenerator`` and ``SNResNetDiscriminator`` are the SN-ResNet pair
(``arch = "snresnet"``, ``configs/base.py``), with the same contract; the
discriminator's stats are its power-iteration vectors ``u``, which only
D's own update keeps (``train/step.py``). ``StyleGAN2Generator`` and
``StyleGAN2Discriminator`` are the StyleGAN2 pair (``arch = "stylegan2"``):
G's ``apply`` draws its noise planes from ``generator``, its stats are the
running mean of w and its EMA copy (``ema_update``); D's ``apply`` takes
the number of row streams its minibatch stddev keeps apart.

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

    def apply(self, params: Tree, stats: Tree, z: torch.Tensor, y: torch.Tensor, *,
              train: bool, mesh=None, generator: Optional[torch.Generator] = None):
        """(images, new stats); ``generator`` is taken and not drawn from
        (G has no noise)."""
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
            h = L.deconv2d_apply(params[name], h, stride=2, use_pallas=self.use_pallas)
            h, new_stats[f"bn{i + 1}"] = L.batchnorm_act_apply(
                params[f"bn{i + 1}"], stats[f"bn{i + 1}"], h, **bn)
        h = L.deconv2d_wn_act_apply(params["deconv_out"], h, stride=2, act="tanh",
                                    use_pallas=self.use_pallas)
        return h, new_stats

    def forward(self, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.apply(*self.trees(), z, y, train=False)[0]


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
              generator: Optional[torch.Generator] = None, mesh=None,
              return_features: bool = False):
        """(logits, new stats); with ``return_features`` ((logits, feats),
        new stats), feats the global-average-pooled penultimate activations
        (the built-in FID feature space), as in the JAX package."""
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
        feats = L.global_avg_pool(h)
        logits = L.dense_apply(params["head"], feats)
        if return_features:
            return (logits, feats), new_stats
        return logits, new_stats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(*self.trees(), x, train=False)[0]


# ===========================================================================
# The SN-ResNet pair (Miyato & Koyama, cGANs with Projection Discriminator,
# arXiv:1802.05637; code: pfnet-research/sngan_projection, gen_models/
# resnet_32.py and dis_models/snresnet_32.py)
# ===========================================================================


class ResNetGenerator(_Player):
    """z → dense ``l1`` → s0×s0×W0, then one up-block a width, then BN,
    ReLU, a 3×3 conv ``c5`` to RGB and tanh; NHWC images in [-1, 1]. Up-block
    ``block<i>`` of ``widths[i]`` channels: h = ReLU(cBN ``b1``(x, y)), 2×
    nearest upsample, 3×3 conv ``c1``; h = ReLU(cBN ``b2``(h, y)), 3×3 conv
    ``c2``; plus the shortcut, a 1×1 conv ``c_sc`` of x upsampled. The
    class-conditional batch norms take the integer labels y (no one-hot
    input). The output dtype follows z."""

    def __init__(self, image_size: int = 32, channels: int = 3, num_classes: int = 10,
                 z_dim: int = 128, widths: Tuple[int, ...] = (256, 256, 256), kernel: int = 3,
                 bn_momentum: float = 0.99, use_pallas: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kernel != 3:
            raise ValueError(f"the ResNet generator's convs are 3×3, got kernel {kernel}")
        self.image_size, self.channels, self.num_classes = image_size, channels, num_classes
        self.z_dim, self.widths = z_dim, tuple(widths)
        self.bn_momentum = bn_momentum
        self.use_pallas = use_pallas
        self._build(generator)

    base_size = Generator.base_size

    def init(self, gen: torch.Generator) -> Tuple[Tree, Tree]:
        s0, nc = self.base_size, self.num_classes
        params: Tree = {"l1": L.dense_init(gen, self.z_dim, s0 * s0 * self.widths[0])}
        stats: Tree = {}
        cin = self.widths[0]
        for i, w in enumerate(self.widths):
            blk = f"block{i + 2}"
            params[f"{blk}_b1"], stats[f"{blk}_b1"] = L.cond_batchnorm_init(nc, cin)
            params[f"{blk}_c1"] = L.conv2d_init(gen, cin, w, kernel=3)
            params[f"{blk}_b2"], stats[f"{blk}_b2"] = L.cond_batchnorm_init(nc, w)
            params[f"{blk}_c2"] = L.conv2d_init(gen, w, w, kernel=3)
            params[f"{blk}_c_sc"] = L.conv2d_init(gen, cin, w, kernel=1)
            cin = w
        params["b5"], stats["b5"] = L.batchnorm_init(cin)
        params["c5"] = L.conv2d_init(gen, cin, self.channels, kernel=3)
        return params, stats

    def apply(self, params: Tree, stats: Tree, z: torch.Tensor, y: torch.Tensor, *,
              train: bool, mesh=None, generator: Optional[torch.Generator] = None):
        """(images, new stats); ``generator`` is taken and not drawn from."""
        s0, pallas = self.base_size, self.use_pallas
        bn = dict(train=train, act="relu", momentum=self.bn_momentum, use_pallas=pallas, mesh=mesh)
        h = L.dense_apply(params["l1"], z).reshape(z.shape[0], s0, s0, self.widths[0])
        new_stats: Tree = {}
        for i in range(len(self.widths)):
            blk = f"block{i + 2}"
            t, new_stats[f"{blk}_b1"] = L.cond_batchnorm_act_apply(params[f"{blk}_b1"], stats[f"{blk}_b1"], h, y, **bn)
            t = L.conv2d_apply(params[f"{blk}_c1"], L.upsample2x(t), use_pallas=pallas)
            t, new_stats[f"{blk}_b2"] = L.cond_batchnorm_act_apply(params[f"{blk}_b2"], stats[f"{blk}_b2"], t, y, **bn)
            t = L.conv2d_apply(params[f"{blk}_c2"], t, use_pallas=pallas)
            h = t + L.conv2d_apply(params[f"{blk}_c_sc"], L.upsample2x(h), use_pallas=pallas)
        h, new_stats["b5"] = L.batchnorm_act_apply(params["b5"], stats["b5"], h, **bn)
        return L.conv2d_act_apply(params["c5"], h, act="tanh", use_pallas=pallas), new_stats

    def forward(self, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.apply(*self.trees(), z, y, train=False)[0]


class SNResNetDiscriminator(_Player):
    """D(x, y) → real-pair logit, every weight spectrally normalised (W/σ):
    ``block1``, the optimised block (h = 3×3 ``c1``, ReLU, 3×3 ``c2``, 2×2
    average pool; shortcut a 1×1 ``c_sc`` of x pooled), then ``block2`` … of
    ``widths[1:]`` (h = ReLU, ``c1``, ReLU, ``c2``, pooled where its stride
    is 2; shortcut ``c_sc`` then the pool where it changes the width or
    pools, else x), then ReLU, a sum over H and W, and ``l5``(h) + ⟨``l_y``
    [y], h⟩, the projection. No noise or dropout.

    Its statistics are each layer's power-iteration vector ``u``.
    ``power_iteration(params, stats)`` makes one iteration from the kept u
    of every layer, outside autograd: {layer: (u', v)}. ``apply`` takes
    those (``sn``) or makes them, computes each σ = u'ᵀ·W·v in autograd,
    and returns, in train mode, the stats with u' (the step keeps them from
    D's own update alone), in eval mode the stats it was given."""

    def __init__(self, image_size: int = 32, channels: int = 3, num_classes: int = 10,
                 widths: Tuple[int, ...] = (128, 128, 128, 128), strides: Tuple[int, ...] = (2, 2, 1, 1),
                 use_pallas: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(widths) != len(strides) or any(s not in (1, 2) for s in strides):
            raise ValueError(f"widths {widths} and strides {strides}: one stride (1 or 2) a block")
        self.image_size, self.channels, self.num_classes = image_size, channels, num_classes
        self.widths, self.strides = tuple(widths), tuple(strides)
        self.use_pallas = use_pallas
        self._build(generator)

    def _shortcut_conv(self, i: int, cin: int) -> bool:
        return i == 0 or cin != self.widths[i] or self.strides[i] == 2

    def init(self, gen: torch.Generator) -> Tuple[Tree, Tree]:
        params: Tree = {}
        stats: Tree = {}
        cin = self.channels
        for i, w in enumerate(self.widths):
            blk = f"block{i + 1}"
            layers = [("c1", cin, 3), ("c2", w, 3)] + ([("c_sc", cin, 1)] if self._shortcut_conv(i, cin) else [])
            for name, ci, k in layers:
                params[f"{blk}_{name}"] = L.conv2d_init(gen, ci, w, kernel=k)
                stats[f"{blk}_{name}"] = L.sn_init(gen, w)
            cin = w
        params["l5"] = L.dense_init(gen, cin, 1)
        stats["l5"] = L.sn_init(gen, 1)
        params["l_y"] = {"w": 0.05 * torch.randn(self.num_classes, cin, generator=gen)}
        stats["l_y"] = L.sn_init(gen, self.num_classes)
        return params, stats

    @staticmethod
    def _matrix(name: str, w: torch.Tensor) -> torch.Tensor:
        return L.sn_matrix(w, dense=name == "l5")

    def power_iteration(self, params: Tree, stats: Tree) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        return {name: L.power_iteration(self._matrix(name, params[name]["w"]), s["u"]) for name, s in stats.items()}

    def apply(self, params: Tree, stats: Tree, x: torch.Tensor, y: torch.Tensor, *,
              train: bool, generator: Optional[torch.Generator] = None, sn=None):
        sn = self.power_iteration(params, stats) if sn is None else sn
        sigma = {name: L.sn_sigma(self._matrix(name, params[name]["w"]), u, v) for name, (u, v) in sn.items()}
        pallas = self.use_pallas

        def conv(name, h, act=None):
            return L.sn_conv_act_apply(params[name], sigma[name], h, act=act, use_pallas=pallas)

        h, cin = x, self.channels
        for i, (w, s) in enumerate(zip(self.widths, self.strides)):
            blk = f"block{i + 1}"
            t = conv(f"{blk}_c2", conv(f"{blk}_c1", h if i == 0 else torch.relu(h), act="relu"))
            if s == 2:
                t = L.avg_pool2x(t)
            if not self._shortcut_conv(i, cin):
                sc = h
            elif i == 0:  # the optimised block pools first, then convolves
                sc = conv(f"{blk}_c_sc", L.avg_pool2x(h) if s == 2 else h)
            else:
                sc = conv(f"{blk}_c_sc", h)
                sc = L.avg_pool2x(sc) if s == 2 else sc
            h, cin = t + sc, w
        h = L.global_sum_pool(torch.relu(h))
        l5 = params["l5"]
        out = h @ (l5["w"].to(h.dtype) / sigma["l5"]) + l5["b"].to(h.dtype)
        emb = params["l_y"]["w"][y.long()].to(h.dtype) / sigma["l_y"]
        logit = out[:, 0] + torch.sum(emb * h, dim=-1)
        new_stats = {name: {"u": u} for name, (u, _) in sn.items()} if train else stats
        return logit, new_stats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.apply(*self.trees(), x, y, train=False)[0]


# ===========================================================================
# The StyleGAN2 pair (Karras et al., Analyzing and Improving the Image
# Quality of StyleGAN, arXiv:1912.04958; at StyleGAN2-ADA's cifar
# configuration, arXiv:2006.06676, NVlabs/stylegan2-ada-pytorch train.py
# cfg_specs['cifar'] and training/networks.py)
# ===========================================================================


def _ema_stats(params: Tree) -> Tree:
    """A moving-average copy of every parameter, under its name with
    ``bridge.EMA_SUFFIX``."""
    return {layer: {name + bridge.EMA_SUFFIX: t.clone() for name, t in arrays.items()}
            for layer, arrays in params.items()}


class StyleGAN2Generator(_Player):
    """G(z, y): the mapping, then the skip synthesis. Mapping: x =
    n(z) ⊕ n(``embed``(onehot y)), n the second-moment normalisation, then
    ``map_layers`` dense layers ``map<i>`` (leaky ReLU·√2, lr multiplier
    ``map_lr_mult``) to w, which every layer's style takes. Synthesis, a
    block a resolution from 4 (``widths[i]`` channels at 4·2^i): at 4 the
    learned constant ``b4_const`` and the modulated 3×3 ``b4_conv1``; above,
    the modulated up-conv ``b<r>_conv0`` and ``b<r>_conv1``; each block's
    ``b<r>_torgb`` adds to the image, the image so far FIR-upsampled.
    Every modulated conv draws its noise plane ν ~ N(0, 1) of (N, H, W) from
    ``generator`` in that order (without one, no noise term). NHWC images,
    unbounded but for the clamp, in z's dtype.

    Its statistics: ``map<last>``'s ``w_avg``, the running mean of w,
    advanced by each train-mode call as w_avg ← lerp(mean w, w_avg,
    ``w_avg_beta``) (the step keeps G's own update's); and every
    parameter's moving average, G's EMA copy (``<name>_ema``), which
    ``ema_update`` advances and ``apply`` does not read."""

    def __init__(self, image_size: int = 32, channels: int = 3, num_classes: int = 10, z_dim: int = 512,
                 w_dim: int = 512, widths: Tuple[int, ...] = (512, 512, 512, 512), map_layers: int = 2,
                 map_lr_mult: float = 0.01, w_avg_beta: float = 0.995, conv_clamp: float = 256.0,
                 noise_init: float = 0.1, use_pallas: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size != 4 * 2 ** (len(widths) - 1):
            raise ValueError(f"{len(widths)} blocks from 4x4 make {4 * 2 ** (len(widths) - 1)}, not {image_size}")
        self.image_size, self.channels, self.num_classes = image_size, channels, num_classes
        self.z_dim, self.w_dim, self.widths = z_dim, w_dim, tuple(widths)
        self.map_layers, self.map_lr_mult, self.w_avg_beta = map_layers, map_lr_mult, w_avg_beta
        self.conv_clamp, self.noise_init = conv_clamp, noise_init
        self.use_pallas = use_pallas
        self._build(generator)

    @property
    def resolutions(self) -> Tuple[int, ...]:
        return tuple(4 * 2 ** i for i in range(len(self.widths)))

    def init(self, gen: torch.Generator) -> Tuple[Tree, Tree]:
        wd, r0 = self.w_dim, self.noise_init
        params: Tree = {"embed": L.eq_dense_init(gen, self.num_classes, wd)}
        for i in range(self.map_layers):
            params[f"map{i}"] = L.eq_dense_init(gen, self.z_dim + wd if i == 0 else wd, wd,
                                                lr_mult=self.map_lr_mult)
        params["b4_const"] = {"w": L._normal(gen, (4, 4, self.widths[0]), 1.0)}
        cin = self.widths[0]
        for res, w in zip(self.resolutions, self.widths):
            if res > 4:
                params[f"b{res}_conv0"] = L.modulated_init(gen, cin, w, wd, noise_init=r0)
            params[f"b{res}_conv1"] = L.modulated_init(gen, w, w, wd, noise_init=r0)
            params[f"b{res}_torgb"] = L.modulated_init(gen, w, self.channels, wd, kernel=1, noise_init=None)
            cin = w
        stats = _ema_stats(params)
        stats[f"map{self.map_layers - 1}"]["w_avg"] = torch.zeros(wd)
        return params, stats

    def mapping(self, params: Tree, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        e = L.eq_dense_apply(params["embed"], L.onehot(y, self.num_classes, dtype=z.dtype))
        h = torch.cat([L.normalize_2nd_moment(z), L.normalize_2nd_moment(e)], dim=-1)
        for i in range(self.map_layers):
            h = L.eq_dense_apply(params[f"map{i}"], h, lr_mult=self.map_lr_mult, act=True)
        return h

    def apply(self, params: Tree, stats: Tree, z: torch.Tensor, y: torch.Tensor, *, train: bool, mesh=None,
              generator: Optional[torch.Generator] = None):
        if mesh is not None:
            raise ValueError("the StyleGAN2 generator runs on one process")
        w = self.mapping(params, z, y)
        new_stats = stats
        if train:
            last = f"map{self.map_layers - 1}"
            with torch.no_grad():
                w_avg = torch.lerp(w.detach().mean(dim=0), stats[last]["w_avg"].to(w.dtype), self.w_avg_beta)
            new_stats = {**stats, last: {**stats[last], "w_avg": w_avg}}
        conv = dict(clamp=self.conv_clamp, use_pallas=self.use_pallas)
        n = z.shape[0]

        def noise(res):
            if generator is None:
                return None
            return torch.randn((n, res, res), generator=generator, device=z.device, dtype=z.dtype)

        x = params["b4_const"]["w"].to(z.dtype).expand(n, 4, 4, self.widths[0])
        img = None
        for res in self.resolutions:
            if res > 4:
                x = L.modulated_conv_apply(params[f"b{res}_conv0"], x, w, up=True, noise=noise(res), **conv)
            x = L.modulated_conv_apply(params[f"b{res}_conv1"], x, w, noise=noise(res), **conv)
            rgb = L.torgb_apply(params[f"b{res}_torgb"], x, w, **conv)
            img = rgb if img is None else L.upsample_image(img) + rgb
        return img, new_stats

    @staticmethod
    def ema_update(params: Tree, stats: Tree, beta: torch.Tensor) -> Tree:
        """``stats`` with every EMA array advanced to lerp(p, p_ema, beta)
        (StyleGAN2-ADA's G_ema), outside autograd."""
        out = {}
        with torch.no_grad():
            for layer, arrays in stats.items():
                out[layer] = dict(arrays)
                for name, p in params.get(layer, {}).items():
                    e = arrays[name + bridge.EMA_SUFFIX]
                    out[layer][name + bridge.EMA_SUFFIX] = torch.lerp(p, e, beta.to(e.dtype))
        return out

    def forward(self, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.apply(*self.trees(), z, y, train=False)[0]


class StyleGAN2Discriminator(_Player):
    """D(x, y), StyleGAN2-ADA's ``orig`` architecture with a projection:
    ``b<r>_fromrgb`` (1×1) at the input's resolution, then a block a
    resolution down to 8 (``widths[i]`` channels): the 3×3 ``b<r>_conv0``
    and the filtered stride-2 3×3 ``b<r>_conv1``; at 4×4 the minibatch
    stddev (groups of ``mbstd_group``, ``mbstd_channels`` planes), the 3×3
    ``b4_conv``, the dense ``b4_fc`` of the flattened (H, W, C) map, the
    dense ``b4_out`` to ``cmap_dim``; the logit Σ(h ⊙ cmap(y))/√cmap_dim,
    cmap D's own label mapping (``cmap_embed``, the second-moment
    normalisation, ``map_layers`` dense layers ``cmap<i>``). Every conv and
    dense layer is leaky ReLU·√2 (the output ones linear), convs clamped.
    No statistics. ``apply``'s ``streams`` says how many equal runs of
    rows the batch holds (the step's three kinds of pairs): the stddev
    groups never cross one."""

    def __init__(self, image_size: int = 32, channels: int = 3, num_classes: int = 10,
                 widths: Tuple[int, ...] = (512, 512, 512, 512), cmap_dim: int = 512, map_layers: int = 8,
                 map_lr_mult: float = 0.01, mbstd_group: int = 32, mbstd_channels: int = 1,
                 conv_clamp: float = 256.0, use_pallas: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size != 4 * 2 ** (len(widths) - 1):
            raise ValueError(f"{len(widths)} blocks down to 4x4 take {4 * 2 ** (len(widths) - 1)}, not {image_size}")
        self.image_size, self.channels, self.num_classes = image_size, channels, num_classes
        self.widths, self.cmap_dim, self.map_layers, self.map_lr_mult = tuple(widths), cmap_dim, map_layers, map_lr_mult
        self.mbstd_group, self.mbstd_channels, self.conv_clamp = mbstd_group, mbstd_channels, conv_clamp
        self.use_pallas = use_pallas
        self._build(generator)

    @property
    def resolutions(self) -> Tuple[int, ...]:
        return tuple(self.image_size // 2 ** i for i in range(len(self.widths) - 1))

    def init(self, gen: torch.Generator) -> Tuple[Tree, Tree]:
        w0 = self.widths[0]
        params: Tree = {"b%d_fromrgb" % self.image_size: {"w": L._normal(gen, (w0, self.channels, 1, 1), 1.0),
                                                         "b": torch.zeros(w0)}}

        def conv(cin, cout, k=3):
            return {"w": L._normal(gen, (cout, cin, k, k), 1.0), "b": torch.zeros(cout)}

        for i, res in enumerate(self.resolutions):
            w, nxt = self.widths[i], self.widths[i + 1]
            params[f"b{res}_conv0"] = conv(w, w)
            params[f"b{res}_conv1"] = conv(w, nxt)
        c4 = self.widths[-1]
        params["b4_conv"] = conv(c4 + self.mbstd_channels, c4)
        params["b4_fc"] = L.eq_dense_init(gen, 16 * c4, c4)
        params["b4_out"] = L.eq_dense_init(gen, c4, self.cmap_dim)
        params["cmap_embed"] = L.eq_dense_init(gen, self.num_classes, self.cmap_dim)
        for i in range(self.map_layers):
            params[f"cmap{i}"] = L.eq_dense_init(gen, self.cmap_dim, self.cmap_dim, lr_mult=self.map_lr_mult)
        return params, {}

    def cmap(self, params: Tree, y: torch.Tensor, dtype) -> torch.Tensor:
        h = L.normalize_2nd_moment(L.eq_dense_apply(params["cmap_embed"], L.onehot(y, self.num_classes, dtype=dtype)))
        for i in range(self.map_layers):
            h = L.eq_dense_apply(params[f"cmap{i}"], h, lr_mult=self.map_lr_mult, act=True)
        return h

    def apply(self, params: Tree, stats: Tree, x: torch.Tensor, y: torch.Tensor, *, train: bool,
              generator: Optional[torch.Generator] = None, streams: int = 1):
        conv = dict(clamp=self.conv_clamp, use_pallas=self.use_pallas)
        h = L.eq_conv_act_apply(params["b%d_fromrgb" % self.image_size], x, **conv)
        for res in self.resolutions:
            h = L.eq_conv_act_apply(params[f"b{res}_conv0"], h, **conv)
            h = L.eq_conv_act_apply(params[f"b{res}_conv1"], h, down=True, **conv)
        h = L.minibatch_stddev(h, self.mbstd_group, self.mbstd_channels, streams)
        h = L.eq_conv_act_apply(params["b4_conv"], h, **conv)
        h = L.eq_dense_apply(params["b4_fc"], h.reshape(h.shape[0], -1), act=True)
        h = L.eq_dense_apply(params["b4_out"], h)
        logit = torch.sum(h * self.cmap(params, y, h.dtype), dim=-1) * (1.0 / self.cmap_dim ** 0.5)
        return logit, stats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.apply(*self.trees(), x, y, train=False)[0]
