"""Per-dataset configs: the port's copy of ``triplegan_tpu/configs`` with
the same five registry entries and the same values, and two of the port's
own, ``cifar10_snresnet`` and ``cifar10_stylegan2``."""

from __future__ import annotations

from triplegan_tpu_torch.configs.base import ConfigDict, base_config, make_networks


def mnist100() -> ConfigDict:
    """MNIST 28×28 Triple-GAN, 100 labels: tiny nets."""
    cfg = base_config()
    cfg.name = "mnist100"
    cfg.dataset = "mnist"
    cfg.image_size = 28
    cfg.channels = 1
    cfg.num_labeled = 100
    cfg.zca = False
    cfg.aug_translate = 0
    cfg.aug_flip = False
    cfg.gen.widths = (128, 64)                 # dense→7×7×128, 2 deconvs to 28
    cfg.disc.widths = (32, 32, 64, 64)
    cfg.disc.strides = (1, 2, 1, 2)
    cfg.clf.conv_blocks = ((32, 32), (64, 64))
    cfg.clf.tail = (128, 64)
    cfg.epochs = 300
    cfg.alpha_p_warmup_epochs = 100
    return cfg


def svhn1k() -> ConfigDict:
    """SVHN 32×32 semi-supervised, 1000 labels."""
    cfg = base_config()
    cfg.name = "svhn1k"
    cfg.dataset = "svhn"
    cfg.num_labeled = 1000
    cfg.zca = False
    cfg.aug_flip = False
    cfg.epochs = 600
    cfg.alpha_p_warmup_epochs = 100
    return cfg


def cifar10_4k() -> ConfigDict:
    """CIFAR-10 32×32 semi-supervised, 4000 labels (ZCA + augmentation)."""
    cfg = base_config()
    cfg.name = "cifar10_4k"
    return cfg


def cifar10_cond() -> ConfigDict:
    """CIFAR-10 class-conditional generation, full labels; larger G."""
    cfg = base_config()
    cfg.name = "cifar10_cond"
    cfg.num_labeled = 50000
    cfg.gen.widths = (1024, 512, 256)
    cfg.alpha_p_warmup_epochs = 0
    return cfg


def cifar10_snresnet() -> ConfigDict:
    """cifar10_4k with the SN-ResNet pair of Miyato & Koyama (cGANs with
    Projection Discriminator, arXiv:1802.05637) as G and D: G a dense layer
    to 4×4×256 and three 256-wide up-blocks with class-conditional batch
    norm, z of 128; D an optimised block and three blocks 128 wide, every
    weight spectrally normalised, with a projection head. C, the objective
    and the recipe are cifar10_4k's; D has no noise, dropout or label
    planes."""
    cfg = cifar10_4k()
    cfg.name = "cifar10_snresnet"
    cfg.arch = "snresnet"
    cfg.z_dim = 128
    cfg.gen.widths = (256, 256, 256)           # dense→4×4×256, 3 up-blocks to 32
    cfg.gen.kernel = 3
    cfg.disc.widths = (128, 128, 128, 128)     # optimised block, then 3 blocks
    cfg.disc.strides = (2, 2, 1, 1)            # 2: the block ends in a 2×2 average pool
    cfg.disc.input_noise = cfg.disc.input_dropout = cfg.disc.block_dropout = 0.0
    cfg.disc.label_reconcat = False
    return cfg


def cifar10_stylegan2() -> ConfigDict:
    """cifar10_4k with the StyleGAN2 pair (Karras et al., arXiv:1912.04958)
    as G and D, at StyleGAN2-ADA's cifar configuration (arXiv:2006.06676;
    NVlabs/stylegan2-ada-pytorch train.py cfg_specs['cifar']): 512 channels
    at every resolution from 4 to 32, z and w of 512, a 2-layer mapping
    (lr multiplier 0.01, w_avg β 0.995), conv_clamp 256; D ``orig`` with a
    minibatch stddev over groups of 32 (one plane) and a projection onto
    its own 8-layer label mapping (cmap 512); the lazy R1 penalty γ = 0.01
    every 16 steps; G's EMA copy with a half-life of 500 kimg ramped over
    0.05 of the images seen. Batch 64 (``mb``). C, the objective, Adam and
    the data pipeline are cifar10_4k's."""
    cfg = cifar10_4k()
    cfg.name = "cifar10_stylegan2"
    cfg.arch = "stylegan2"
    cfg.z_dim = 512
    cfg.batch_size = 64
    cfg.gen.widths = (512, 512, 512, 512)      # channels at 4, 8, 16, 32
    cfg.gen.kernel = 3
    cfg.gen.w_dim = 512
    cfg.gen.map_layers = 2
    cfg.gen.map_lr_mult = 0.01
    cfg.gen.w_avg_beta = 0.995
    cfg.gen.conv_clamp = 256.0
    cfg.gen.noise_init = 0.1                   # StyleGAN2 starts the strengths at 0
    cfg.gen.ema_kimg = 500.0
    cfg.gen.ema_rampup = 0.05
    cfg.disc.widths = (512, 512, 512, 512)     # blocks at 32, 16, 8, the epilogue at 4
    cfg.disc.strides = (2, 2, 2, 1)            # each block ends in a filtered stride-2 conv
    cfg.disc.input_noise = cfg.disc.input_dropout = cfg.disc.block_dropout = 0.0
    cfg.disc.label_reconcat = False
    cfg.disc.cmap_dim = 512
    cfg.disc.map_layers = 8
    cfg.disc.map_lr_mult = 0.01
    cfg.disc.mbstd_group = 32
    cfg.disc.mbstd_channels = 1
    cfg.disc.conv_clamp = 256.0
    cfg.r1_gamma = 0.01
    cfg.r1_interval = 16
    return cfg


def stl10() -> ConfigDict:
    """STL-10 96×96 semi-supervised."""
    cfg = base_config()
    cfg.name = "stl10"
    cfg.dataset = "stl10"
    cfg.image_size = 96
    cfg.num_labeled = 1000
    cfg.zca = False
    cfg.aug_translate = 4
    cfg.gen.widths = (512, 256, 128, 64)       # dense→6×6×512, 4 deconvs to 96
    cfg.disc.widths = (32, 32, 64, 64, 128, 128, 256, 256)
    cfg.disc.strides = (1, 2, 1, 2, 1, 2, 1, 2)
    cfg.mesh_shape = (8,)
    cfg.batch_size = 128
    return cfg


REGISTRY = {
    "mnist100": mnist100,
    "svhn1k": svhn1k,
    "cifar10_4k": cifar10_4k,
    "cifar10_cond": cifar10_cond,
    "stl10": stl10,
    "cifar10_snresnet": cifar10_snresnet,
    "cifar10_stylegan2": cifar10_stylegan2,
}


def get_config(name: str) -> ConfigDict:
    if name not in REGISTRY:
        raise KeyError(f"unknown config '{name}'; available: {sorted(REGISTRY)}")
    return REGISTRY[name]()


__all__ = ["ConfigDict", "get_config", "REGISTRY", "base_config", "make_networks"]
