"""Per-dataset configs: the port's copy of ``triplegan_tpu/configs`` with
the same five registry entries and the same values."""

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
}


def get_config(name: str) -> ConfigDict:
    if name not in REGISTRY:
        raise KeyError(f"unknown config '{name}'; available: {sorted(REGISTRY)}")
    return REGISTRY[name]()


__all__ = ["ConfigDict", "get_config", "REGISTRY", "base_config", "make_networks"]
