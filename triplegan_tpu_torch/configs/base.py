"""Base hyperparameter config: the port's own copy of
``triplegan_tpu/configs/base.py``, as a plain nested dict with attribute
access (no ``ml_collections``), so a run dir's ``config.json`` written by the
JAX trainer loads here unchanged.

Every field keeps the JAX package's name and default, with one exception:
``use_pallas`` defaults to True, which in the port selects the hand-written
Hopper kernels (the epilogue ``ops/scale_bias_act.py`` and the 3×3 conv
``ops/conv3x3.py``); False selects plain PyTorch: the epilogue that the JAX
package's non-Pallas branch computes, and ``F.conv2d`` for every conv.
"""

from __future__ import annotations

import json
import os
import warnings


class ConfigDict(dict):
    """A dict whose keys are also attributes (``cfg.gen.widths``)."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key, value):
        self[key] = value


def base_config() -> ConfigDict:
    cfg = ConfigDict()

    # --- experiment identity / paths -------------------------------------
    cfg.name = "base"
    cfg.seed = 0
    cfg.data_dir = "/tmp/triplegan_data"
    cfg.workdir = "/tmp/triplegan_runs"

    # --- dataset ----------------------------------------------------------
    cfg.dataset = "cifar10"
    cfg.image_size = 32
    cfg.channels = 3
    cfg.num_classes = 10
    cfg.num_labeled = 4000
    cfg.zca = True
    cfg.rescale = True
    cfg.aug_translate = 2
    cfg.aug_flip = True
    cfg.aug_order = "zca_first"
    cfg.aug_pad_mode = "reflect"

    # --- networks ----------------------------------------------------------
    cfg.z_dim = 100
    cfg.bn_momentum = 0.99
    cfg.gen = ConfigDict()
    cfg.gen.widths = (512, 256, 128)
    cfg.gen.kernel = 5

    cfg.disc = ConfigDict()
    cfg.disc.widths = (32, 32, 64, 64, 128, 128)
    cfg.disc.strides = (1, 2, 1, 2, 1, 2)
    cfg.disc.input_noise = 0.05
    cfg.disc.input_dropout = 0.2
    cfg.disc.block_dropout = 0.2
    cfg.disc.label_reconcat = True

    cfg.clf = ConfigDict()
    cfg.clf.conv_blocks = ((128, 128, 128), (256, 256, 256))
    cfg.clf.tail = (512, 256, 128)
    cfg.clf.input_noise = 0.15
    cfg.clf.block_dropout = 0.5

    # --- three-player objective -------------------------------------------
    cfg.alpha = 0.5
    cfg.alpha_p = 0.1
    cfg.alpha_p_warmup_epochs = 200
    cfg.alpha_p_ramp_epochs = 0
    cfg.non_saturating_g = True
    cfg.pseudo_label_mode = "sample"
    cfg.ddinit = False
    cfg.share_pseudo_forward = False

    # --- optimization ------------------------------------------------------
    cfg.batch_size = 100
    cfg.epochs = 1000
    cfg.steps_per_epoch = 0
    cfg.lr_g = 3e-4
    cfg.lr_d = 3e-4
    cfg.lr_c = 3e-4
    cfg.adam_b1 = 0.5
    cfg.adam_b2 = 0.999
    cfg.adam_eps = 1e-8
    cfg.lr_decay_start_frac = 0.5
    cfg.lr_c_anneal_factor = 1.0
    cfg.lr_c_anneal_epochs = 0

    # --- execution ---------------------------------------------------------
    cfg.compute_dtype = "float32"             # "bfloat16" for throughput runs
    cfg.prng_impl = "threefry"
    cfg.use_pallas = True                     # True: the Hopper kernels
    cfg.fused_clf_forward = False
    cfg.data_on_device = True
    cfg.mesh_shape = (1,)
    cfg.multihost = False
    cfg.multihost_coordinator = ""
    cfg.multihost_num_processes = 0
    cfg.multihost_process_id = -1
    cfg.scan_steps = 1
    cfg.scan_metrics = "last"
    cfg.log_every = 100
    cfg.eval_every_epochs = 1
    cfg.ckpt_every_epochs = 10
    cfg.ckpt_keep = 3
    cfg.profile_dir = ""
    cfg.profile_steps = 10

    return cfg


# Execution-environment fields: where the run lives and how this host
# executes it, not part of the model semantics a checkpoint encodes. A run
# dir's config.json never overrides them (same rule as the JAX package).
EXEC_KEYS = frozenset({
    "workdir", "data_dir", "mesh_shape", "use_pallas", "scan_steps",
    "scan_metrics",
    "data_on_device", "log_every", "eval_every_epochs", "ckpt_every_epochs",
    "ckpt_keep", "profile_dir", "profile_steps",
    "multihost", "multihost_coordinator", "multihost_num_processes",
    "multihost_process_id",
})


# Keys a config holds only where it departs from the base: ``arch`` (the
# G and D designs: "conv", the default, the JAX package's networks;
# "snresnet", ``nn/networks.py``'s ResNet G and SN projection D;
# "stylegan2", its StyleGAN2 G and D) and StyleGAN2's lazy R1 penalty,
# ``r1_gamma`` and ``r1_interval`` (an R1 update of D every that many
# steps; 0 or absent: none). A run dir's config.json brings them over even
# into a config that lacks them, so that a config rebuilt from
# ``base_config()`` builds the run's networks. The StyleGAN2 pair's sizes
# are keys of ``gen`` and ``disc`` that only its configs hold, named here
# by their dotted paths.
OPTIONAL_KEYS = frozenset({"arch", "r1_gamma", "r1_interval"}
                          | {f"gen.{k}" for k in ("w_dim", "map_layers", "map_lr_mult", "w_avg_beta", "conv_clamp",
                                                  "noise_init", "ema_kimg", "ema_rampup")}
                          | {f"disc.{k}" for k in ("cmap_dim", "map_layers", "map_lr_mult", "mbstd_group",
                                                   "mbstd_channels", "conv_clamp")})
ARCHS = ("conv", "snresnet", "stylegan2")


def arch(cfg: ConfigDict) -> str:
    """The config's G and D designs (``OPTIONAL_KEYS``)."""
    name = cfg.get("arch", "conv")
    if name not in ARCHS:
        raise ValueError(f"arch must be one of {ARCHS}, got {name!r}")
    return name


def save_config(cfg: ConfigDict, path: str) -> None:
    """Write the resolved config as JSON, keys sorted and tuples as lists,
    as the JAX package's ``save_config`` does: the train driver writes
    ``<workdir>/<name>/config.json`` so that eval, sample and a resume
    rebuild the checkpoint's template without the ``--set`` overrides, and
    either package's ``merge_saved`` reads the file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2, default=list, sort_keys=True)


def merge_saved(cfg: ConfigDict, path: str) -> ConfigDict:
    """Overlay a saved ``config.json`` onto ``cfg`` in place, skipping
    ``EXEC_KEYS``. Tuple fields are re-coerced from JSON lists; keys this
    code does not know (but ``OPTIONAL_KEYS``), and values whose type no
    longer fits, are skipped (the latter with a warning)."""
    with open(path) as f:
        saved = json.load(f)

    def _merge(node, d, top, prefix=""):
        for k, v in d.items():
            if prefix + k in OPTIONAL_KEYS and k not in node:
                node[k] = v
                continue
            if k not in node or (top and k in EXEC_KEYS):
                continue
            cur = node[k]
            if isinstance(cur, ConfigDict) and isinstance(v, dict):
                _merge(cur, v, False, prefix + k + ".")
            elif isinstance(cur, tuple) and isinstance(v, (list, tuple)):
                node[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            elif isinstance(cur, (ConfigDict, tuple)) or isinstance(v, (dict, list)):
                warnings.warn(
                    f"config.json key '{prefix}{k}'={v!r} does not fit the "
                    f"current field (default {cur!r} kept)",
                    stacklevel=2,
                )
            else:
                node[k] = v

    _merge(cfg, saved, True)
    return cfg


def apply_runtime(cfg: ConfigDict) -> ConfigDict:
    """Set the process-wide runtime a run needs before any state is built:
    the matmul precision pins of ``utils/platform.py``, and cuDNN in its
    deterministic algorithms (autotuning off), so that the convs the Hopper
    kernels do not take (stride 2, 1×1, and every conv of the plain arm)
    compute the same bits on every run and a resumed run equals an
    uninterrupted one. ``prng_impl`` is kept in the config and recorded in
    ``config.json`` but has no effect here: the port's random streams are
    PyTorch's generators, seeded from (seed, step), not JAX's keys."""
    import torch

    from triplegan_tpu_torch.utils.platform import pin_precision

    pin_precision()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return cfg


def display(cfg: ConfigDict) -> str:
    """A readable dump of the config, one field a line, as the JAX
    package's ``display``."""
    lines = ["Configuration:"]
    for k in sorted(cfg.keys()):
        v = cfg[k]
        if isinstance(v, ConfigDict):
            for kk in sorted(v.keys()):
                lines.append(f"  {k}.{kk:<24} {v[kk]}")
        else:
            lines.append(f"  {k:<26} {v}")
    return "\n".join(lines)


def make_networks(cfg: ConfigDict):
    """Build the (Generator, Discriminator, Classifier) modules of a
    config, in the JAX package's order; G and D of its ``arch``."""
    from triplegan_tpu_torch.nn.networks import (Classifier, Discriminator, Generator, ResNetGenerator,
                                                 SNResNetDiscriminator, StyleGAN2Discriminator,
                                                 StyleGAN2Generator)

    clf = Classifier(
        image_size=cfg.image_size,
        channels=cfg.channels,
        num_classes=cfg.num_classes,
        conv_blocks=tuple(tuple(b) for b in cfg.clf.conv_blocks),
        tail=tuple(cfg.clf.tail),
        input_noise=cfg.clf.input_noise,
        block_dropout=cfg.clf.block_dropout,
        bn_momentum=cfg.bn_momentum,
        use_pallas=cfg.use_pallas,
    )
    if arch(cfg) == "snresnet":
        gen = ResNetGenerator(image_size=cfg.image_size, channels=cfg.channels, num_classes=cfg.num_classes,
                              z_dim=cfg.z_dim, widths=tuple(cfg.gen.widths), kernel=cfg.gen.kernel,
                              bn_momentum=cfg.bn_momentum, use_pallas=cfg.use_pallas)
        disc = SNResNetDiscriminator(image_size=cfg.image_size, channels=cfg.channels,
                                     num_classes=cfg.num_classes, widths=tuple(cfg.disc.widths),
                                     strides=tuple(cfg.disc.strides), use_pallas=cfg.use_pallas)
        return gen, disc, clf
    if arch(cfg) == "stylegan2":
        g, d = cfg.gen, cfg.disc
        gen = StyleGAN2Generator(image_size=cfg.image_size, channels=cfg.channels, num_classes=cfg.num_classes,
                                 z_dim=cfg.z_dim, w_dim=g.w_dim, widths=tuple(g.widths), map_layers=g.map_layers,
                                 map_lr_mult=g.map_lr_mult, w_avg_beta=g.w_avg_beta, conv_clamp=g.conv_clamp,
                                 noise_init=g.noise_init, use_pallas=cfg.use_pallas)
        disc = StyleGAN2Discriminator(image_size=cfg.image_size, channels=cfg.channels,
                                      num_classes=cfg.num_classes, widths=tuple(d.widths), cmap_dim=d.cmap_dim,
                                      map_layers=d.map_layers, map_lr_mult=d.map_lr_mult,
                                      mbstd_group=d.mbstd_group, mbstd_channels=d.mbstd_channels,
                                      conv_clamp=d.conv_clamp, use_pallas=cfg.use_pallas)
        return gen, disc, clf
    gen = Generator(
        image_size=cfg.image_size,
        channels=cfg.channels,
        num_classes=cfg.num_classes,
        z_dim=cfg.z_dim,
        widths=tuple(cfg.gen.widths),
        kernel=cfg.gen.kernel,
        bn_momentum=cfg.bn_momentum,
        use_pallas=cfg.use_pallas,
    )
    disc = Discriminator(
        image_size=cfg.image_size,
        channels=cfg.channels,
        num_classes=cfg.num_classes,
        widths=tuple(cfg.disc.widths),
        strides=tuple(cfg.disc.strides),
        input_noise=cfg.disc.input_noise,
        input_dropout=cfg.disc.input_dropout,
        block_dropout=cfg.disc.block_dropout,
        label_reconcat=bool(cfg.disc.get("label_reconcat", True)),
        use_pallas=cfg.use_pallas,
    )
    return gen, disc, clf
