"""Base hyperparameter config: the port's own copy of
``triplegan_tpu/configs/base.py``, as a plain nested dict with attribute
access (no ``ml_collections``), so a run dir's ``config.json`` written by the
JAX trainer loads here unchanged.

Every field keeps the JAX package's name and default, with one exception:
``use_pallas`` defaults to True, which in the port selects the hand-written
Hopper epilogue kernel (``ops/scale_bias_act.py``); False selects the plain
PyTorch epilogue that the JAX package's non-Pallas branch computes.
"""

from __future__ import annotations

import json
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
    cfg.use_pallas = True                     # True: the Hopper epilogue kernel
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


def merge_saved(cfg: ConfigDict, path: str) -> ConfigDict:
    """Overlay a saved ``config.json`` onto ``cfg`` in place, skipping
    ``EXEC_KEYS``. Tuple fields are re-coerced from JSON lists; keys this
    code does not know, and values whose type no longer fits, are skipped
    (the latter with a warning)."""
    with open(path) as f:
        saved = json.load(f)

    def _merge(node, d, top, prefix=""):
        for k, v in d.items():
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


def make_networks(cfg: ConfigDict):
    """Build the (Generator, Classifier) modules of a config. The
    Discriminator comes with the training slice."""
    from triplegan_tpu_torch.nn.networks import Classifier, Generator

    gen = Generator(
        image_size=cfg.image_size,
        channels=cfg.channels,
        num_classes=cfg.num_classes,
        z_dim=cfg.z_dim,
        widths=tuple(cfg.gen.widths),
        kernel=cfg.gen.kernel,
        use_pallas=cfg.use_pallas,
    )
    clf = Classifier(
        image_size=cfg.image_size,
        channels=cfg.channels,
        num_classes=cfg.num_classes,
        conv_blocks=tuple(tuple(b) for b in cfg.clf.conv_blocks),
        tail=tuple(cfg.clf.tail),
        use_pallas=cfg.use_pallas,
    )
    return gen, clf
