"""chip_smoke.py's ``step_launches``, which the card run holds every kernel
arm's counts to key for key, against the conv and epilogue calls that one
train step of the port makes, on the CPU: cifar10_4k's layers at a few
channels, with the fused classifier, share_pseudo_forward and each layer
variant that moves convs off the kernels (or does not); and the
configurations of phase 3c (mnist100, svhn1k, cifar10_cond). The wrappers
count only on the card, so the calls are counted here by spies that key
them as the wrappers do (the epilogue's forward and backward by count),
and ``check_step_launches``, the card run's check, must pass on them; and
``hand_kernels_per_step``, which the card run holds each replay's kernels
to, for each epilogue family."""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from triplegan_tpu_torch.configs import make_networks  # noqa: E402
from triplegan_tpu_torch.data.datasets import synthetic_dataset  # noqa: E402
from triplegan_tpu_torch.data.zca import ZCAStats  # noqa: E402
from triplegan_tpu_torch.nn import layers as L  # noqa: E402
from triplegan_tpu_torch.ops import conv3x3 as cv  # noqa: E402
from triplegan_tpu_torch.ops import scale_bias_act as sba_mod  # noqa: E402
from triplegan_tpu_torch.train import step as S  # noqa: E402
from triplegan_tpu_torch.train.schedule import make_optimizers  # noqa: E402
from triplegan_tpu_torch.train.state import create_state  # noqa: E402

torch.set_num_threads(1)


def _spy(monkeypatch):
    calls = {"convs": collections.Counter(), "epilogues": 0, "epilogue_bwds": 0}

    def dt(t):
        return str(t.dtype).split(".")[-1]

    real_fwd, real_wgrad, real_sba = cv.conv3x3_nopad, cv.conv3x3_wgrad, L.scale_bias_act
    real_bwd = sba_mod.reference_scale_bias_act_bwd

    def nopad(x, w, pad=0, role="fwd"):
        n, h, wd, cin = x.shape
        calls["convs"][role, n, h, wd, cin, w.shape[3], pad, dt(x)] += 1
        return real_fwd(x, w, pad, role)

    def wgrad(x, g, pad=0):
        n, h, wd, cin = x.shape
        calls["convs"]["wgrad", n, h, wd, cin, g.shape[3], pad, dt(x)] += 1
        return real_wgrad(x, g, pad)

    def sba(*args, **kwargs):
        calls["epilogues"] += 1
        return real_sba(*args, **kwargs)

    def sba_bwd(*args, **kwargs):
        calls["epilogue_bwds"] += 1
        return real_bwd(*args, **kwargs)

    monkeypatch.setattr(cv, "conv3x3_nopad", nopad)
    monkeypatch.setattr(cv, "conv3x3_wgrad", wgrad)
    monkeypatch.setattr(L, "scale_bias_act", sba)
    monkeypatch.setattr(sba_mod, "reference_scale_bias_act_bwd", sba_bwd)
    return calls


def _as_counts(calls):
    """The spied calls keyed as ``chip_smoke.counts_read`` returns the
    wrappers' counts (the epilogue's by call count alone)."""
    convs = calls["convs"]
    return {"conv3x3_fwd": collections.Counter({k: c for k, c in convs.items() if k[0] != "wgrad"}),
            "conv3x3_wgrad": collections.Counter({k: c for k, c in convs.items() if k[0] == "wgrad"}),
            "scale_bias_act": collections.Counter({"calls": calls["epilogues"]}),
            "scale_bias_act_bwd": collections.Counter({"calls": calls["epilogue_bwds"]})}


# the layers that set phase 3c's configurations apart, at the widths this
# test runs them: (Generator's, Discriminator's, Classifier's) first conv
# and (Generator's last, Discriminator's after the label re-concat,
# Classifier's VALID t0), each (h, cin, cout, halo)
CONFIG_LAYERS = {
    # published widths: Cin 1 and 1 + 10, Cout 4·1, 32 + 10 at 14 × 14, 7 × 7 to 5 × 5
    "mnist100": ((7, 128, 256, 1), (28, 11, 32, 1), (28, 1, 32, 1), (14, 64, 4, 1), (14, 42, 64, 1), (7, 64, 128, 0)),
    "svhn1k": ((4, 16, 32, 1), (32, 13, 8, 1), (32, 3, 16, 1), (16, 8, 12, 1), (16, 18, 16, 1), (8, 16, 16, 0)),
    "cifar10_cond": ((4, 16, 32, 1), (32, 13, 8, 1), (32, 3, 16, 1), (16, 8, 12, 1), (16, 18, 16, 1), (8, 16, 16, 0)),
}


@pytest.mark.parametrize("case,env", [
    ("default", {}), ("fused", {}), ("share", {}),
    ("fused", {"TRIPLEGAN_SMALLCIN": "patches"}), ("default", {"TRIPLEGAN_SMALLCIN": "patches"}),
    ("default", {"TRIPLEGAN_DECONV": "transpose"}), ("default", {"TRIPLEGAN_MAXPOOL": "maskbwd"}),
    ("mnist100", {}), ("svhn1k", {}), ("cifar10_cond", {}),
], ids=["default", "fused", "share", "fused_patches", "patches", "transpose", "maskbwd",
        "mnist100", "svhn1k", "cifar10_cond"])
def test_step_launches_equal_the_steps_kernel_calls(case, env, monkeypatch):
    """cifar10_4k's layers at a few channels under each case; and phase
    3c's configurations as ``chip_smoke.config_cfg`` builds them (mnist100
    at its published widths, svhn1k and cifar10_cond at a few channels,
    ``chip_smoke.few_channels``), each with its own image size, channels,
    ZCA, augmentation and labels."""
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(L, "_DECONV_IMPL", env.get("TRIPLEGAN_DECONV", "subpixel"))
    monkeypatch.setattr(L, "_MAXPOOL_IMPL", env.get("TRIPLEGAN_MAXPOOL", "window"))
    if case in chip_smoke.CONFIGS:
        cfg = chip_smoke.config_cfg(case, "float32", 4)
        if case != "mnist100":
            chip_smoke.few_channels(cfg)
        gen, disc, clf = chip_smoke.conv_layers(cfg)
        assert (gen[0], disc[0], clf[0], gen[-1], disc[1], clf[-1]) == CONFIG_LAYERS[case]
    else:
        cfg = chip_smoke.few_channels(chip_smoke.train_cfg("float32", 4, case == "share", True))
        cfg.fused_clf_forward = case == "fused"
    nets = make_networks(cfg)
    opts = make_optimizers(cfg, 100)
    state = create_state(cfg, nets, opts, device="cpu")
    data = S.upload_device_data(synthetic_dataset(cfg.image_size, cfg.channels, 10, n_train=64, n_test=4,
                                                  num_labeled=min(cfg.num_labeled, 20) if case != "cifar10_cond"
                                                  else cfg.num_labeled), "cpu")
    zca = None
    if cfg.zca:
        d = cfg.image_size ** 2 * cfg.channels
        zca = ZCAStats(mean=np.zeros(d, np.float32), whiten=np.eye(d, dtype=np.float32))
    step = S.make_device_train_step(cfg, nets, opts, 100, zca_stats=zca)
    calls = _spy(monkeypatch)
    step(state, data)
    convs, players, epilogues, epilogue_bwds = chip_smoke.step_launches(cfg, env)
    assert calls["convs"] == convs, (dict(calls["convs"] - convs), dict(convs - calls["convs"]))
    assert (calls["epilogues"], calls["epilogue_bwds"]) == (epilogues, epilogue_bwds)
    assert set(players) == set(convs)
    # the check the card run applies to the wrappers' counts
    assert chip_smoke.check_step_launches(cfg, _as_counts(calls), 1, case)["conv3x3_fwd"] == sum(
        c for k, c in convs.items() if k[0] != "wgrad")
    default = sum(chip_smoke.step_launches(cfg, {})[0].values())
    if "TRIPLEGAN_SMALLCIN" in env or "TRIPLEGAN_DECONV" in env:
        assert sum(convs.values()) < default  # convs moved off the kernels
    else:
        assert sum(convs.values()) == default
    if case == "fused":
        assert any(key[1] == 12 for key in convs) and not any(
            key[0] == "wgrad" and key[1] == 4 and players[key] == {"clf"} for key in convs)


def test_stl10_rank_step_launches_equal_the_steps_kernel_calls(monkeypatch):
    """stl10 (the config that ships a mesh) at a rank's batch, 128 // 2,
    and its 96 × 96 layers at a few channels: D's first conv takes 3 + 10
    channels, G has four deconvs, C runs at 96 × 96. ``step_launches`` and
    ``conv_layers``, which chip_smoke.py holds each rank's launches to,
    against the spied calls of one step at that batch."""
    cfg = chip_smoke.per_rank(chip_smoke.stl10_cfg())
    assert (cfg.batch_size, cfg.image_size, cfg.mesh_shape) == (64, 96, (2,))
    cfg.gen.widths = (8, 4, 4, 4)
    cfg.disc.widths = (4,) * len(cfg.disc.strides)
    cfg.clf.conv_blocks = ((4, 4, 4), (4, 4, 4))
    cfg.clf.tail = (4, 4, 4)
    cfg.z_dim = 8
    gen, disc, clf = chip_smoke.conv_layers(cfg)
    assert disc[0] == (96, 13, 4, 1) and len(gen) == 4 and gen[-1] == (48, 4, 12, 1) and clf[0] == (96, 3, 4, 1)
    nets = make_networks(cfg)
    opts = make_optimizers(cfg, 100)
    state = create_state(cfg, nets, opts, device="cpu")
    data = S.upload_device_data(synthetic_dataset(96, 3, 10, n_train=128, n_test=4, num_labeled=100), "cpu")
    step = S.make_device_train_step(cfg, nets, opts, 100)
    calls = _spy(monkeypatch)
    step(state, data)
    convs, players, epilogues, epilogue_bwds = chip_smoke.step_launches(cfg)
    assert calls["convs"] == convs, (dict(calls["convs"] - convs), dict(convs - calls["convs"]))
    assert (calls["epilogues"], calls["epilogue_bwds"]) == (epilogues, epilogue_bwds)
    assert set(players) == set(convs)
    assert {key[1] for key in convs} == {64, 192}  # a rank's batch, and D's 3B rows


def test_the_digits_supervised_arm_launches_what_chip_smoke_implies(monkeypatch):
    """``digits_baseline_launches``, the card run's check of the supervised
    arm of phase 3d: a full-batch step (every filter gradient, every input
    gradient but the first conv's) and an eval of the 500 test images in
    batches of ``batch_size``, against the calls that two eager steps and
    an eval of ``SupervisedBaseline`` make, mnist100's Classifier at a few
    channels."""
    from triplegan_tpu_torch.configs import get_config
    from triplegan_tpu_torch.tools.digits_experiment import SupervisedBaseline

    cfg = get_config("mnist100")
    cfg.clf.conv_blocks, cfg.clf.tail = ((4, 4), (8, 8)), (8, 8)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (cfg.batch_size, 28, 28, 1)).astype(np.uint8)
    calls = _spy(monkeypatch)
    run = SupervisedBaseline(cfg, x, np.arange(cfg.batch_size) % 10, "cpu", noise_seed=0)
    for _ in range(2):
        run.step()
    run.error(rng.randint(0, 256, (chip_smoke.DIGITS_TEST, 28, 28, 1)).astype(np.uint8),
              np.zeros(chip_smoke.DIGITS_TEST, np.int64))
    step_convs, step_fwd, step_bwd, eval_convs, eval_fwd = chip_smoke.digits_baseline_launches(cfg)
    counts = _as_counts(calls)
    want = collections.Counter({k: 2 * c for k, c in step_convs.items()}) + eval_convs
    assert counts["conv3x3_fwd"] + counts["conv3x3_wgrad"] == want
    assert (calls["epilogues"], calls["epilogue_bwds"]) == (2 * step_fwd + eval_fwd, 2 * step_bwd)


def test_hand_kernels_per_step_maps_each_epilogue_family_to_its_kernels():
    """The per-channel, per-sample and modulation epilogues' counts (keys
    as their wrappers key them, the gradients last) as the kernels a step
    runs: a forward each, a backward each, and the backward's reduce where
    dk or db is asked for; every group of ``HAND_KERNELS`` given."""
    shape = (2, 4, 4, 8)
    counts = {"conv3x3_fwd": collections.Counter(), "conv3x3_wgrad": collections.Counter(),
              "scale_bias_act": collections.Counter({(shape, "float32", "relu", 0.1): 6}),
              "scale_bias_act_bwd": collections.Counter({(shape, "float32", "relu", 0.1, "x"): 2,
                                                         (shape, "float32", "relu", 0.1, "xb"): 4}),
              "scale_bias_act_cond": collections.Counter({(shape, "float32", "linear", 0.1): 4}),
              "scale_bias_act_cond_bwd": collections.Counter({(shape, "float32", "linear", 0.1, "xk"): 2}),
              "scale_bias_act_noise": collections.Counter({(shape, "float32", "leaky_relu", 0.2, 256.0): 6}),
              "scale_bias_act_noise_bwd": collections.Counter({(shape, "float32", "leaky_relu", 0.2, 256.0, "xq"): 2,
                                                               (shape, "float32", "leaky_relu", 0.2, 256.0, "xkbq"): 2})}
    moments = {"bn_moments": collections.Counter(), "bn_moments_bwd": collections.Counter()}
    per_step = chip_smoke.hand_kernels_per_step(counts, 2, moments)
    assert set(per_step) == set(chip_smoke.HAND_KERNELS)
    assert {g: per_step[g] for g in per_step if g[:3] in ("sba", "cbn", "mod")} == {
        "sba_fwd": 3, "sba_bwd": 3, "sba_bwd_reduce": 2, "cbn_fwd": 2, "cbn_bwd": 1, "cbn_bwd_reduce": 1,
        "mod_fwd": 3, "mod_bwd": 2, "mod_bwd_reduce": 1}
    plain = {k: v for k, v in counts.items() if "cond" not in k and "noise" not in k}
    assert all(chip_smoke.hand_kernels_per_step(plain, 2, moments)[g] == 0 for g in per_step if g[:3] in ("cbn", "mod"))
