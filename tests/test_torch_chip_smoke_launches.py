"""chip_smoke.py's ``step_launches``, which the card run holds every kernel
arm's counts to key for key, against the conv and epilogue calls that one
train step of the port makes, on the CPU: cifar10_4k's layers at a few
channels, with the fused classifier, share_pseudo_forward and each layer
variant that moves convs off the kernels (or does not). The wrappers count
only on the card, so the calls are counted here by spies that key them as
the wrappers do."""

import collections

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from triplegan_tpu_torch.configs import make_networks  # noqa: E402
from triplegan_tpu_torch.data.datasets import synthetic_dataset  # noqa: E402
from triplegan_tpu_torch.nn import layers as L  # noqa: E402
from triplegan_tpu_torch.ops import conv3x3 as cv  # noqa: E402
from triplegan_tpu_torch.train import step as S  # noqa: E402
from triplegan_tpu_torch.train.schedule import make_optimizers  # noqa: E402
from triplegan_tpu_torch.train.state import create_state  # noqa: E402

torch.set_num_threads(1)


def _spy(monkeypatch):
    calls = {"convs": collections.Counter(), "epilogues": 0}

    def dt(t):
        return str(t.dtype).split(".")[-1]

    real_fwd, real_wgrad, real_sba = cv.conv3x3_nopad, cv.conv3x3_wgrad, L.scale_bias_act

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

    monkeypatch.setattr(cv, "conv3x3_nopad", nopad)
    monkeypatch.setattr(cv, "conv3x3_wgrad", wgrad)
    monkeypatch.setattr(L, "scale_bias_act", sba)
    return calls


@pytest.mark.parametrize("case,env", [
    ("default", {}), ("fused", {}), ("share", {}),
    ("fused", {"TRIPLEGAN_SMALLCIN": "patches"}), ("default", {"TRIPLEGAN_SMALLCIN": "patches"}),
    ("default", {"TRIPLEGAN_DECONV": "transpose"}), ("default", {"TRIPLEGAN_MAXPOOL": "maskbwd"}),
], ids=["default", "fused", "share", "fused_patches", "patches", "transpose", "maskbwd"])
def test_step_launches_equal_the_steps_kernel_calls(case, env, monkeypatch):
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(L, "_DECONV_IMPL", env.get("TRIPLEGAN_DECONV", "subpixel"))
    monkeypatch.setattr(L, "_MAXPOOL_IMPL", env.get("TRIPLEGAN_MAXPOOL", "window"))
    cfg = chip_smoke.train_cfg("float32", 4, case == "share", True)
    cfg.fused_clf_forward = case == "fused"
    cfg.gen.widths = (16, 8, 8)
    cfg.disc.widths = (8, 8, 16, 16, 16, 16)
    cfg.clf.conv_blocks = ((16, 16, 16), (16, 16, 16))
    cfg.clf.tail = (16, 16, 16)
    cfg.z_dim = 16
    nets = make_networks(cfg)
    opts = make_optimizers(cfg, 100)
    state = create_state(cfg, nets, opts, device="cpu")
    data = S.upload_device_data(synthetic_dataset(32, 3, 10, n_train=64, n_test=4, num_labeled=20), "cpu")
    step = S.make_device_train_step(cfg, nets, opts, 100)
    calls = _spy(monkeypatch)
    step(state, data)
    convs, players, epilogues, _ = chip_smoke.step_launches(cfg, env)
    assert calls["convs"] == convs, (dict(calls["convs"] - convs), dict(convs - calls["convs"]))
    assert calls["epilogues"] == epilogues
    assert set(players) == set(convs)
    default = sum(chip_smoke.step_launches(cfg, {})[0].values())
    if "TRIPLEGAN_SMALLCIN" in env or "TRIPLEGAN_DECONV" in env:
        assert sum(convs.values()) < default  # convs moved off the kernels
    else:
        assert sum(convs.values()) == default
    if case == "fused":
        assert any(key[1] == 12 for key in convs) and not any(
            key[0] == "wgrad" and key[1] == 4 and players[key] == {"clf"} for key in convs)
