"""The SN-ResNet pair of ``cifar10_snresnet`` (the ResNet G with
class-conditional batch norm, the spectrally normalised projection D) on
the CPU, against the plain reference ``tests/plain_snresnet.py``, with
``use_pallas`` off and on (on the CPU the kernels take their plain
versions):

- G's and D's forward and backward at 16 channels on 16 × 16 images,
  within 1e-5 relative, and D's power iteration's new u;
- three steps of ``make_train_step`` under ``tests/test_torch_configs.py``'s
  tolerances: the metrics within 1e-5·(1 + |metric|), every parameter
  within 2·N·lr and 99% of each player's within lr/100 (N = 3 steps), the
  batch-norm statistics and D's kept u within 1e-4 absolute plus 1e-4
  relative, the argmax pseudo-labels equal at every step;
- the per-sample epilogue's plain version against autograd of its formula;
- a ``cli train`` run dir of ``cifar10_snresnet`` (graphed chunks, eager on
  the CPU) that checkpoints D's u, resumes, samples and evaluates, and
  whose serving and ``.pt2`` export refuse it by name.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import plain_snresnet as plain  # noqa: E402
from triplegan_tpu_torch import cli  # noqa: E402
from triplegan_tpu_torch.configs import get_config, make_networks  # noqa: E402
from triplegan_tpu_torch.configs.base import base_config, merge_saved  # noqa: E402
from triplegan_tpu_torch.data.datasets import synthetic_dataset  # noqa: E402
from triplegan_tpu_torch.data import ondevice  # noqa: E402
from triplegan_tpu_torch.nn.networks import ResNetGenerator, SNResNetDiscriminator  # noqa: E402
from triplegan_tpu_torch.ops import scale_bias_act as sba  # noqa: E402
from triplegan_tpu_torch.train import loop  # noqa: E402
from triplegan_tpu_torch.train import step as S  # noqa: E402
from triplegan_tpu_torch.train.schedule import make_optimizers  # noqa: E402
from triplegan_tpu_torch.train.state import create_state  # noqa: E402
from triplegan_tpu_torch.utils.logging import MetricsLogger  # noqa: E402

torch.set_num_threads(1)
N_STEPS, TOTAL, B = 3, 16, 4
GEN_WIDTHS, DISC_WIDTHS, DISC_STRIDES = (16, 16), (16, 16, 16, 16), (2, 2, 1, 1)


def _close(got, want, rel=1e-5, floor=0.0):
    """|got − want| within ``rel`` of want's largest magnitude (or of
    ``floor``, if larger)."""
    scale = max(float(want.detach().abs().max()), floor) or 1.0
    err = float((got.detach() - want.detach()).abs().max())
    assert err <= rel * scale, (err, scale)


def _close_grads(got, want):
    """Each gradient leaf within 1e-5 of its largest magnitude; a leaf under
    a thousandth of the largest leaf's (a conv bias that batch norm
    removes: its gradient is nought to rounding) within 1e-5 of that."""
    top = max(float(w.abs().max()) for w in want)
    for a, b in zip(got, want):
        _close(a, b, floor=top if float(b.abs().max()) < 1e-3 * top else 0.0)


def _varied(params, gen):
    """The class-conditional tables moved off γ = 1, β = 0, so that each
    class scales differently."""
    for layer, arrays in params.items():
        if "gamma" in arrays:
            arrays["gamma"] = 1.0 + 0.3 * torch.randn(arrays["gamma"].shape, generator=gen)
            arrays["beta"] = 0.3 * torch.randn(arrays["beta"].shape, generator=gen)
    return params


def _grads(out, tree, gen):
    r = torch.randn(out.shape, generator=gen)
    leaves = [t for a in tree.values() for t in a.values()]
    return torch.autograd.grad(torch.sum(out * r), leaves)


def _live(tree):
    return {l: {k: t.detach().clone().requires_grad_(True) for k, t in a.items()} for l, a in tree.items()}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_generator_forward_and_backward_match_plain(use_pallas):
    g = torch.Generator().manual_seed(1)
    net = ResNetGenerator(image_size=16, z_dim=8, widths=GEN_WIDTHS, use_pallas=use_pallas, generator=g)
    params, stats = net.init(g)
    params = _varied(params, g)
    z, y = torch.randn(B, 8, generator=g), torch.tensor([0, 3, 9, 3])
    for train in (True, False):
        p1, p2 = _live(params), _live(params)
        got, got_s = net.apply(p1, stats, z, y, train=train)
        want, want_s = plain.generator(p2, stats, z, y, GEN_WIDTHS, train=train)
        assert got.shape == (B, 16, 16, 3)
        _close(got, want)
        for layer in want_s:
            for k in ("mean", "var"):
                _close(got_s[layer][k], want_s[layer][k])
        if train:
            _close_grads(_grads(got, p1, torch.Generator().manual_seed(2)),
                         _grads(want, p2, torch.Generator().manual_seed(2)))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_discriminator_forward_backward_and_power_iteration_match_plain(use_pallas):
    g = torch.Generator().manual_seed(3)
    net = SNResNetDiscriminator(image_size=16, widths=DISC_WIDTHS, strides=DISC_STRIDES, use_pallas=use_pallas,
                                generator=g)
    params, stats = net.init(g)
    assert set(stats) == {"block1_c1", "block1_c2", "block1_c_sc", "block2_c1", "block2_c2", "block2_c_sc",
                          "block3_c1", "block3_c2", "block4_c1", "block4_c2", "l5", "l_y"}
    x, y = torch.randn(B, 16, 16, 3, generator=g), torch.tensor([1, 1, 7, 0])
    p1, p2 = _live(params), _live(params)
    got, got_s = net.apply(p1, stats, x, y, train=True)
    want, want_s = plain.discriminator(p2, stats, x, y, DISC_STRIDES)
    _close(got, want)
    for layer in want_s:
        _close(got_s[layer]["u"], want_s[layer]["u"])
        assert not torch.equal(got_s[layer]["u"], stats[layer]["u"])
    _close_grads(_grads(got, p1, torch.Generator().manual_seed(4)),
                 _grads(want, p2, torch.Generator().manual_seed(4)))
    # eval mode keeps the u it was given; the precomputed iteration is the same
    assert net.apply(params, stats, x, y, train=False)[1] is stats
    sn = net.power_iteration(params, stats)
    _close(net.apply(params, stats, x, y, train=True, sn=sn)[0], want)


def _cfg(use_pallas):
    cfg = get_config("cifar10_snresnet")
    cfg.image_size, cfg.z_dim, cfg.batch_size = 16, 8, B
    cfg.gen.widths, cfg.disc.widths, cfg.disc.strides = GEN_WIDTHS, DISC_WIDTHS, DISC_STRIDES
    cfg.clf.conv_blocks, cfg.clf.tail = ((8, 8), (8, 8)), (8, 8, 8)
    cfg.clf.input_noise = cfg.clf.block_dropout = 0.0
    cfg.zca, cfg.aug_translate, cfg.aug_flip = False, 0, False
    cfg.alpha_p_warmup_epochs = 0
    cfg.use_pallas = use_pallas
    return cfg


def _batches(data):
    rng = np.random.RandomState(5)

    def codes():
        return {"z": torch.from_numpy(rng.normal(size=(B, 8)).astype(np.float32)),
                "y_g": torch.from_numpy(rng.randint(0, 10, B))}

    def stream():
        il, iu = rng.randint(0, len(data.x_label), B), rng.randint(0, len(data.x_unlabel), B)
        return {"x_l": torch.from_numpy(data.x_label[il]), "y_l": torch.from_numpy(data.y_label[il]),
                "x_u": torch.from_numpy(data.x_unlabel[iu]), **codes()}

    return [{"d": stream(), "c": stream(), "g": codes()} for _ in range(N_STEPS)]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_three_train_steps_match_plain(use_pallas):
    cfg = _cfg(use_pallas)
    nets = make_networks(cfg)
    opts = make_optimizers(cfg, TOTAL)
    params, stats = {}, {}
    g = torch.Generator().manual_seed(7)
    for name, net in zip(("gen", "disc", "clf"), nets):
        params[name], stats[name] = net.init(g)
    params["gen"] = _varied(params["gen"], g)
    state = create_state(cfg, nets, opts, device="cpu", params=params, bn=stats)
    data = synthetic_dataset(16, 3, 10, n_train=64, n_test=8, num_labeled=16, seed=0)
    batches = _batches(data)
    lr = float(cfg.lr_c)
    want, per_step = plain.train_steps(params, stats, batches, {
        "alpha": cfg.alpha, "alpha_p": cfg.alpha_p, "gen_widths": GEN_WIDTHS, "disc_strides": DISC_STRIDES,
        "clf_blocks": cfg.clf.conv_blocks, "clf_tail": cfg.clf.tail, "lr": lr, "b1": cfg.adam_b1,
        "b2": cfg.adam_b2, "eps": cfg.adam_eps})
    step = S.make_train_step(cfg, nets, opts, TOTAL, pseudo_label_mode="argmax")
    for t, batch in enumerate(batches):
        with torch.no_grad():
            logits, _ = nets[2].apply(state.params["clf"], state.bn["clf"],
                                      ondevice.standard_pipeline(batch["d"]["x_u"]), train=True)
        assert torch.equal(torch.argmax(logits, -1), per_step[t][1]), f"pseudo-labels differ at step {t}"
        state, m = step(state, batch)
        for k, v in per_step[t][0].items():
            assert abs(float(m[k]) - v) <= 1e-5 * (1 + abs(v)), (t, k, float(m[k]), v)
    for player in ("gen", "disc", "clf"):
        errs = []
        for layer, arrays in want["params"][player].items():
            for name, w in arrays.items():
                err = (state.params[player][layer][name] - w).abs()
                assert float(err.max()) <= 2 * N_STEPS * lr, (player, layer, name, float(err.max()))
                errs.append(err.flatten())
        assert float((torch.cat(errs) <= lr / 100).float().mean()) >= 0.99, player
        for layer, arrays in want["stats"][player].items():
            for name, w in arrays.items():
                torch.testing.assert_close(state.bn[player][layer][name], w, rtol=1e-4, atol=1e-4)
    assert set(state.bn["disc"]) == set(stats["disc"])  # D's kept u, every layer's


@pytest.mark.parametrize("act", ["linear", "relu", "leaky_relu", "tanh"])
def test_per_sample_epilogue_plain_version_matches_autograd_of_its_formula(act):
    g = torch.Generator().manual_seed(11)
    x = torch.randn(3, 4, 5, 6, generator=g, requires_grad=True)
    k = torch.randn(3, 6, generator=g, requires_grad=True)
    b = torch.randn(3, 6, generator=g, requires_grad=True)
    got = sba.scale_bias_act_cond(x, k, b, act, 0.2)
    want = sba.apply_act(x * k[:, None, None, :] + b[:, None, None, :], act, 0.2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    cot = torch.randn(got.shape, generator=g)
    for a, w in zip(torch.autograd.grad(got, (x, k, b), cot), torch.autograd.grad(want, (x, k, b), cot)):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)
    with torch.no_grad():  # no autograd record: the forward alone
        torch.testing.assert_close(sba.scale_bias_act_cond(x, k, b, act, 0.2), want.detach(), rtol=0, atol=0)


SMALL = ["dataset=synthetic", "zca=False", "batch_size=4", "z_dim=8", "gen.widths=(16,16,16)", "disc.widths=(16,16,16,16)",
         "clf.conv_blocks=((8,8),(8,8))", "clf.tail=(8,8,8)", "epochs=4", "steps_per_epoch=2", "scan_steps=2",
         "log_every=1", "eval_every_epochs=1", "ckpt_every_epochs=1"]


def _args(cmd, workdir, *extra, sets=SMALL):
    out = [cmd, "--config", "cifar10_snresnet", "--workdir", str(workdir), "--device", "cpu"]
    for kv in sets:
        out += ["--set", kv]
    return out + list(extra)


def test_a_run_dir_saves_resumes_samples_and_evaluates(tmp_path, monkeypatch, capsys):
    Image = pytest.importorskip("PIL.Image")
    monkeypatch.setattr(loop, "MetricsLogger", functools.partial(MetricsLogger, use_tensorboard=False))
    cli.main(_args("train", tmp_path, "--max-steps", "2"))
    assert "done: step=2 " in capsys.readouterr().out
    run = os.path.join(tmp_path, "cifar10_snresnet")
    ckpt = torch.load(os.path.join(run, "ckpt", "2"), weights_only=True)
    assert sorted(ckpt["bn"]["disc"]) and all(set(a) == {"u"} for a in ckpt["bn"]["disc"].values())
    assert "l1" in ckpt["params"]["gen"] and "block2_b1" in ckpt["bn"]["gen"]

    cli.main(_args("train", tmp_path, "--max-steps", "2"))
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "done: step=4 " in out
    # a config rebuilt from the base config and the run dir's config.json builds the run's networks
    cfg = merge_saved(base_config(), os.path.join(run, "config.json"))
    assert cfg.arch == "snresnet" and isinstance(make_networks(cfg)[1], SNResNetDiscriminator)

    grid = str(tmp_path / "grid.png")
    cli.main(_args("sample", tmp_path, "--out", grid, "--n-per-class", "2", sets=[]))
    with Image.open(grid) as im:
        assert np.asarray(im).shape == (10 * 32, 2 * 32, 3)
    cli.main(_args("eval", tmp_path, sets=[]))
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("test error: ")
    for cmd in (["serve"], ["export", "--format", "pt2"]):
        with pytest.raises(SystemExit, match="SN-ResNet"):
            cli.main(_args(cmd[0], tmp_path, *cmd[1:], sets=[]))
