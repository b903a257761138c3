"""The StyleGAN2 pair of ``cifar10_stylegan2`` (the mapping and modulated
skip synthesis G, the ``orig`` D with the minibatch stddev and the
projection) on the CPU, against the plain reference
``tests/plain_stylegan2.py``, with ``use_pallas`` off and on (on the CPU
the kernels take their plain versions):

- G's and D's forward and their input and parameter gradients at widths
  8–16 on 16 × 16 images, stddev groups of 4, on seeded random weights,
  within 2e-5 of each tensor's largest magnitude (float32 through a
  dozen layers; the port's demodulation sums Σ_i s_i²·Σ_uv W² where the
  plain one sums (W·s)², a reordering worth a few ulps);
- the minibatch stddev's groups against a loop over them;
- two steps of ``make_train_step``, the first opening with D's R1 update,
  under ``tests/test_torch_snresnet.py``'s tolerances (the metrics within
  1e-5·(1 + |metric|), every parameter within 2·N·lr and 99% of each
  player's within lr/100, the statistics within 1e-4 absolute plus 1e-4
  relative), D's Adam count advanced twice by the R1 step;
- ``gradgradcheck`` in float64 of ``_Conv3x3`` and the three epilogue
  Functions through their CPU twins (float64 throughout, so the default
  tolerances), and the R1 step's gradient reaching D's parameters through
  the port's second-order Functions, by their counters;
- the stride-2 transposed conv's Functions (G's up-conv, D's stride-2
  conv whose input gradient it is) against cuDNN's ops to second order in
  float64, a step's calls of its kernel wrapper as its counter keys them,
  and ``use_pallas`` off and bfloat16 keeping cuDNN's path;
- a ``cli train`` run dir of ``cifar10_stylegan2`` (graphed chunks, eager
  on the CPU, R1 every 2 steps) that checkpoints w_avg and the EMA copy,
  resumes, samples and evaluates, and whose serving, ``.pt2`` export and
  data-dependent init refuse it by name.
"""

import collections
import functools
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import plain_stylegan2 as plain  # noqa: E402
from triplegan_tpu_torch import cli  # noqa: E402
from triplegan_tpu_torch.configs import REGISTRY, get_config, make_networks  # noqa: E402
from triplegan_tpu_torch.configs.base import base_config, merge_saved  # noqa: E402
from triplegan_tpu_torch.data.datasets import synthetic_dataset  # noqa: E402
from triplegan_tpu_torch.export import check_servable  # noqa: E402
from triplegan_tpu_torch.nn import layers as L  # noqa: E402
from triplegan_tpu_torch.nn.networks import StyleGAN2Discriminator, StyleGAN2Generator  # noqa: E402
from triplegan_tpu_torch.ops import conv3x3 as C  # noqa: E402
from triplegan_tpu_torch.ops import scale_bias_act as sba  # noqa: E402
from triplegan_tpu_torch.train import loop  # noqa: E402
from triplegan_tpu_torch.train import step as S  # noqa: E402
from triplegan_tpu_torch.train.schedule import make_optimizers  # noqa: E402
from triplegan_tpu_torch.train.state import create_state  # noqa: E402
from triplegan_tpu_torch.utils.logging import MetricsLogger  # noqa: E402

torch.set_num_threads(1)
N_STEPS, TOTAL, B = 2, 16, 8
GEN_WIDTHS, DISC_WIDTHS, W_DIM, GROUP = (16, 16, 8), (8, 16, 16), 8, 4
HP = {"num_classes": 10, "gen_widths": GEN_WIDTHS, "map_layers": 2, "d_map_layers": 2, "group": GROUP}


def _close(got, want, rel=2e-5, floor=0.0):
    """|got − want| within ``rel`` of want's largest magnitude (or of
    ``floor``, if larger)."""
    scale = max(float(want.detach().abs().max()), floor) or 1.0
    err = float((got.detach() - want.detach()).abs().max())
    assert err <= rel * scale, (err, scale)


def _close_grads(got, want):
    """Each gradient leaf within 2e-5 of its largest magnitude; a leaf under
    a thousandth of the largest leaf's within 2e-5 of that."""
    top = max(float(w.abs().max()) for w in want)
    for a, b in zip(got, want):
        _close(a, b, floor=top if float(b.abs().max()) < 1e-3 * top else 0.0)


def _live(tree):
    return {l: {k: t.detach().clone().requires_grad_(True) for k, t in a.items()} for l, a in tree.items()}


def _leaves(tree):
    return [t for a in tree.values() for t in a.values()]


def _nets(use_pallas, gen):
    g = StyleGAN2Generator(image_size=16, z_dim=8, w_dim=W_DIM, widths=GEN_WIDTHS, use_pallas=use_pallas,
                           generator=gen)
    d = StyleGAN2Discriminator(image_size=16, widths=DISC_WIDTHS, cmap_dim=8, map_layers=2, mbstd_group=GROUP,
                               use_pallas=use_pallas, generator=gen)
    return g, d


@pytest.mark.parametrize("use_pallas", [False, True])
def test_generator_forward_and_gradients_match_plain(use_pallas):
    g = torch.Generator().manual_seed(1)
    net, _ = _nets(use_pallas, g)
    params, stats = net.init(g)
    assert set(stats["map1"]) == {"w_ema", "b_ema", "w_avg"}
    z, y = torch.randn(B, 8, generator=g), torch.tensor([0, 3, 9, 3, 1, 1, 7, 2])
    p1, p2 = _live(params), _live(params)
    got, got_s = net.apply(p1, stats, z, y, train=True, generator=torch.Generator().manual_seed(5))
    want, w = plain.generator(p2, z, y, HP, torch.Generator().manual_seed(5))
    assert got.shape == (B, 16, 16, 3)
    _close(got, want)
    _close(got_s["map1"]["w_avg"], w.detach().mean(0).lerp(stats["map1"]["w_avg"], 0.995))
    cot = torch.randn(got.shape, generator=g)
    _close_grads(torch.autograd.grad(got, _leaves(p1), cot), torch.autograd.grad(want, _leaves(p2), cot))
    # no generator: no noise term; eval mode keeps the stats it was given
    out, same = net.apply(params, stats, z, y, train=False)
    assert same is stats
    _close(out, plain.generator(params, z, y, HP)[0])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("streams", [1, 2])
def test_discriminator_forward_and_gradients_match_plain(use_pallas, streams):
    g = torch.Generator().manual_seed(3)
    _, net = _nets(use_pallas, g)
    params, stats = net.init(g)
    assert stats == {}
    x, y = torch.randn(B, 16, 16, 3, generator=g), torch.randint(0, 10, (B,), generator=g)
    x1, x2 = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    p1, p2 = _live(params), _live(params)
    got, _ = net.apply(p1, stats, x1, y, train=True, streams=streams)
    want = plain.discriminator(p2, x2, y, HP, streams=streams)
    _close(got, want)
    cot = torch.randn(B, generator=g)
    _close_grads(torch.autograd.grad(got, [x1] + _leaves(p1), cot), torch.autograd.grad(want, [x2] + _leaves(p2), cot))


def test_the_minibatch_stddev_groups_stand_rows_apart_within_each_stream():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(16, 2, 3, 6, generator=g)
    out = L.minibatch_stddev(x, group=4, channels=2, streams=2)
    assert out.shape == (16, 2, 3, 8) and torch.equal(out[..., :6], x)
    for s in range(2):          # each stream of 8 rows: 2 groups of 4, rows j, j + 2, j + 4, j + 6
        for j in range(2):
            rows = [8 * s + j + 2 * i for i in range(4)]
            grp = x[rows].reshape(4, 2, 3, 2, 3)
            want = torch.sqrt(grp.var(dim=0, unbiased=False) + 1e-8).mean(dim=(0, 1, 3))
            for r in rows:
                torch.testing.assert_close(out[r, :, :, 6:], want.expand(2, 3, 2), rtol=1e-6, atol=1e-7)
    # one stream of 16: the groups cross the two halves, and the planes differ
    assert not torch.allclose(L.minibatch_stddev(x, 4, 2, 1)[..., 6:], out[..., 6:])


def _cfg(use_pallas):
    cfg = get_config("cifar10_stylegan2")
    cfg.image_size, cfg.z_dim, cfg.batch_size = 16, 8, B
    cfg.gen.widths, cfg.gen.w_dim = GEN_WIDTHS, W_DIM
    cfg.disc.widths, cfg.disc.cmap_dim, cfg.disc.map_layers, cfg.disc.mbstd_group = DISC_WIDTHS, 8, 2, GROUP
    cfg.clf.conv_blocks, cfg.clf.tail = ((8, 8), (8, 8)), (8, 8, 8)
    cfg.clf.input_noise = cfg.clf.block_dropout = 0.0
    cfg.zca, cfg.aug_translate, cfg.aug_flip = False, 0, False
    cfg.alpha_p_warmup_epochs = 0
    cfg.r1_interval = 2
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
def test_two_train_steps_one_with_r1_match_plain(use_pallas):
    cfg = _cfg(use_pallas)
    nets = make_networks(cfg)
    opts = make_optimizers(cfg, TOTAL)
    params, stats = {}, {}
    g = torch.Generator().manual_seed(7)
    for name, net in zip(("gen", "disc", "clf"), nets):
        params[name], stats[name] = net.init(g)
    state = create_state(cfg, nets, opts, device="cpu", params=params, bn=stats, seed=11)
    data = synthetic_dataset(16, 3, 10, n_train=64, n_test=8, num_labeled=16, seed=0)
    batches = _batches(data)
    step = S.make_train_step(cfg, nets, opts, TOTAL, pseudo_label_mode="argmax")
    lr = float(cfg.lr_c)
    betas = [step.values(t, {p: 0 for p in S.PLAYERS}, step.regularises(t))[11] for t in range(N_STEPS)]
    assert betas[0] == 0.0 and 0 < betas[1] < 1e-5  # 0.5^(B / (0.05·B·step))
    want, per_step = plain.train_steps(params, stats, batches, {
        **HP, "alpha": cfg.alpha, "alpha_p": cfg.alpha_p, "clf_blocks": cfg.clf.conv_blocks, "clf_tail": cfg.clf.tail,
        "lr": lr, "b1": cfg.adam_b1, "b2": cfg.adam_b2, "eps": cfg.adam_eps, "r1_weight": 0.01 / 2 * 2,
        "ema_betas": betas, "w_avg_beta": 0.995},
        [S.step_generator("cpu", state.seed, t) for t in range(N_STEPS)], [step.regularises(t) for t in range(N_STEPS)])
    assert [step.regularises(t) for t in range(N_STEPS)] == [True, False] and per_step[0][2] > 0
    for t, batch in enumerate(batches):
        state, m = step(state, batch)
        for k, v in per_step[t][0].items():
            assert abs(float(m[k]) - v) <= 1e-5 * (1 + abs(v)), (t, k, float(m[k]), v)
    assert {p: o.count for p, o in state.opt.items()} == want["counts"] == {"gen": 2, "disc": 3, "clf": 2}
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


def test_the_r1_steps_gradient_reaches_d_through_the_second_order_functions():
    cfg = _cfg(True)
    nets = make_networks(cfg)
    opts = make_optimizers(cfg, TOTAL)
    state = create_state(cfg, nets, opts, device="cpu", seed=2)
    batch = _batches(synthetic_dataset(16, 3, 10, n_train=64, n_test=8, num_labeled=16, seed=0))[0]
    step = S.make_train_step(cfg, nets, opts, TOTAL, pseudo_label_mode="argmax")
    for counter in (C.second_order_launches, sba.second_order_launches):
        counter.clear()
    d0 = {l: {k: t.clone() for k, t in a.items()} for l, a in state.params["disc"].items()}
    step(dataclasses_replace(state, step=1), batch)  # a plain step: nothing second order
    assert not C.second_order_launches and not sba.second_order_launches
    state, _ = step(state, batch)  # step 0 carries R1
    roles = {k[0] for k in C.second_order_launches}
    assert {"dgrad2", "wgrad2"} <= roles, roles
    # D's 3×3 stride-1 convs at 16, 8 and 4 (the 4×4 one of 17 channels) ran their input gradients as Functions
    assert {(k[3], k[4]) for k in C.second_order_launches if k[0] == "dgrad2"} >= {(16, 8), (8, 16), (4, 16)}
    assert {k[0] for k in sba.second_order_launches} == {"channel"}
    assert all(not torch.equal(state.params["disc"][l][k], d0[l][k]) for l in d0 for k in d0[l])


def dataclasses_replace(state, **kw):
    import dataclasses

    return dataclasses.replace(state, **kw)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_the_conv_function_is_twice_differentiable(padding):
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 5, 4, 3, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(3, 3, 3, 4, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradgradcheck(lambda x, w: C._Conv3x3.apply(x, w, padding), (x, w))
    gy = torch.randn(2, 3 if padding == "VALID" else 5, 2 if padding == "VALID" else 4, 4, generator=g,
                     dtype=torch.float64, requires_grad=True)
    p = C._PAD[padding]
    assert torch.autograd.gradcheck(lambda x, gy: C._Conv3x3Wgrad.apply(x, gy, p), (x, gy))


@pytest.mark.parametrize("hw", [4, 8, 16])
@pytest.mark.parametrize("op", ["up", "down"])
def test_the_stride2_transposed_conv_functions_match_cudnns_ops_to_second_order(op, hw):
    """``_TConv3x3S2`` (the up-conv's, at G's sizes h → 2h + 1) and
    ``_Conv3x3S2`` (the stride-2 conv whose input gradient is the
    transposed conv, at D's 2h + 1 → h) in float64 through their CPU
    twins: forward and both gradients against ``F.conv_transpose2d`` and
    ``F.conv2d(stride=2)`` and their autograd, and ``gradgradcheck``."""
    g = torch.Generator().manual_seed(13 + hw)
    d = torch.float64
    if op == "up":
        x = torch.randn(2, hw, hw, 5, generator=g, dtype=d)
        w = torch.randn(3, 3, 5, 4, generator=g, dtype=d)
        fn = lambda x, w: C._TConv3x3S2.apply(x, w, "up")  # noqa: E731
        ref = lambda x, w: F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1), stride=2)  # noqa: E731
    else:
        x = torch.randn(2, 2 * hw + 1, 2 * hw + 1, 5, generator=g, dtype=d)
        w = torch.randn(4, 5, 3, 3, generator=g, dtype=d)
        fn = C._Conv3x3S2.apply
        ref = lambda x, w: F.conv2d(x.permute(0, 3, 1, 2), w, stride=2)  # noqa: E731
    x1, w1, x2, w2 = (t.clone().requires_grad_(True) for t in (x, w, x, w))
    got, want = fn(x1, w1), ref(x2, w2).permute(0, 2, 3, 1)
    assert got.shape == want.shape == ((2, 2 * hw + 1, 2 * hw + 1, 4) if op == "up" else (2, hw, hw, 4))
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    cot = torch.randn(got.shape, generator=g, dtype=d)
    for a, b in zip(torch.autograd.grad(got, (x1, w1), cot), torch.autograd.grad(want, (x2, w2), cot)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradgradcheck(fn, (x1, w1))


def _spy_tconv(monkeypatch):
    """The calls of ``tconv3x3_s2``, keyed as its launch counter keys them
    on the card: (role, N, h, w, Cin, Cout, dtype)."""
    calls = collections.Counter()
    real = C.tconv3x3_s2

    def spy(x, w, role="up"):
        calls[(role, *x.shape, w.shape[3], str(x.dtype).split(".")[-1])] += 1
        return real(x, w, role)

    monkeypatch.setattr(C, "tconv3x3_s2", spy)
    return calls


def test_a_step_runs_the_transposed_conv_for_each_up_conv_pass_and_stride2_input_gradient(monkeypatch):
    """In the kernel arm a plain step runs ``tconv3x3_s2`` for G's two
    up-convs (16 → 16 at 4 → 9, 16 → 8 at 8 → 17) in each of its three
    passes, and for the input gradients of D's two stride-2 convs in the
    D update (3B rows) and the G update (B rows); a step that opens with R1
    adds two a stride-2 conv at B rows, the recorded input gradient and the
    penalty's gradient through D's forward again. The keys are the launch
    counter's, and ``chip_smoke.hand_kernels_per_step`` maps them to the
    kernel's launches a step."""
    calls = _spy_tconv(monkeypatch)
    cfg = _cfg(True)
    nets = make_networks(cfg)
    opts = make_optimizers(cfg, TOTAL)
    state = create_state(cfg, nets, opts, device="cpu", seed=2)
    batch = _batches(synthetic_dataset(16, 3, 10, n_train=64, n_test=8, num_labeled=16, seed=0))[0]
    step = S.make_train_step(cfg, nets, opts, TOTAL, pseudo_label_mode="argmax")
    up = {("up", B, 4, 4, 16, 16, "float32"): 3, ("up", B, 8, 8, 16, 8, "float32"): 3}
    dgrad = {("dgrad", n, h, h, 16, c, "float32"): 1 for n in (B, 3 * B) for h, c in ((4, 16), (8, 8))}
    step(dataclasses_replace(state, step=1), batch)
    assert calls == {**up, **dgrad}
    calls.clear()
    step(state, batch)  # step 0 carries R1
    assert calls == {**up, **dgrad, **{("dgrad", B, h, h, 16, c, "float32"): 3 for h, c in ((4, 16), (8, 8))}}
    chip_smoke = pytest.importorskip("chip_smoke")
    moments = {"bn_moments": collections.Counter(), "bn_moments_bwd": collections.Counter()}
    counts = {"conv3x3_fwd": collections.Counter(), "conv3x3_wgrad": collections.Counter(),
              "scale_bias_act": collections.Counter(), "scale_bias_act_bwd": collections.Counter(),
              "conv3x3_tconv": calls}
    assert chip_smoke.hand_kernels_per_step(counts, 2, moments)["tconv"] == 7


@pytest.mark.parametrize("use_pallas, dtype, takes", [(False, torch.float32, False), (True, torch.bfloat16, False),
                                                      (True, torch.float32, True)])
def test_the_transposed_direction_takes_the_kernel_only_in_the_kernel_arm_at_float32(monkeypatch, use_pallas,
                                                                                     dtype, takes):
    """``up_conv`` and ``down_conv``: with ``use_pallas`` off, and at
    bfloat16, cuDNN's path (``F.conv_transpose2d``, the autograd of
    ``F.conv2d``) as before, and no call of the kernel's wrapper or its
    Functions; in the kernel arm at float32 the up-conv's forward and the
    stride-2 conv's input gradient on ``tconv3x3_s2``. The result is the
    same either way."""
    calls = _spy_tconv(monkeypatch)
    library = collections.Counter()
    real_t = F.conv_transpose2d

    def conv_transpose2d(*a, **kw):
        library["conv_transpose2d"] += 1
        return real_t(*a, **kw)

    monkeypatch.setattr(F, "conv_transpose2d", conv_transpose2d)
    g = torch.Generator().manual_seed(14)
    x = torch.randn(2, 4, 4, 16, generator=g).to(dtype).requires_grad_(True)
    w = torch.randn(8, 16, 3, 3, generator=g).requires_grad_(True)
    up = L.up_conv(x, w, use_pallas)
    down = L.down_conv(up, w.transpose(0, 1), use_pallas)
    dx, dw = torch.autograd.grad(down.float().square().sum(), (x, w))
    assert up.shape == (2, 8, 8, 8) and down.shape == (2, 4, 4, 16)
    if takes:  # the library's calls are the wrapper's CPU twin's
        assert calls == {("up", 2, 4, 4, 16, 8, "float32"): 1, ("dgrad", 2, 4, 4, 16, 8, "float32"): 1}
        assert library["conv_transpose2d"] == 2
    else:  # the up-conv's forward; the stride-2 conv's input gradient is autograd's
        assert not calls and library["conv_transpose2d"] == 1
    x2, w2 = x.detach().float().requires_grad_(True), w.detach().clone().requires_grad_(True)
    u2 = L.upfirdn(real_t(x2.permute(0, 3, 1, 2), w2.transpose(0, 1), stride=2).permute(0, 2, 3, 1), pad=1, gain=4.0)
    y2 = F.conv2d(L.upfirdn(u2, pad=2).permute(0, 3, 1, 2), w2.transpose(0, 1), stride=2).permute(0, 2, 3, 1)
    if dtype == torch.float32:
        torch.testing.assert_close(down, y2, rtol=1e-5, atol=1e-5)
        for a, b in zip((dx, dw), torch.autograd.grad(y2.square().sum(), (x2, w2))):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant, act", [("channel", "leaky_relu"), ("channel", "tanh"), ("sample", "linear"),
                                          ("sample", "relu"), ("noise", "leaky_relu"), ("noise", "tanh")])
def test_the_epilogue_functions_are_twice_differentiable(variant, act):
    g = torch.Generator().manual_seed(9)
    d = torch.float64
    x = torch.randn(3, 4, 5, 6, generator=g, dtype=d, requires_grad=True)
    kc, kn = (torch.randn(s, generator=g, dtype=d, requires_grad=True) for s in ((6,), (3, 6)))
    bc, bn = (torch.randn(s, generator=g, dtype=d, requires_grad=True) for s in ((6,), (3, 6)))
    q = torch.randn(3, 4, 5, generator=g, dtype=d, requires_grad=True)
    if variant == "channel":
        fn, args = (lambda x, k, b: sba._ScaleBiasAct.apply(x, k, b, act, 0.2)), (x, kc, bc)
    elif variant == "sample":
        fn, args = (lambda x, k, b: sba._ScaleBiasActCond.apply(x, k, b, act, 0.2)), (x, kn, bn)
    else:  # a clamp of 1.5 that some outputs reach
        fn, args = (lambda x, k, b, q: sba._ScaleBiasActNoise.apply(x, k, b, q, act, 0.2, 1.5)), (x, kn, bc, q)
    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)


@pytest.mark.parametrize("act", ["linear", "leaky_relu", "tanh"])
def test_the_noise_epilogue_plain_version_matches_autograd_of_its_formula(act):
    g = torch.Generator().manual_seed(12)
    x = torch.randn(3, 4, 5, 6, generator=g, requires_grad=True)
    k = torch.randn(3, 6, generator=g, requires_grad=True)
    b = torch.randn(6, generator=g, requires_grad=True)
    q = torch.randn(3, 4, 5, generator=g, requires_grad=True)
    got = sba.scale_bias_act_noise(x, k, b, q, act, 0.2, 1.0)
    want = torch.clamp(sba.apply_act(x * k[:, None, None, :] + b + q[..., None], act, 0.2), -1.0, 1.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    cot = torch.randn(got.shape, generator=g)
    for a, w in zip(torch.autograd.grad(got, (x, k, b, q), cot), torch.autograd.grad(want, (x, k, b, q), cot)):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


def test_the_configuration_is_registered_and_refused_for_serving_by_name():
    cfg = get_config("cifar10_stylegan2")
    assert "cifar10_stylegan2" in REGISTRY and cfg.arch == "stylegan2"
    with pytest.raises(KeyError, match="cifar10_stylegan2"):  # the CLI's list of configurations
        get_config("no_such_config")
    gen, disc, _ = make_networks(cfg)
    assert isinstance(gen, StyleGAN2Generator) and isinstance(disc, StyleGAN2Discriminator)
    assert gen.widths == (512,) * 4 and disc.mbstd_group == 32 and cfg.r1_interval == 16
    with pytest.raises(ValueError, match="StyleGAN2"):
        check_servable(cfg)


SMALL = ["dataset=synthetic", "zca=False", "batch_size=8", "z_dim=8", "gen.widths=(16,16,8)", "gen.w_dim=8",
         "disc.widths=(8,16,16)", "disc.cmap_dim=8", "disc.map_layers=2", "disc.mbstd_group=4", "image_size=16",
         "clf.conv_blocks=((8,8),(8,8))", "clf.tail=(8,8,8)", "epochs=4", "steps_per_epoch=2", "scan_steps=2",
         "r1_interval=2", "log_every=1", "eval_every_epochs=1", "ckpt_every_epochs=1"]


def _args(cmd, workdir, *extra, sets=SMALL):
    out = [cmd, "--config", "cifar10_stylegan2", "--workdir", str(workdir), "--device", "cpu"]
    for kv in sets:
        out += ["--set", kv]
    return out + list(extra)


def test_a_run_dir_saves_resumes_samples_and_evaluates(tmp_path, monkeypatch, capsys):
    Image = pytest.importorskip("PIL.Image")
    monkeypatch.setattr(loop, "MetricsLogger", functools.partial(MetricsLogger, use_tensorboard=False))
    cli.main(_args("train", tmp_path, "--max-steps", "2"))
    assert "done: step=2 " in capsys.readouterr().out
    run = os.path.join(tmp_path, "cifar10_stylegan2")
    ckpt = torch.load(os.path.join(run, "ckpt", "2"), weights_only=True)
    assert ckpt["opt"]["disc"]["count"] == 3 and ckpt["opt"]["gen"]["count"] == 2  # step 0 carried R1
    assert "w_avg" in ckpt["bn"]["gen"]["map1"] and "w_ema" in ckpt["bn"]["gen"]["b16_conv1"]
    assert not torch.equal(ckpt["bn"]["gen"]["b16_conv1"]["w_ema"], ckpt["params"]["gen"]["b16_conv1"]["w"])

    cli.main(_args("train", tmp_path, "--max-steps", "2"))
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "done: step=4 " in out
    assert torch.load(os.path.join(run, "ckpt", "4"), weights_only=True)["opt"]["disc"]["count"] == 6
    # a config rebuilt from the base config and the run dir's config.json builds the run's networks
    cfg = merge_saved(base_config(), os.path.join(run, "config.json"))
    assert cfg.arch == "stylegan2" and cfg.r1_interval == 2 and cfg.gen.w_dim == 8
    assert isinstance(make_networks(cfg)[0], StyleGAN2Generator)

    grid = str(tmp_path / "grid.png")
    cli.main(_args("sample", tmp_path, "--out", grid, "--n-per-class", "2", sets=[]))
    with Image.open(grid) as im:
        assert np.asarray(im).shape == (10 * 16, 2 * 16, 3)
    cli.main(_args("eval", tmp_path, sets=[]))
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("test error: ")
    for cmd in (["serve"], ["export", "--format", "pt2"]):
        with pytest.raises(SystemExit, match="StyleGAN2"):
            cli.main(_args(cmd[0], tmp_path, *cmd[1:], sets=[]))
    with pytest.raises(ValueError, match="ddinit.*'stylegan2'"):
        cli.main(_args("train", tmp_path / "fresh", "--max-steps", "1", sets=SMALL + ["ddinit=True"]))


def test_the_ema_beta_ramps_to_the_half_life():
    cfg = get_config("cifar10_stylegan2")
    nets = make_networks(_tiny_nets(cfg))
    step = S.make_train_step(cfg, nets, make_optimizers(cfg, 781_000), 781_000)
    beta = {t: step.values(t, {p: 0 for p in S.PLAYERS}, step.regularises(t))[11] for t in (100, 156_208, 200_000)}
    assert beta[100] == pytest.approx(0.5 ** (64 / (0.05 * 64 * 100)), rel=1e-12)
    assert beta[156_208] == pytest.approx(0.5 ** (64 / (0.05 * 64 * 156_208)), rel=1e-12)  # still ramping
    assert beta[200_000] == pytest.approx(0.5 ** (64 / 500_000), rel=1e-12)  # the half-life of 500 kimg
    assert math.isclose(step.values(16, {"gen": 0, "disc": 5, "clf": 0}, step.regularises(16))[12:15][0], 3e-4)


def _tiny_nets(cfg):
    """The registry config with its networks cut to a tiny size, for a
    step built without its weights."""
    cfg.gen.widths, cfg.gen.w_dim, cfg.z_dim = (8, 8, 8, 8), 8, 8
    cfg.disc.widths, cfg.disc.cmap_dim = (8, 8, 8, 8), 8
    return cfg
