"""triplegan_tpu_torch.ops.conv3x3 against the JAX package's Pallas conv
(``triplegan_tpu/ops/pallas_conv.py``, interpreted on the CPU as
tests/test_ops_conv.py runs it).

On the CPU the port's wrappers take their plain versions (nine shifted
matmuls accumulated in float32), so these tests hold the plain versions,
the halo read of the kernel's interface, and the autograd Function's
backward (dx through the forward on the halo-padded cotangent against the
flipped kernel, dw through wgrad) to the TPU kernels' semantics: forward,
dx and dw, SAME and VALID, Cin 3, 13 and 16 (below the Pallas kernel's
Cin 8 limit on the TPU, which interpret mode does not have), an odd
spatial size, float32 and bfloat16.

Tolerances. float32: atol = rtol = 1e-5 (the same float32 sums in another
order). bfloat16: the forward and dx are float32 sums rounded once to
bfloat16 on both sides, so they may differ by one bfloat16 ulp of the
value, held as at most 2 ulps of the largest |value|; dw is float32 on
both sides (exact bf16 products summed in float32): rtol = atol = 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from triplegan_tpu.ops import pallas_conv as JC  # noqa: E402
from triplegan_tpu_torch.ops import build  # noqa: E402
from triplegan_tpu_torch.ops import conv3x3 as cv  # noqa: E402

torch.set_num_threads(1)
_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _ulp_of_max(a: np.ndarray) -> float:
    m = float(np.max(np.abs(a)))
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _close(got, want, dtype, exact_f32=False):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if dtype == "float32" or exact_f32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.max(np.abs(got - want)) <= 2 * _ulp_of_max(want)


def _inputs(n, h, w, cin, cout, padding, seed):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    ho, wo = (h, w) if padding == "SAME" else (h - 2, w - 2)
    g = rng.normal(size=(n, ho, wo, cout)).astype(np.float32)
    return x, wt, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("cin", [3, 13, 16])
def test_conv3x3_forward_and_grads_match_jax(cin, padding, dtype):
    jdt, tdt = _DT[dtype]
    x, wt, g = _inputs(2, 7, 9, cin, 12, padding, seed=cin)
    # JAX: x in the compute dtype, w float32 (cast inside, as the networks do)
    jx, jw, jg = jnp.asarray(x).astype(jdt), jnp.asarray(wt), jnp.asarray(g).astype(jdt)
    y_j, vjp = jax.vjp(lambda a, b: JC.conv3x3(a, b, padding, True), jx, jw)
    dx_j, dw_j = vjp(jg)

    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(wt).requires_grad_()
    y_t = cv.conv3x3(tx, tw, padding)
    dx_t, dw_t = torch.autograd.grad(y_t, (tx, tw), torch.from_numpy(g).to(tdt))
    assert y_t.dtype == dx_t.dtype == tdt and dw_t.dtype == torch.float32

    _close(y_t.detach().float().numpy(), np.asarray(y_j.astype(jnp.float32)), dtype)
    _close(dx_t.float().numpy(), np.asarray(dx_j.astype(jnp.float32)), dtype)
    _close(dw_t.numpy(), np.asarray(dw_j), dtype, exact_f32=True)


@pytest.mark.parametrize("pad", [0, 1, 2])
def test_halo_read_equals_jax_pad_then_nopad(pad):
    x, wt, _ = _inputs(3, 6, 5, 13, 8, "SAME", seed=7)
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    want = JC.conv3x3_nopad(jnp.asarray(xp), jnp.asarray(wt), interpret=True)
    got = cv.conv3x3_nopad(torch.from_numpy(x), torch.from_numpy(wt), pad)
    _close(got.numpy(), np.asarray(want), "float32")
    g = np.random.RandomState(8).normal(size=want.shape).astype(np.float32)
    want_dw = JC.conv3x3_wgrad(jnp.asarray(xp), jnp.asarray(g), interpret=True)
    got_dw = cv.conv3x3_wgrad(torch.from_numpy(x), torch.from_numpy(g), pad)
    _close(got_dw.numpy(), np.asarray(want_dw), "float32")


def test_plain_versions_match_jax_on_prepadded_input():
    rng = np.random.RandomState(9)
    xp = rng.normal(size=(2, 9, 7, 16)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, 16, 24)) * 0.1).astype(np.float32)
    g = rng.normal(size=(2, 7, 5, 24)).astype(np.float32)
    _close(cv.reference_conv3x3_nopad(torch.from_numpy(xp), torch.from_numpy(wt)).numpy(),
           np.asarray(JC.conv3x3_nopad(jnp.asarray(xp), jnp.asarray(wt), interpret=True)),
           "float32")
    _close(cv.reference_conv3x3_wgrad(torch.from_numpy(xp), torch.from_numpy(g)).numpy(),
           np.asarray(JC.conv3x3_wgrad(jnp.asarray(xp), jnp.asarray(g), interpret=True)),
           "float32")
    x = xp[:, 1:-1, 1:-1]
    _close(cv.reference_conv3x3(torch.from_numpy(x), torch.from_numpy(wt), "SAME").numpy(),
           np.asarray(JC.reference_conv3x3(jnp.asarray(x), jnp.asarray(wt), "SAME")), "float32")


def test_input_gradient_skipped_for_data_inputs(monkeypatch):
    """C's first conv takes data: its backward computes dw only."""
    calls = []
    real = cv.conv3x3_nopad

    def spy(x, w, pad=0):
        calls.append(pad)
        return real(x, w, pad)

    monkeypatch.setattr(cv, "conv3x3_nopad", spy)
    x = torch.randn(2, 5, 5, 3)
    w = torch.randn(3, 3, 3, 4, requires_grad=True)
    y = cv.conv3x3(x, w, "SAME")
    (dw,) = torch.autograd.grad(y.sum(), (w,))
    assert calls == [1]  # the forward only: no dgrad launch
    assert dw.shape == w.shape


def test_cpu_call_does_not_count_or_build(monkeypatch):
    def no_nvcc():
        raise AssertionError("a CPU call must not build the kernel")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    before = (cv.fwd_launches.copy(), cv.wgrad_launches.copy(), cv.fwd_block_launches.copy(),
              cv.wino_launches.copy())
    for dtype in (torch.float32, torch.bfloat16):  # bfloat16 would take conv3x3_sm90 on the card
        x = torch.randn(2, 5, 5, 4, dtype=dtype, requires_grad=True)
        w = torch.randn(3, 3, 4, 6, requires_grad=True)
        torch.autograd.grad(cv.conv3x3(x, w).float().sum(), (x, w))
        cv.conv3x3_wgrad(x.detach(), torch.randn(2, 5, 5, 6, dtype=dtype), 1)
    # a shape the card would send through the Winograd pipeline
    x, w = torch.randn(1, 32, 32, 64), torch.randn(3, 3, 64, 32)
    assert cv.f32_wino_plan(1, 32, 32, 64, 32) is not None
    assert torch.equal(cv.conv3x3_nopad(x, w, 1), cv.reference_conv3x3_nopad(cv._pad_hw(x, 1), w))
    assert (cv.fwd_launches, cv.wgrad_launches, cv.fwd_block_launches, cv.wino_launches) == before
    assert "conv3x3" not in build._loaded and "conv3x3_sm90" not in build._loaded


def test_wrappers_reject_what_they_cannot_take():
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="SAME or VALID"):
        cv.conv3x3(x, torch.zeros(3, 3, 2, 2), "FULL")
    with pytest.raises(ValueError, match="halo"):
        cv.conv3x3_nopad(x, torch.zeros(3, 3, 2, 2), 3)
    with pytest.raises(ValueError, match="smaller than"):
        cv.conv3x3_nopad(torch.zeros(1, 2, 2, 2), torch.zeros(3, 3, 2, 2), 0)
    with pytest.raises(ValueError, match="g must be"):
        cv.conv3x3_wgrad(x, torch.zeros(1, 3, 3, 2), 1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        cv.conv3x3_nopad(x.to("meta"), torch.zeros(3, 3, 2, 2, device="meta"), 1)


# (M = N·Ho·Wo, Cin, Cout) of every float32 wgrad of the shipped train
# step, and a few edges: one pixel short of a chunk, a tiny M, Cin 6.
_F32_WGRAD_SHAPES = [(100 * 32 * 32, 3, 128), (100 * 32 * 32, 128, 128), (100 * 16 * 16, 128, 256),
                     (100 * 16 * 16, 256, 256), (100 * 6 * 6, 256, 512), (300 * 32 * 32, 13, 32),
                     (300 * 16 * 16, 42, 64), (300 * 8 * 8, 74, 128), (100 * 16 * 16, 128, 12),
                     (100 * 8 * 8, 256, 512), (100 * 4 * 4, 512, 1024), (384 * 16 * 16, 256, 256),
                     (1152 * 32 * 32, 13, 32), (17, 3, 12), (1023, 6, 33), (64 * 16 * 16, 42, 64)]


def test_wgrad_splits_cover_the_reduction_exactly():
    """The float32 wgrad plan: 32 rows of K where K <= 32 (128 columns),
    else 128 rows and a block width that holds Cout (or tiles of 128),
    chunks that cover the M reduction exactly, at most two waves of 264
    blocks (four where the output tiles alone are more than one), chunks
    of at least 512 pixels once split, and the same plan for the same
    shapes."""
    for m, cin, cout in _F32_WGRAD_SHAPES:
        bm, bn, splits, chunk = cv.f32_wgrad_plan(m, cin, cout)
        assert (bm, bn, splits, chunk) == cv.f32_wgrad_plan(m, cin, cout)  # the shape alone decides
        if 9 * cin <= 32:
            assert (bm, bn) == (32, 128)
        else:
            assert bm == 128 and bn in (32, 64, 128)
            assert (bn >= cout or bn == 128) and (bn == 32 or bn // 2 < cout)
        assert chunk % 16 == 0 and splits >= 1
        assert splits * chunk >= m > (splits - 1) * chunk
        tiles = -(-9 * cin // bm) * -(-cout // bn)
        assert splits == 1 or splits * tiles <= (2 if tiles <= 264 else 4) * 264
        assert splits == 1 or chunk >= 512


def test_f32_wgrad_plan_fills_the_card():
    """The shipped step's widest float32 wgrads, whose reductions are long
    enough to split freely, fill at least 90% of the waves they take (C's
    (100,32,32,128)->128: 9 output tiles of 128×128 split 29 ways, 261
    blocks in one wave of 264)."""
    assert cv.f32_wgrad_plan(100 * 32 * 32, 128, 128) == (128, 128, 29, 3536)
    for m, cin, cout in [(100 * 32 * 32, 128, 128), (100 * 16 * 16, 128, 256),
                         (100 * 16 * 16, 256, 256), (300 * 32 * 32, 13, 32), (300 * 16 * 16, 42, 64)]:
        bm, bn, splits, _ = cv.f32_wgrad_plan(m, cin, cout)
        blocks = splits * -(-9 * cin // bm) * -(-cout // bn)
        assert blocks / (-(-blocks // 264) * 264) >= 0.9, (m, cin, cout, splits)


# (M, Cin, Cout) of every float32 forward and dgrad of the shipped train
# step and of serving, and a few edges.
_F32_FWD_SHAPES = [(100 * 32 * 32, 3, 128), (100 * 32 * 32, 128, 128), (100 * 16 * 16, 128, 256),
                   (100 * 16 * 16, 256, 256), (100 * 6 * 6, 256, 512), (100 * 32 * 32, 13, 32),
                   (300 * 32 * 32, 13, 32), (100 * 16 * 16, 42, 64), (300 * 16 * 16, 42, 64),
                   (100 * 8 * 8, 74, 128), (300 * 8 * 8, 74, 128), (100 * 16 * 16, 128, 12),
                   (100 * 8 * 8, 256, 512), (100 * 4 * 4, 512, 1024), (100 * 16 * 16, 256, 128),
                   (100 * 8 * 8, 512, 256), (100 * 32 * 32, 32, 13), (100 * 16 * 16, 64, 42),
                   (300 * 16 * 16, 64, 42), (100 * 8 * 8, 128, 74), (300 * 8 * 8, 128, 74),
                   (100 * 16 * 16, 12, 128), (100 * 4 * 4, 1024, 512), (17, 3, 12), (192, 256, 512),
                   (17100, 64, 200)]


def test_f32_forward_plan_covers_k_and_fills_the_card():
    """The float32 forward plan: whole waves of output tiles run as they
    are, one block a tile; the K tiles of the tiles left over are cut into
    runs of at least 8 that save more than 16 K tiles against a whole
    tile, in at most one wave of 264 blocks; the workspace holds every
    partial tile a run can write; the same plan for the same shapes."""
    for m, cin, cout in _F32_FWD_SHAPES:
        bn, full, per, ws = cv.f32_fwd_plan(m, cin, cout)
        assert (bn, full, per, ws) == cv.f32_fwd_plan(m, cin, cout)  # the shape alone decides
        assert bn == cv.fwd_block_n(cout)
        bm = 256 if bn <= 32 else 128
        tiles = -(-m // bm) * -(-cout // bn)
        ktiles = -(-9 * cin // 16)
        if per == 0:
            assert full == tiles and ws == 0
            continue
        assert full % 264 == 0 and 0 < tiles - full < 264
        assert 8 <= per < ktiles - 16
        iters = (tiles - full) * ktiles
        blocks = -(-iters // per)
        assert tiles - full < blocks <= 264 and blocks * per >= iters > (blocks - 1) * per
        # the output tiles each run touches, counted one iteration at a time
        most = max(len({it // ktiles for it in range(b * per, min(iters, (b + 1) * per))})
                   for b in range(blocks))
        assert ws >= blocks * most * bm * bn
    # C's widest conv: 800 tiles of 128×128, 3 whole waves, and the 8 tiles
    # left over (8 × 72 K tiles) shared by 72 blocks, 8 K tiles each
    assert cv.f32_fwd_plan(100 * 32 * 32, 128, 128)[:3] == (128, 792, 8)
    # (100,16,16,256)->256: 400 tiles, one whole wave, 136 × 144 K tiles in 262 runs of 75
    assert cv.f32_fwd_plan(100 * 16 * 16, 256, 256)[:3] == (128, 264, 75)


@pytest.mark.parametrize("m,cin,cout", _F32_FWD_SHAPES)
def test_f32_forward_block_and_layout_follow_cout(m, cin, cout):
    """The float32 forward's block (the key of ``fwd_block_launches``): its
    rows, the plan's width, and the im2col tile k-major in every block but
    256 × 16 (Cout <= 16), a function of Cout alone."""
    bn = cv.f32_fwd_plan(m, cin, cout)[0]
    bm, bn_, layout = cv.f32_fwd_block(bn)
    assert bn_ == bn and bm == (256 if cout <= 32 else 128)
    assert layout == ("m-major" if cout <= 16 else "k-major")


def test_f32_forward_block_of_the_shipped_c_convs():
    # C's 3×3 convs of cifar10_4k, which carry most of the forward's work,
    # and their input gradients take the 128 × 128 block with k-major A
    for cin, cout in ((128, 128), (128, 256), (256, 256), (256, 128)):
        assert cv.f32_fwd_block(cv.f32_fwd_plan(100 * 16 * 16, cin, cout)[0]) == (128, 128, "k-major")
    # D's 13 -> 32 conv takes 256 × 32, its input gradient (32 -> 13) and
    # G's output phase conv (128 -> 12) 256 × 16
    assert cv.f32_fwd_block(cv.f32_fwd_plan(100 * 32 * 32, 13, 32)[0]) == (256, 32, "k-major")
    assert cv.f32_fwd_block(cv.f32_fwd_plan(100 * 32 * 32, 32, 13)[0]) == (256, 16, "m-major")
    assert cv.f32_fwd_block(cv.f32_fwd_plan(100 * 16 * 16, 128, 12)[0]) == (256, 16, "m-major")


# The calls of the two cells that stay on the forward kernel: under 64
# input channels (the first layers, D's 13 -> 32 and 42 -> 64 convs, and
# the input gradients of their outputs) or under 32 output channels (G's
# output phase convs to 4 × 3 pixels, and the input gradients into D's and
# C's first layers).
_CELL_DIRECT = {("dgrad", 100, 16, 16, 12, 128, 1), ("dgrad", 100, 32, 32, 3, 256, 1),
                ("dgrad", 100, 32, 32, 32, 13, 1), ("dgrad", 100, 32, 32, 128, 3, 1),
                ("fwd", 100, 16, 16, 42, 64, 1), ("fwd", 100, 16, 16, 128, 12, 1), ("fwd", 100, 32, 32, 3, 128, 1),
                ("fwd", 100, 32, 32, 13, 32, 1), ("fwd", 100, 32, 32, 256, 3, 1), ("fwd", 300, 16, 16, 42, 64, 1),
                ("fwd", 300, 32, 32, 3, 128, 1), ("fwd", 300, 32, 32, 13, 32, 1)}


def _direct_flops(key, calls=1):
    _, n, h, w, cin, cout, pad = key
    return calls * 2.0 * n * (h + 2 * pad - 2) * (w + 2 * pad - 2) * 9 * cin * cout


def test_f32_wino_plan_at_the_cells_shapes():
    """The Winograd rule is a function of the shape alone: at every
    forward and input-gradient call of the benchmark's two cells it gives
    the same answer twice (and after its cache is cleared), sends every
    call with at least 64 input and 32 output channels through the
    pipeline and the narrow ones to the forward kernel, and so covers at
    least 98% of each cell's direct forward and input-gradient operations;
    the plan's block width and workspace follow the shape."""
    from conv_cells import CELL_CONVS

    chosen = {}
    for key in CELL_CONVS:
        _, n, h, w, cin, cout, pad = key
        ho, wo = h + 2 * pad - 2, w + 2 * pad - 2
        chosen[key] = cv.f32_wino_plan(n, ho, wo, cin, cout)
    cv.f32_wino_plan.cache_clear()
    for key, plan in chosen.items():
        _, n, h, w, cin, cout, pad = key
        ho, wo = h + 2 * pad - 2, w + 2 * pad - 2
        assert cv.f32_wino_plan(n, ho, wo, cin, cout) == plan
        assert (plan is None) == (key in _CELL_DIRECT), key
        if plan is not None:
            bn, tiles, ws = plan
            cp, tp = -(-cout // 4) * 4, -(-tiles // 4) * 4
            assert tiles == n * -(-ho // 2) * -(-wo // 2) >= 256
            assert bn == (64 if cp <= 64 else 128)
            assert ws == 16 * (cin * cp + cin * tp + tiles * cp)
    for cell in ("cifar10_4k", "cifar10_snresnet"):
        total = sum(_direct_flops(k, c[cell]) for k, c in CELL_CONVS.items() if cell in c)
        wino = sum(_direct_flops(k, c[cell]) for k, c in CELL_CONVS.items() if cell in c and chosen[k])
        assert wino / total >= 0.98, (cell, wino / total)


def test_f32_wino_plan_edges():
    # the least channels and tiles it takes, any halo's output size, odd ones too
    assert cv.f32_wino_plan(1, 31, 33, 64, 32) == (64, 16 * 17, 16 * (64 * 32 + 64 * 272 + 272 * 32))
    assert cv.f32_wino_plan(1, 31, 33, 63, 32) is None
    assert cv.f32_wino_plan(1, 31, 33, 64, 31) is None
    assert cv.f32_wino_plan(1, 32, 30, 64, 64) is None  # 240 tiles
    assert cv.f32_wino_plan(1, 32, 32, 64, 65)[0] == 128  # 68 columns: one block of 128


def test_cell_conv_table_is_one_step_of_each_cell(monkeypatch):
    """``tests/conv_cells.py``, the table the rule's test and the card's
    Winograd tests read, against the forward wrapper's calls in one step of
    each cell's configuration at its widths (batch 2, rows scaled to the
    cells' 100)."""
    from conv_cells import CELL_CONVS
    from triplegan_tpu_torch.configs import get_config, make_networks
    from triplegan_tpu_torch.data.datasets import synthetic_dataset
    from triplegan_tpu_torch.data.zca import ZCAStats
    from triplegan_tpu_torch.train import step as S
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state

    got = {}
    real = cv.conv3x3_nopad
    for name in ("cifar10_4k", "cifar10_snresnet"):
        cfg = get_config(name)
        assert cfg.batch_size == 100 and cfg.compute_dtype == "float32" and cfg.use_pallas
        cfg.batch_size = 2
        nets, opts = make_networks(cfg), make_optimizers(cfg, 100)
        state = create_state(cfg, nets, opts, device="cpu")
        data = S.upload_device_data(synthetic_dataset(cfg.image_size, cfg.channels, 10, n_train=64, n_test=4,
                                                      num_labeled=20), "cpu")
        d = cfg.image_size ** 2 * cfg.channels
        zca = ZCAStats(mean=np.zeros(d, np.float32), whiten=np.eye(d, dtype=np.float32)) if cfg.zca else None
        step = S.make_device_train_step(cfg, nets, opts, 100, zca_stats=zca)

        def spy(x, w, pad=0, role="fwd", name=name):
            n, h, wd, cin = x.shape
            calls = got.setdefault((role, n * 50, h, wd, cin, w.shape[3], pad), {})
            calls[name] = calls.get(name, 0) + 1
            return real(x, w, pad, role)

        monkeypatch.setattr(cv, "conv3x3_nopad", spy)
        step(state, data)
    assert got == CELL_CONVS


_SM90_SHAPES = [(100 * 32 * 32, 3, 128), (384 * 32 * 32, 128, 128), (384 * 16 * 16, 256, 256),
                (1152 * 32 * 32, 13, 32), (100 * 6 * 6, 256, 512), (100 * 4 * 4, 512, 1024),
                (100 * 16 * 16, 128, 12), (17, 3, 12), (64 * 16 * 16, 42, 64)]


def test_sm90_wgrad_plan_covers_the_reduction_exactly():
    for m, cin, cout in _SM90_SHAPES:
        cin8, cout8 = -(-cin // 8) * 8, -(-cout // 8) * 8
        bn, splits, chunk = cv.sm90_wgrad_plan(m, cin8, cout8)
        assert (bn, splits, chunk) == cv.sm90_wgrad_plan(m, cin8, cout8)  # the shape alone decides
        assert bn in (64, 128) and bn >= min(cout8, 128)
        assert chunk % 64 == 0 and splits >= 1
        assert splits * chunk >= m > (splits - 1) * chunk
        tiles = -(-9 * cin8 // 128) * -(-cout8 // bn)
        assert splits == 1 or splits * tiles <= 2 * 132  # at most one wave of two blocks per SM
        assert splits == 1 or chunk >= 512


def test_sm90_forward_block_covers_cout():
    for cout in (1, 12, 13, 16, 17, 32, 42, 64, 65, 74, 128, 256, 512, 1024):
        bn = cv.fwd_block_n(cout)
        assert bn in (16, 32, 64, 128) and (bn >= cout or bn == 128)
        assert bn == 128 or bn // 2 < cout or bn == 16  # the narrowest tile that holds Cout


@pytest.mark.parametrize("cin,cout", [(3, 12), (13, 42), (32, 128), (64, 200), (74, 13)])
def test_packed_weight_and_padded_channels_give_the_same_conv(cin, cout):
    """The plain conv on the bf16 kernels' operands (channels padded to a
    multiple of 8, the weight packed K-major), sliced back, equals the plain
    conv on the originals; float32 on the CPU."""
    x, wt, g = _inputs(2, 6, 7, cin, cout, "SAME", seed=cin + cout)
    x, wt, g = torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(g)
    cin8 = -(-cin // 8) * 8
    bn = cv.fwd_block_n(cout)
    wp = cv.pack_weight_sm90(wt, cin8, bn)
    assert wp.shape[0] % bn == 0 and wp.shape[0] >= cout and wp.shape[1] % 64 == 0
    assert wp.shape[1] - 64 < 9 * cin8 <= wp.shape[1]
    w_hwio = wp[:, :9 * cin8].reshape(-1, 3, 3, cin8).permute(1, 2, 3, 0)  # (3, 3, cin8, Np)
    assert torch.equal(w_hwio[:, :, :cin, :cout], wt)
    assert not w_hwio[:, :, cin:].any() and not w_hwio[..., cout:].any() and not wp[:, 9 * cin8:].any()
    xk = cv.pad_channels(x, cin8)
    assert xk.shape == (2, 6, 7, cin8) and torch.equal(xk[..., :cin], x) and not xk[..., cin:].any()
    xp, xkp = cv._pad_hw(x, 1), cv._pad_hw(xk, 1)
    got = cv.reference_conv3x3_nopad(xkp, w_hwio.contiguous())[..., :cout]
    torch.testing.assert_close(got, cv.reference_conv3x3_nopad(xp, wt), rtol=1e-5, atol=1e-5)
    gk = cv.pad_channels(g, -(-cout // 8) * 8)
    got_dw = cv.reference_conv3x3_wgrad(xkp, gk)[:, :, :cin, :cout]
    torch.testing.assert_close(got_dw, cv.reference_conv3x3_wgrad(xp, g), rtol=1e-5, atol=1e-5)


def _unit_norm_kernel(rng, shape):
    """A weight-norm kernel with one tap of ±1 in each output channel, the
    rest 0: ‖v‖ = 1 exactly, and the norm's own gradient, Σ dw·v over the
    channel's taps, is one product. So the norm and its gradient, float32
    sums that torch and XLA take in other orders, come out the same in
    both packages, and what the test sees is the conv's filter gradient,
    which is dense all the same."""
    k = int(np.prod(shape[:-1]))
    out = np.zeros((k, shape[-1]), np.float32)
    out[rng.randint(0, k, shape[-1]), np.arange(shape[-1])] = rng.choice([-1.0, 1.0], shape[-1])
    return out.reshape(shape)


_LAYER_SEEDS = {"SAME": 11, "VALID": 12, "weight_norm": 20, "deconv": 21}


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("route", ["SAME", "VALID", "weight_norm", "deconv"])
def test_bf16_layer_filter_gradient_equals_jax_bitwise(route, use_pallas):
    """At bfloat16 the JAX layers convolve with the kernel cast to
    bfloat16 (``w.astype(x.dtype)``: ``conv2d_apply``,
    ``conv2d_wn_act_apply``, ``_deconv_raw``), so their filter gradient is
    the wgrad's float32 sum rounded to bfloat16 once. The port's layers,
    in both arms, give the same gradient bit for bit: SAME and VALID
    ``conv2d_apply``, the weight-norm conv with its epilogue (the kernel
    arm convolves raw v and folds g/‖v‖ into the epilogue; the plain arm
    convolves g·v/‖v‖), and the k = 5 stride-2 ``deconv2d_apply``. The
    cotangents are bfloat16, as in a bfloat16 step. (Sums in another order
    could round one coordinate the other way at a tie; on these seeded
    inputs none does.)"""
    from triplegan_tpu.nn import layers as JL
    from triplegan_tpu_torch.nn import layers as TL

    rng = np.random.RandomState(_LAYER_SEEDS[route])
    cin, cout = 16, 32
    size = 4 if route == "deconv" else 8
    x = rng.normal(size=(4, size, size, cin)).astype(np.float32)
    b = (rng.normal(size=cout) * 0.1).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    if route == "deconv":
        w = (rng.normal(size=(5, 5, cin, cout)) * 0.1).astype(np.float32)

        def jfn(w_):
            return JL.deconv2d_apply({"w": w_, "b": jnp.asarray(b)}, jx)

        def tfn(w_):
            return TL.deconv2d_apply({"w": w_, "b": torch.from_numpy(b)}, tx, use_pallas=use_pallas)

        to_port, from_port = (lambda a: a), (lambda a: a)  # (k, k, in, out) in both
    elif route == "weight_norm":
        w = _unit_norm_kernel(rng, (3, 3, cin, cout))
        g = (1.0 + rng.normal(size=cout) * 0.2).astype(np.float32)

        def jfn(v_):
            return JL.conv2d_wn_act_apply({"v": v_, "g": jnp.asarray(g), "b": jnp.asarray(b)}, jx,
                                          act="leaky_relu", slope=0.2, use_pallas=use_pallas)

        def tfn(v_):
            return TL.conv2d_wn_act_apply({"v": v_, "g": torch.from_numpy(g), "b": torch.from_numpy(b)},
                                          tx, act="leaky_relu", slope=0.2, use_pallas=use_pallas)

        to_port, from_port = (lambda a: a.transpose(3, 2, 0, 1)), (lambda a: a.transpose(2, 3, 1, 0))
    else:
        w = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)

        def jfn(w_):
            return JL.conv2d_apply({"w": w_, "b": jnp.asarray(b)}, jx, padding=route)

        def tfn(w_):
            return TL.conv2d_apply({"w": w_, "b": torch.from_numpy(b)}, tx, padding=route,
                                   use_pallas=use_pallas)

        to_port, from_port = (lambda a: a.transpose(3, 2, 0, 1)), (lambda a: a.transpose(2, 3, 1, 0))

    y_j, vjp = jax.vjp(jfn, jnp.asarray(w))
    cot = rng.normal(size=y_j.shape).astype(np.float32)
    (dw_j,) = vjp(jnp.asarray(cot).astype(jnp.bfloat16))
    tw = torch.from_numpy(np.ascontiguousarray(to_port(w))).requires_grad_()
    y_t = tfn(tw)
    (dw_t,) = torch.autograd.grad(y_t, tw, torch.from_numpy(cot).to(torch.bfloat16))
    assert y_t.dtype == torch.bfloat16 and dw_t.dtype == torch.float32
    np.testing.assert_array_equal(_bits(y_t.detach().float().numpy()), _bits(y_j.astype(jnp.float32)))
    np.testing.assert_array_equal(_bits(from_port(dw_t.numpy())), _bits(dw_j))
