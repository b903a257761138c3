"""The float32 Winograd F(2×2, 3×3) pipeline of ``ops/conv3x3.py``
(``conv3x3.cu``'s ``wino_filter``, ``wino_input``, ``wino_gemm`` and
``wino_output``, which ``conv3x3_nopad`` launches where ``f32_wino_plan``
gives a plan) on the card: at every forward and input-gradient call of the
benchmark's two cells (``tests/conv_cells.py``) against its plain twin
(``ops/winograd.py::winograd_nopad``), the plain direct conv and the exact
conv, with the launch counters; the calls the rule leaves on the forward
kernel there; ragged, misaligned and odd-channel shapes; the same bits over
200 calls at each shape; the conv function's output and gradients against
``F.conv2d`` in float64; and a launch the C side refuses raising. Skips
where there is no CUDA device (the kernels have no CPU mode).

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_winograd_cuda.py

Tolerances, with u = 2⁻²⁴, M = ``winograd_magnitude(x, w, halo)`` (the
computation on |x|, |w| and the transforms' absolute values, which bounds
the terms every rounding acts on) and n = Cin + 32 (the float32 additions
in an output's chain: 4 of the input transform, Cin of a product, 9 of the
output transform and the rest of U's rounding, counted loosely): against
the exact conv (float64) n·u·M; against the plain twin 2·n·u·M and against
the plain direct conv (n + 9·Cin)·u·M (each side within γ·M of the exact
value). The forward kernel, where the rule keeps it: 8·sqrt(9·Cin)·u·(the
plain conv on |inputs|), as ``tests/test_torch_cuda.py`` holds it.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conv_cells import CELL_CONVS  # noqa: E402
from triplegan_tpu_torch.ops import conv3x3 as cv  # noqa: E402
from triplegan_tpu_torch.ops.winograd import winograd_magnitude, winograd_nopad  # noqa: E402

U = 2.0 ** -24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# Beside the cells' calls, (role, N, H, W, Cin, Cout, halo): odd Ho and Wo
# (a last row or column of tiles cut to the output) at halo 0, 1 and 2;
# Cin not a multiple of 4 (4-byte reads of x) and Cout not a multiple of 4
# (padded columns of U and M, 4-byte stores of y); one 128 × 64 product
# block (Cout <= 64); tiles not a multiple of 4 or of the 128-row block; a
# conv of tests/test_torch_cuda.py's list that the rule now takes (19 × 30 ×
# 30, 64 -> 200: a ragged second column block)
_EXTRA = [("fwd", 15, 11, 9, 64, 70, 0), ("fwd", 5, 13, 15, 66, 64, 2), ("dgrad", 9, 10, 12, 70, 33, 1),
          ("fwd", 4, 17, 17, 96, 130, 1), ("fwd", 19, 30, 30, 64, 200, 1), ("dgrad", 3, 21, 19, 128, 48, 1)]
_WINO_KEYS = sorted(k for k in CELL_CONVS if cv.f32_wino_plan(k[1], k[2] + 2 * k[6] - 2, k[3] + 2 * k[6] - 2,
                                                              k[4], k[5]) is not None) + _EXTRA
_DIRECT_KEYS = sorted(k for k in CELL_CONVS if k not in _WINO_KEYS)


def test_every_shape_here_takes_its_path():
    """The rule sends each of ``_WINO_KEYS`` through the pipeline (at least
    64 input and 32 output channels and 256 tiles) and each of
    ``_DIRECT_KEYS`` to the forward kernel; a pure function, so this runs
    without a card too."""
    for key in _WINO_KEYS + _DIRECT_KEYS:
        _, n, h, w, cin, cout, pad = key
        plan = cv.f32_wino_plan(n, h + 2 * pad - 2, w + 2 * pad - 2, cin, cout)
        assert (plan is not None) == (key in _WINO_KEYS), key
    assert len(_WINO_KEYS) == len(set(_WINO_KEYS)) and _DIRECT_KEYS


def _inputs(key, dev, seed=0):
    _, n, h, w, cin, cout, pad = key
    gen = torch.Generator(device=dev).manual_seed(seed + n + h * w + cin * cout)
    x = torch.randn((n, h, w, cin), generator=gen, device=dev)
    wt = torch.randn((3, 3, cin, cout), generator=gen, device=dev) / math.sqrt(9 * cin)
    return x, wt


def _over(err, lim):
    """The worst err / lim, and whether every err is within its lim."""
    return float((err / lim).max()), bool((err <= lim).all())


@pytest.mark.cuda
@pytest.mark.parametrize("key", _WINO_KEYS, ids=[",".join(map(str, k)) for k in _WINO_KEYS])
def test_pipeline_matches_its_twin_the_plain_and_the_exact_conv(key, cuda):
    role, n, h, w, cin, cout, pad = key
    x, wt = _inputs(key, cuda)
    ck = (role, n, h, w, cin, cout, pad, "float32")
    before = (cv.wino_launches[ck], cv.wino_launches.total(), cv.fwd_launches.total(), cv.fwd_block_launches.total())
    got = cv.conv3x3_nopad(x, wt, pad, role=role)
    torch.cuda.synchronize()
    assert (cv.wino_launches[ck], cv.wino_launches.total(), cv.fwd_launches.total(),
            cv.fwd_block_launches.total()) == (before[0] + 1, before[1] + 1, before[2], before[3])
    ho, wo = h + 2 * pad - 2, w + 2 * pad - 2
    assert got.shape == (n, ho, wo, cout) and got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    mag = winograd_magnitude(x, wt, pad).double()
    nn = cin + 32
    got = got.double()
    exact = cv.reference_conv3x3_nopad(cv._pad_hw(x.double(), pad), wt.double())
    share, ok = _over((got - exact).abs(), nn * U * mag)
    assert ok, f"against the exact conv: {share} of the bound"
    share, ok = _over((got - winograd_nopad(x, wt, pad).double()).abs(), 2 * nn * U * mag)
    assert ok, f"against the plain twin: {share} of the bound"
    share, ok = _over((got - cv.reference_conv3x3_nopad(cv._pad_hw(x, pad), wt).double()).abs(),
                      (nn + 9 * cin) * U * mag)
    assert ok, f"against the plain direct conv: {share} of the bound"


@pytest.mark.cuda
@pytest.mark.parametrize("key", _DIRECT_KEYS, ids=[",".join(map(str, k)) for k in _DIRECT_KEYS])
def test_the_narrow_calls_of_the_cells_keep_the_forward_kernel(key, cuda):
    role, n, h, w, cin, cout, pad = key
    assert cin < 64 or cout < 32
    x, wt = _inputs(key, cuda)
    before = (cv.wino_launches.total(), cv.fwd_launches[role, n, h, w, cin, cout, pad, "float32"])
    got = cv.conv3x3_nopad(x, wt, pad, role=role)
    torch.cuda.synchronize()
    assert (cv.wino_launches.total(), cv.fwd_launches[role, n, h, w, cin, cout, pad, "float32"]) == (
        before[0], before[1] + 1)
    xp = cv._pad_hw(x, pad)
    want = cv.reference_conv3x3_nopad(xp, wt).double()
    lim = 8.0 * math.sqrt(9 * cin) * U * cv.reference_conv3x3_nopad(xp.abs(), wt.abs()).double()
    share, ok = _over((got.double() - want).abs(), lim)
    assert ok, share


@pytest.mark.cuda
def test_pipeline_is_bitwise_repeatable_over_200_calls(cuda):
    """Every sum of the pipeline runs in a fixed order, so 200 calls at each
    of its shapes give the first call's bits; the freed blocks are refilled
    with NaN between calls, so a read of workspace the kernels never wrote
    would show."""
    rng = np.random.RandomState(3)
    for key in _WINO_KEYS:
        role, n, h, w, cin, cout, pad = key
        x, wt = _inputs(key, cuda, seed=1)
        first = cv.conv3x3_nopad(x, wt, pad, role=role)
        for rep in range(199):
            junk = [torch.full((int(rng.randint(1, 1 << 20)),), float("nan"), device=cuda) for _ in range(2)]
            del junk
            again = cv.conv3x3_nopad(x, wt, pad, role=role)
            assert torch.equal(again, first), f"{key}: call {rep + 2} differs at {int((again != first).sum())}"


# (N, H, W, Cin, Cout, padding) of the layers behind the cells' widest calls:
# C's 128- and 256-wide SAME convs, its VALID t0 (8 -> 6, input gradient at
# halo 2) and SN-ResNet G's 256-wide block conv at 32 × 32
_LAYERS = [(100, 32, 32, 128, 128, "SAME"), (100, 16, 16, 256, 256, "SAME"), (100, 8, 8, 256, 512, "VALID"),
           (50, 32, 32, 256, 256, "SAME")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _LAYERS, ids=[",".join(map(str, s)) for s in _LAYERS])
def test_conv_function_output_and_gradients_against_conv2d(shape, cuda):
    """``conv3x3`` with autograd on the card: y and dx through the pipeline
    (one launch each, counted by role), dw through the filter-gradient
    kernel; against ``F.conv2d`` and its gradients in float64 on the card,
    y and dx within the Winograd bound against the exact value (dx's M
    that of the input-gradient call: the cotangent with halo 2 − p against
    the flipped, in/out-swapped kernel), dw as ``tests/test_torch_cuda.py``
    holds the filter-gradient kernel."""
    import torch.nn.functional as F

    n, h, w, cin, cout, padding = shape
    p = 1 if padding == "SAME" else 0
    ho, wo = h + 2 * p - 2, w + 2 * p - 2
    x, wt = _inputs(("fwd", n, h, w, cin, cout, p), cuda, seed=2)
    gy = torch.cos(torch.arange(n * ho * wo * cout, device=cuda, dtype=torch.float32)).reshape(n, ho, wo, cout)
    xd, wd = x.clone().requires_grad_(), wt.clone().requires_grad_()
    keys = (("fwd", n, h, w, cin, cout, p, "float32"), ("dgrad", n, ho, wo, cout, cin, 2 - p, "float32"))
    before = [cv.wino_launches[k] for k in keys]
    y = cv.conv3x3(xd, wd, padding)
    dx, dw = torch.autograd.grad(y, (xd, wd), gy)
    torch.cuda.synchronize()
    assert [cv.wino_launches[k] for k in keys] == [b + 1 for b in before]

    x64, w64 = x.double().requires_grad_(), wt.double().requires_grad_()
    y64 = F.conv2d(x64.permute(0, 3, 1, 2), w64.permute(3, 2, 0, 1), padding=p).permute(0, 2, 3, 1)
    dx64, dw64 = torch.autograd.grad(y64, (x64, w64), gy.double())
    w_flip = wt.flip((0, 1)).transpose(2, 3).contiguous()
    for name, got, want, lim in (
            ("y", y, y64, (cin + 32) * U * winograd_magnitude(x, wt, p).double()),
            ("dx", dx, dx64, (cout + 32) * U * winograd_magnitude(gy, w_flip, 2 - p).double()),
            ("dw", dw, dw64, 8.0 * math.sqrt(n * ho * wo) * U * cv.reference_conv3x3_wgrad(
                cv._pad_hw(x.abs(), p), gy.abs()).double())):
        share, ok = _over((got.double() - want.detach()).abs(), lim)
        assert ok, f"{name}: {share} of the bound"


@pytest.mark.cuda
def test_pipeline_raises_when_it_cannot_launch(cuda, monkeypatch):
    # The C entry refuses what it does not take, with cudaErrorInvalidValue.
    wino = cv._lib_wino()
    x = torch.zeros(4, 16, 16, 64, device=cuda)
    wt = torch.zeros(3, 3, 64, 64, device=cuda)
    y = torch.empty(4, 16, 16, 64, device=cuda)
    bn, _, ws_len = cv.f32_wino_plan(4, 16, 16, 64, 64)
    ws = torch.empty(ws_len + 1, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), wt.data_ptr(), ws.data_ptr(), y.data_ptr(), 4, 16, 16, 64, 64, 1)
    assert wino(*args, 32, stream) == 1  # no product block 32 wide
    assert wino(x.data_ptr(), wt.data_ptr(), ws.data_ptr() + 4, y.data_ptr(), 4, 16, 16, 64, 64, 1, bn,
                stream) == 1  # a workspace off 16 bytes
    assert wino(*args[:9], 3, bn, stream) == 1  # a halo of 3
    assert wino(*args, bn, stream) == 0
    # A float32 call whose pipeline refuses raises; it takes neither the
    # forward kernel nor the plain version, and counts nothing.
    monkeypatch.setattr(cv, "_lib_wino", lambda: (lambda *a: 98))
    monkeypatch.setattr(cv, "_lib", lambda: pytest.fail("the forward kernel was called"))
    monkeypatch.setattr(cv, "reference_conv3x3_nopad", lambda *a: pytest.fail("plain version called"))
    before = (cv.fwd_launches.copy(), cv.wino_launches.copy())
    with pytest.raises(RuntimeError, match="cudaError 98"):
        cv.conv3x3_nopad(x, wt, 1)
    assert (cv.fwd_launches, cv.wino_launches) == before
