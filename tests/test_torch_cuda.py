"""The CUDA kernels (scale_bias_act, conv3x3 forward and wgrad: float32
from conv3x3.cu, bfloat16 from conv3x3_sm90.cu) against their plain
PyTorch versions, on the card; the float32 conv's bits repeated over 200
calls; the per-sample (class-conditional) epilogue kernels against their
plain version at the ResNet generator's shapes; the batch-norm moments' kernels at every batch-norm shape
of the benchmark's two cells against the float64 twin, and at ragged, misaligned and strided inputs;
``device_prefetch``'s copies (their bytes and the consumer's
stream ordered after them) and the native gather in use; the CUDA graph
chunk under a process group: refused under gloo, and under NCCL (a group
of this process alone) equal to eager steps bitwise; the phase marks a
profiled replay runs; the forward kernels
as PyTorch operators, and a ``.pt2`` artifact exported on the card that
launches them there and runs its plain versions once moved to the CPU.
Skips where there is no CUDA device (the kernels have no CPU mode).

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance, scale_bias_act: float32 |kernel − plain| ≤ 1e-6·(1 + |plain|);
bfloat16 within one bfloat16 ulp (the kernel rounds as the plain version
does, so both are met with room). Its backward: dx bitwise equal to the
plain backward's (it rounds every intermediate where that does); dk and db
against the exact sums of the plain backward's terms within γ_n·Σ|terms|,
n the kernel's summation depth, plus one bfloat16 ulp at bfloat16
(chip_smoke.py's ``bwd_sums_excess``). conv3x3: |kernel − plain| ≤
8·sqrt(K)·2⁻²⁴·(the plain op on |inputs|), K the length of each sum (the
two take float32 sums in different orders), plus one bfloat16 ulp of the
value where the output is bfloat16 (both round a float32 sum once).
The moments: the exact (float64) moments rounded once to float32, plus the
float64 sums' own γ_n·Σ|terms|/M at u = 2⁻⁵³; their backward within 4
float32 roundings of its two terms, one bfloat16 ulp at bfloat16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from triplegan_tpu_torch.ops import conv3x3 as cv  # noqa: E402
from triplegan_tpu_torch.ops import scale_bias_act as sba  # noqa: E402

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, dev, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32) * 2.0
    k = (rng.normal(size=(c,)) * 0.5 + 1.0).astype(np.float32)
    b = (rng.normal(size=(c,)) * 0.3).astype(np.float32)
    return (torch.from_numpy(a).to(dev) for a in (x, k, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype, cuda):
    for act in sba.ACTS:
        # C = 16 and 24 take the 16-byte vector path, C = 3 the scalar path.
        for shape in [(4, 6, 6, 16), (5, 17, 13, 24), (3, 7, 11, 3)]:
            x, k, b = _inputs(shape, cuda)
            x = x.to(_DT[dtype])
            before = sba.launches.total()
            got = sba.scale_bias_act(x, k, b, act, 0.1)
            torch.cuda.synchronize()
            assert sba.launches.total() == before + 1
            assert sba.launches[shape, dtype, act, 0.1] >= 1
            want = sba.reference_scale_bias_act(x, k, b, act, 0.1)
            assert got.dtype == x.dtype and got.shape == x.shape
            err = (got.double() - want.double()).abs()
            if dtype == "float32":
                lim = 1e-6 * (1.0 + want.double().abs())
            else:
                mag = torch.clamp_min(torch.maximum(got.abs(), want.abs()).double(), 2.0 ** -126)
                lim = torch.exp2(torch.floor(torch.log2(mag)) - 7)
            assert bool((err <= lim).all()), (act, shape, float(err.max()))


@pytest.mark.cuda
def test_kernel_wrapper_raises_instead_of_falling_back(cuda):
    ones, zeros = torch.ones(4, device=cuda), torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sba.scale_bias_act(torch.zeros(4, 8, device=cuda).t(), ones, zeros)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sba.scale_bias_act(torch.zeros(8, 4, device=cuda, dtype=torch.float16), ones, zeros)
    with pytest.raises(ValueError, match="shape"):
        sba.scale_bias_act(torch.zeros(8, 4, device=cuda), torch.ones(5, device=cuda), zeros)
    with pytest.raises(ValueError, match="is on"):
        sba.scale_bias_act(torch.zeros(8, 4, device=cuda), torch.ones(4), zeros)


def _bf16_ulp(v):
    mag = torch.clamp_min(v.abs().double(), 2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _elementwise_ok(got, want):
    """float32 within 1e-6·(1 + |plain|), bfloat16 within one ulp."""
    err = (got.double() - want.double()).abs()
    if got.dtype == torch.float32:
        lim = 1e-6 * (1.0 + want.double().abs())
    else:
        lim = _bf16_ulp(torch.maximum(got.abs(), want.abs()))
    return bool((err <= lim).all()), float(err.max())


def _sums_ok(got, x, k, b, g, act, slope, which, flags=7, aligned=True):
    """dk (which = 1) or db (2) against the exact sums of the plain
    backward's terms, within chip_smoke.py's limit for the depth of the
    kernel's sums (``bwd_sums_excess``)."""
    import chip_smoke

    c = x.shape[-1]
    m = x.numel() // c
    t = sba.reference_bwd_t(x, k, b, g, act, slope)
    terms = (t * x if which == 1 else t).reshape(m, c)
    depth = sba.bwd_plan(m, c, x.dtype, act, flags, aligned)[1]
    err, excess, _ = chip_smoke.bwd_sums_excess(got, terms, depth)
    return excess <= 0, err


def _sba_case(shape, dtype, dev, seed=0):
    x, k, b = _inputs(shape, dev, seed)
    g = torch.from_numpy(np.random.RandomState(seed + 7).normal(size=shape).astype(np.float32)).to(dev)
    return x.to(dtype), k.to(dtype), b.to(dtype), g.to(dtype)


# C = 3 takes the 3-vector groups, C = 12 (bfloat16) and 37 the scalar rows,
# 12 (float32), 128 and 512 the 16-byte rows; 3600 rows spread over many
# blocks, 231 rows over few.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [3, 12, 37, 128, 512])
def test_sba_backward_kernel_matches_plain_on_card(c, dtype, cuda):
    for act in sba.ACTS:
        for rows in ((40, 9, 10), (3, 7, 11)):
            x, k, b, g = _sba_case(rows + (c,), _DT[dtype], cuda)
            y = sba.scale_bias_act(x, k, b, act, 0.2)
            ok, err = _elementwise_ok(y, sba.reference_scale_bias_act(x, k, b, act, 0.2))
            assert ok, ("forward", act, rows, err)
            before = sba.bwd_launches.total()
            got = sba._backward(x, k, b, g, act, 0.2, (True, True, True))
            torch.cuda.synchronize()
            assert sba.bwd_launches.total() == before + 1
            assert sba.bwd_launches[rows + (c,), dtype, act, 0.2, "xkb"] >= 1
            want = sba.reference_scale_bias_act_bwd(x, k, b, g, act, 0.2)
            assert [t.dtype for t in got] == [x.dtype] * 3
            # the kernel rounds as the plain backward does: dx is bitwise equal
            assert torch.equal(got[0], want[0]), (act, rows, float((got[0].float() - want[0].float()).abs().max()))
            ok, err = _elementwise_ok(got[0], want[0])
            assert ok, ("dx", act, rows, err)
            for name, i in (("dk", 1), ("db", 2)):
                ok, err = _sums_ok(got[i], x, k, b, g, act, 0.2, i)
                assert ok, (name, act, rows, err)


# the per-sample (class-conditional batch norm) kernels at the ResNet G's
# shapes, and at C = 37 (the scalar rows) over 5 samples of 3 × 7 rows
_COND_SHAPES = [(100, 4, 4, 256), (100, 8, 8, 256), (100, 16, 16, 256), (100, 32, 32, 256), (5, 3, 7, 37)]


def _cond_case(shape, dtype, dev, seed=0):
    rng = np.random.RandomState(seed)
    n, c = shape[0], shape[-1]
    arrays = (rng.normal(size=shape) * 2.0, rng.normal(size=(n, c)) * 0.5 + 1.0, rng.normal(size=(n, c)) * 0.3,
              rng.normal(size=shape))
    return [torch.from_numpy(a.astype(np.float32)).to(dev).to(dtype) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _COND_SHAPES)
def test_cond_kernels_match_plain_on_card(shape, dtype, cuda):
    """The per-sample forward within the epilogue's tolerance of its plain
    version, its backward's dx bitwise, and each sample's dk and db against
    the exact sums of the plain terms (``_sums_ok``'s limit at the kernel's
    depth), each launch counted."""
    import chip_smoke

    x, k, b, g = _cond_case(shape, _DT[dtype], cuda)
    n, c = shape[0], shape[-1]
    hw = x.numel() // (n * c)
    for act in (sba.ACTS if n < 100 else ("relu",)):
        before = sba.cond_launches.total(), sba.cond_bwd_launches.total()
        y = sba.scale_bias_act_cond(x, k, b, act, 0.2)
        got = sba._cond_backward(x, k, b, g, act, 0.2, (True, True, True))
        torch.cuda.synchronize()
        assert (sba.cond_launches.total(), sba.cond_bwd_launches.total()) == (before[0] + 1, before[1] + 1)
        assert sba.cond_launches[shape, dtype, act, 0.2] >= 1
        ok, err = _elementwise_ok(y, sba.reference_scale_bias_act_cond(x, k, b, act, 0.2))
        assert ok, ("forward", act, err)
        want = sba.reference_scale_bias_act_cond_bwd(x, k, b, g, act, 0.2)
        assert torch.equal(got[0], want[0]), (act, float((got[0].float() - want[0].float()).abs().max()))
        t = g * sba.act_grad(x * sba._per_sample(k, x) + sba._per_sample(b, x), act, 0.2)
        depth = sba.cond_bwd_plan(n, hw, c, x.dtype, act, 7, True)[1]
        for name, i, terms in (("dk", 1, t * x), ("db", 2, t)):
            assert got[i].shape == (n, c) and got[i].dtype == x.dtype
            cols = terms.reshape(n, hw, c).permute(1, 0, 2).reshape(hw, n * c)
            err, excess, _ = chip_smoke.bwd_sums_excess(got[i].reshape(n * c), cols, depth)
            assert excess <= 0, (name, act, err)


@pytest.mark.cuda
def test_cond_function_grads_match_plain_on_card(cuda):
    """Autograd through the per-sample function on the card against the
    same function on the CPU (its plain version)."""
    x, k, b, g = _cond_case((100, 8, 8, 256), torch.float32, cuda, seed=3)
    got = [t.clone().requires_grad_(True) for t in (x, k, b)]
    cpu = [t.cpu().clone().requires_grad_(True) for t in (x, k, b)]
    ya = sba.scale_bias_act_cond(*got, "relu", 0.2)
    yb = sba.scale_bias_act_cond(*cpu, "relu", 0.2)
    assert torch.equal(ya.cpu(), yb.detach())
    ga = torch.autograd.grad(ya, got, g)
    gb = torch.autograd.grad(yb, cpu, g.cpu())
    assert torch.equal(ga[0].cpu(), gb[0])
    for a, w in zip(ga[1:], gb[1:]):
        torch.testing.assert_close(a.cpu(), w, rtol=1e-5, atol=1e-4)


# every train-mode batch norm's input in the two benchmark cells: C's three
# block widths and its 6 × 6 tail; the DCGAN G's; the ResNet G's cBNs and b5;
# and a dense batch norm (mnist100's G)
_MOMENT_SHAPES = [(100, 32, 32, 128), (100, 16, 16, 256), (100, 6, 6, 512), (100, 6, 6, 256), (100, 6, 6, 128),
                  (100, 4, 4, 512), (100, 8, 8, 256), (100, 4, 4, 256), (100, 32, 32, 256), (100, 500)]


def _moments_case(shape, dtype, dev, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.normal(size=shape) * 1.5 + rng.normal(size=(c,)) * 0.5
    dmean, dmean_sq = rng.normal(size=(c,)), rng.normal(size=(c,))
    return (torch.from_numpy(x.astype(np.float32)).to(dev).to(dtype),
            *(torch.from_numpy(v.astype(np.float32)).to(dev) for v in (dmean, dmean_sq)))


def _moments_ok(got, x, depth):
    """(mean, mean_sq) against the float64 twin: the exact moments rounded
    once to float32 (2⁻²⁴ of the value), plus the float64 sums' error,
    γ_{n+1}·Σ|terms|/M with u = 2⁻⁵³ and n = ``depth``, the most additions a
    term goes through (one more for the division); the squares of float32
    values are exact in float64."""
    u = 2.0 ** -53
    xd = x.double().reshape(-1, x.shape[-1])
    m = xd.shape[0]
    want = sba.reference_bn_moments(xd)
    worst = 0.0
    for g, w, terms in zip(got, want, (xd.abs(), xd * xd)):
        n = depth + 1
        lim = n * u / (1 - n * u) * terms.sum(0) / m + 2.0 ** -24 * w.abs()
        worst = max(worst, float(((g.double() - w).abs() / lim).max()))
    return worst <= 1.0, worst


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _MOMENT_SHAPES)
def test_moments_kernels_match_the_float64_twin_on_card(shape, cuda):
    """The moments' forward pair against the float64 twin within its
    summation bound, and the backward against the closed form in float64
    within a few float32 roundings, each launch counted; float32 at every
    cell shape, bfloat16 at the 2-D and 32 × 32 ones."""
    dtypes = ["float32"] + (["bfloat16"] if shape[-1] in (128, 500) else [])
    for dtype in dtypes:
        x, dmean, dmean_sq = _moments_case(shape, _DT[dtype], cuda)
        m, c = x.numel() // shape[-1], shape[-1]
        before = sba.moments_launches.total(), sba.moments_bwd_launches.total()
        got = sba._moments_forward(x)
        dx = sba._moments_backward(x, dmean, dmean_sq)
        torch.cuda.synchronize()
        assert (sba.moments_launches.total(), sba.moments_bwd_launches.total()) == (before[0] + 1, before[1] + 1)
        assert sba.moments_launches[shape, dtype] >= 1 and sba.moments_bwd_launches[shape, dtype] >= 1
        assert all(v.dtype == torch.float32 and v.shape == (c,) for v in got)
        ok, worst = _moments_ok(got, x, sba.moments_plan(m, c, x.dtype)[1])
        assert ok, (dtype, worst)
        want = sba.reference_bn_moments_bwd(x.double(), dmean.double(), dmean_sq.double())
        assert dx.dtype == x.dtype and dx.shape == x.shape
        ok, err = _elementwise_ok(dx, want.to(x.dtype)) if dtype == "bfloat16" else (
            bool(((dx.double() - want).abs() <= 4 * 2.0 ** -24 * (dmean.double().abs() / m
                                                                  + (2 * x.double() * dmean_sq.double() / m).abs())
                  ).all()), float((dx.double() - want).abs().max()))
        assert ok, (dtype, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moments_kernels_are_bitwise_repeatable_on_card(dtype, cuda):
    x, dmean, dmean_sq = _moments_case((100, 32, 32, 256), _DT[dtype], cuda, seed=4)
    first = sba._moments_forward(x), sba._moments_backward(x, dmean, dmean_sq)
    for _ in range(5):
        again = sba._moments_forward(x), sba._moments_backward(x, dmean, dmean_sq)
        assert all(torch.equal(a, b) for a, b in zip(first[0], again[0]))
        assert torch.equal(first[1], again[1])


@pytest.mark.cuda
def test_moments_function_on_card_matches_its_plain_path(cuda):
    """Autograd through ``bn_moments`` on the card (the kernels) against the
    same Function on the CPU (its plain path), a cotangent missing too."""
    x, dmean, dmean_sq = _moments_case((100, 8, 8, 256), torch.float32, cuda, seed=5)
    xa, xb = x.clone().requires_grad_(True), x.cpu().requires_grad_(True)
    ma, mb = sba.bn_moments(xa), sba.bn_moments(xb)
    for a, b in zip(ma, mb):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
    for cot in ((dmean, dmean_sq), (dmean, None)):
        outs = [v for v, g in zip(ma, cot) if g is not None]
        (ga,) = torch.autograd.grad(outs, xa, [g for g in cot if g is not None], retain_graph=True)
        (gb,) = torch.autograd.grad([v for v, g in zip(mb, cot) if g is not None], xb,
                                    [g.cpu() for g in cot if g is not None], retain_graph=True)
        torch.testing.assert_close(ga.cpu(), gb, rtol=1e-5, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moments_kernels_take_ragged_misaligned_and_strided_inputs(dtype, cuda):
    """Rows of single channels (C = 3, and C = 6 or 12, not whole 16-byte
    units), a view off 16-byte alignment and a transposed view each launch
    the kernels (the view as a contiguous copy), forward and backward
    through ``bn_moments``, and match the float64 twin as the aligned
    shapes do; a CPU tensor takes the twin and launches nothing; another
    CUDA dtype raises."""
    dt = _DT[dtype]
    x3 = torch.randn(10, 4, 4, 3, device=cuda).to(dt)
    xr = torch.randn(10, 5, 5, 6 if dtype == "float32" else 12, device=cuda).to(dt)
    base = torch.randn(10 * 16 + 1, device=cuda).to(dt)
    off = base[1:].view(10, 16)  # not 16-byte aligned
    strided = torch.randn(16, 10, device=cuda).to(dt).t()
    for x in (x3, xr, off, strided):
        c = x.shape[-1]
        m = x.numel() // c
        xg = x.detach().requires_grad_(True)
        dmean, dmean_sq = torch.randn(c, device=cuda), torch.randn(c, device=cuda)
        before = sba.moments_launches.total(), sba.moments_bwd_launches.total()
        got = sba.bn_moments(xg)
        (dx,) = torch.autograd.grad(got, xg, (dmean, dmean_sq))
        torch.cuda.synchronize()
        assert (sba.moments_launches.total(), sba.moments_bwd_launches.total()) == (before[0] + 1, before[1] + 1)
        xc = x.contiguous()
        ok, worst = _moments_ok(got, xc, sba.moments_plan(m, c, dt, xc.data_ptr() % 16 == 0)[1])
        assert ok, (tuple(x.shape), worst)
        want = sba.reference_bn_moments_bwd(x.double(), dmean.double(), dmean_sq.double())
        assert dx.dtype == dt and dx.shape == x.shape
        ok, err = _elementwise_ok(dx, want.to(dt)) if dtype == "bfloat16" else (
            bool(((dx.double() - want).abs() <= 4 * 2.0 ** -24 * (dmean.double().abs() / m
                                                                  + (2 * x.double() * dmean_sq.double() / m).abs())
                  ).all()), float((dx.double() - want).abs().max()))
        assert ok, (tuple(x.shape), err)
    cpu = torch.randn(10, 8).to(dt)
    before = sba.moments_launches.total()
    for g, w in zip(sba.bn_moments(cpu), sba.reference_bn_moments(cpu)):
        assert torch.equal(g, w)
    assert sba.moments_launches.total() == before
    with pytest.raises(TypeError):
        sba.bn_moments(torch.randn(10, 8, device=cuda, dtype=torch.float16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sba_kernels_take_a_view_off_16_byte_alignment(dtype, cuda):
    # A view 2 or 4 bytes past an aligned address takes the scalar rows;
    # each element's arithmetic is the same, so y and dx are bitwise equal
    # to an aligned copy's, and dk, db agree with the plain sums.
    dt = _DT[dtype]
    rng = np.random.RandomState(8)
    shape = (6, 8, 8, 128)
    n = int(np.prod(shape))
    flat = torch.from_numpy(rng.normal(size=2 * n + 2).astype(np.float32)).to(cuda, dt)
    x, g = flat[1:n + 1].view(shape), flat[n + 2:].view(shape)
    assert x.data_ptr() % 16 and g.data_ptr() % 16
    _, k, b, _ = _sba_case(shape, dt, cuda)
    xa, ga = x.clone(), g.clone()
    assert torch.equal(sba.scale_bias_act(x, k, b, "leaky_relu", 0.1),
                       sba.scale_bias_act(xa, k, b, "leaky_relu", 0.1))
    got = sba._backward(x, k, b, g, "leaky_relu", 0.1, (True, True, True))
    aligned = sba._backward(xa, k, b, ga, "leaky_relu", 0.1, (True, True, True))
    want = sba.reference_scale_bias_act_bwd(xa, k, b, ga, "leaky_relu", 0.1)
    torch.cuda.synchronize()
    assert torch.equal(got[0], aligned[0]) and torch.equal(got[0], want[0])
    for i in (1, 2):
        assert _sums_ok(got[i], xa, k, b, ga, "leaky_relu", 0.1, i, aligned=False)[0]


_MASKS = [(a, b_, c) for a in (False, True) for b_ in (False, True) for c in (False, True) if a or b_ or c]


@pytest.mark.cuda
@pytest.mark.parametrize("needs", _MASKS, ids=["".join("xkb"[i] for i in range(3) if m[i]) for m in _MASKS])
def test_sba_function_launches_the_backward_kernel_for_each_mask(needs, cuda):
    for c in (3, 64):
        x, k, b, g = _sba_case((5, 6, 7, c), torch.bfloat16, cuda, seed=2)
        ins = [t.clone().requires_grad_(n) for t, n in zip((x, k, b), needs)]
        before = sba.bwd_launches.copy()
        y = sba.scale_bias_act(*ins, "relu", 0.1)
        grads = torch.autograd.grad(y, [t for t in ins if t.requires_grad], g)
        torch.cuda.synchronize()
        mask = "".join(n for n, want in zip("xkb", needs) if want)
        assert sba.bwd_launches - before == {((5, 6, 7, c), "bfloat16", "relu", 0.1, mask): 1}
        full = sba.reference_scale_bias_act_bwd(x, k, b, g, "relu", 0.1)
        flags = sum(1 << i for i in range(3) if needs[i])
        for got, want, i in zip(grads, [f for f, n in zip(full, needs) if n], [i for i in range(3) if needs[i]]):
            if i == 0:
                assert torch.equal(got, want)
            else:
                assert _sums_ok(got, x, k, b, g, "relu", 0.1, i, flags)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sba_backward_sums_are_bitwise_repeatable(dtype, cuda):
    for shape in ((64, 16, 16, 128), (100, 32, 32, 3), (30, 7, 9, 37)):
        x, k, b, g = _sba_case(shape, _DT[dtype], cuda, seed=3)
        a = sba._backward(x, k, b, g, "tanh", 0.1, (True, True, True))
        c = sba._backward(x, k, b, g, "tanh", 0.1, (True, True, True))
        torch.cuda.synchronize()
        assert all(torch.equal(p, q) for p, q in zip(a, c)), shape


# The widest epilogue backwards of the two train settings, whose dk and db
# sum the most rows (102,400 and 1,179,648).
_WIDE = {"float32": (100, 32, 32, 128), "bfloat16": (1152, 32, 32, 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["one block", "a tenth"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sba_sum_limit_fails_a_backward_that_drops_rows(dtype, fault, cuda):
    # chip_smoke.py's limit on dk and db passes the kernel's sums at the
    # main path's widest shapes and fails the sums a kernel would give that
    # dropped one block's rows, or a tenth of all rows: the kernel's own
    # output with those rows' cotangents zeroed.
    import chip_smoke

    shape = _WIDE[dtype]
    x, k, b, g = _sba_case(shape, _DT[dtype], cuda, seed=5)
    c = shape[-1]
    m = x.numel() // c
    blocks, depth = sba.bwd_plan(m, c, x.dtype, "leaky_relu", 7, True)
    t = sba.reference_bwd_t(x, k, b, g, "leaky_relu", 0.1)
    terms = {1: (t * x).reshape(m, c), 2: t.reshape(m, c)}
    good = sba._backward(x, k, b, g, "leaky_relu", 0.1, (True, True, True))
    drop = -(-m // blocks) if fault == "one block" else m // 10
    g_bad = g.clone()
    g_bad.view(m, c)[m // 3:m // 3 + drop] = 0
    bad = sba._backward(x, k, b, g_bad, "leaky_relu", 0.1, (True, True, True))
    torch.cuda.synchronize()
    for i in (1, 2):
        assert chip_smoke.bwd_sums_excess(good[i], terms[i], depth)[1] <= 0, i
        err, excess, share = chip_smoke.bwd_sums_excess(bad[i], terms[i], depth)
        assert excess > 0, (i, err, share)


@pytest.mark.cuda
def test_sba_raises_when_its_backward_kernel_cannot_launch(cuda, monkeypatch):
    # The C entry point refuses what it does not take, with cudaErrorInvalidValue.
    fwd, bwd, plan = sba._lib()
    x, k, b, g = _sba_case((4, 8), torch.float32, cuda)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    args = [x.data_ptr(), k.data_ptr(), b.data_ptr(), g.data_ptr(), dx.data_ptr(), None, None, None, 0,
            4, 8, 0, 2, 0.1]
    assert bwd(*args, 0, stream) == 1  # no gradient asked for
    assert bwd(*args, 2, stream) == 1  # dk asked for with no workspace
    # A workspace smaller than the grid the C side plans is refused, not
    # met by a smaller grid.
    x2, k2, b2, g2 = _sba_case((4096, 128), torch.float32, cuda)
    blocks = sba.bwd_plan(4096, 128, torch.float32, "leaky_relu", 7, True)[0]
    assert blocks > 1
    ws, kb, dx2 = torch.empty((blocks, 256), device=cuda), torch.empty((2, 128), device=cuda), torch.empty_like(x2)
    args2 = [x2.data_ptr(), k2.data_ptr(), b2.data_ptr(), g2.data_ptr(), dx2.data_ptr(),
             kb[0].data_ptr(), kb[1].data_ptr(), ws.data_ptr()]
    assert bwd(*args2, blocks - 1, 4096, 128, 0, 2, 0.1, 7, stream) == 1
    assert bwd(*args2, blocks, 4096, 128, 0, 2, 0.1, 7, stream) == 0
    torch.cuda.synchronize()
    # A CUDA backward whose kernel refuses raises; it does not take the
    # plain backward, and counts nothing.
    monkeypatch.setattr(sba, "_lib", lambda: (fwd, lambda *a: 98, plan))
    monkeypatch.setattr(sba, "reference_scale_bias_act_bwd", lambda *a: pytest.fail("plain backward called"))
    xg = x.clone().requires_grad_()
    y = sba.scale_bias_act(xg, k, b, "leaky_relu", 0.1)
    before = sba.bwd_launches.copy()
    with pytest.raises(RuntimeError, match="cudaError 98"):
        torch.autograd.grad(y, xg, g)
    assert sba.bwd_launches == before
    monkeypatch.setattr(sba, "_lib", lambda: (lambda *a: 98, bwd, plan))
    with pytest.raises(RuntimeError, match="cudaError 98"):
        sba.scale_bias_act(x, k, b, "relu")


def _conv_limit(abs_ref, k, got, want):
    lim = 8.0 * (k ** 0.5) * 2.0 ** -24 * abs_ref.double()
    if got.dtype == torch.bfloat16:
        lim = lim + _bf16_ulp(torch.maximum(got.abs(), want.abs()))
    return lim


# (N, H, W, Cin, Cout, halo): C's first conv, a D conv with Cout <= 32 (the
# narrow tile), a G phase conv, and a VALID conv with an odd size. For the
# bfloat16 kernels also: one 128-row tile (N=1, 8x8, 64 -> 64), Cin not a
# multiple of 8 (3, 13, 42), Cin a multiple of 8 but not of 64 (32, 40),
# Cout not a multiple of 8 (12, 13, 42), Cout over several 128-wide tiles
# (512, and 200 with a ragged second tile), M = N·Ho·Wo not a multiple of
# 128 (175, 297, 120, 17100), halo 0, 1, 2; and, in wgrad, K = 576 leaves
# the second warpgroup of the last 128-row block of K idle.
# For the float32 kernels, every block width: Cout 1, 12, 13, 16 (16 wide),
# 32 (32 wide), 33, 42, 64 (64 wide), 128, 130, 200 (a ragged second
# tile), 512 (128 wide), and wgrad's 32-row block of K (Cin 2 and 3);
# 4-byte copies where Cin (2, 3, 6, 13, 42) or Cout (1, 13, 33, 42, 130) is
# not a multiple of 4, 16-byte ones elsewhere; Cin not a multiple of
# the 16-deep K step (3, 4, 6, 12, 13, 40, 42), so one K tile spans two
# taps; M not a multiple of the 128- or 256-row block; halo 0, 1, 2; and
# split wgrads (M = 4096, 1536, 17100 and 3072), and forwards whose last
# tiles are shared out stream-K (512 columns over M = 192; 200 over
# M = 17100, after a whole wave of tiles).
CONV_SHAPES = [(4, 32, 32, 3, 128, 1), (6, 16, 16, 42, 32, 1), (3, 8, 8, 256, 512, 1),
               (5, 9, 7, 13, 12, 0), (1, 8, 8, 64, 64, 1), (3, 7, 9, 32, 42, 2),
               (2, 10, 6, 40, 13, 1), (19, 30, 30, 64, 200, 1), (12, 16, 16, 12, 16, 1),
               (3, 11, 13, 6, 33, 1), (2, 5, 4, 4, 1, 2), (3, 9, 11, 2, 130, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_kernels_match_plain_on_card(shape, dtype, cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    n, h, w, cin, cout, pad = shape
    rng = np.random.RandomState(1)
    dt = _DT[dtype]
    x = torch.from_numpy(rng.normal(size=(n, h, w, cin)).astype(np.float32)).to(cuda, dt)
    wt = torch.from_numpy((rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)).to(cuda, dt)
    ho, wo = h + 2 * pad - 2, w + 2 * pad - 2
    g = torch.from_numpy(rng.normal(size=(n, ho, wo, cout)).astype(np.float32)).to(cuda, dt)
    xp = cv._pad_hw(x, pad)

    key = ("fwd", n, h, w, cin, cout, pad, dtype)
    before = cv.fwd_launches.total()
    # the forward kernel, also where f32_wino_plan sends conv3x3_nopad's call
    # through the Winograd pipeline (19 × 30 × 30, 64 -> 200; its test is
    # tests/test_torch_winograd_cuda.py)
    got = cv.conv3x3_direct(x, wt, pad)
    torch.cuda.synchronize()
    assert cv.fwd_launches.total() == before + 1 and cv.fwd_launches[key] >= 1
    want = cv.reference_conv3x3_nopad(xp, wt)
    assert got.dtype == dt and got.shape == want.shape
    lim = _conv_limit(cv.reference_conv3x3_nopad(xp.abs(), wt.abs()).float(), 9 * cin, got, want)
    assert bool(((got.double() - want.double()).abs() <= lim).all()), float((got.double() - want.double()).abs().max())

    dw = cv.conv3x3_wgrad(x, g, pad)
    torch.cuda.synchronize()
    want_dw = cv.reference_conv3x3_wgrad(xp, g)
    assert dw.dtype == torch.float32 and dw.shape == (3, 3, cin, cout)
    lim = _conv_limit(cv.reference_conv3x3_wgrad(xp.abs(), g.abs()), n * ho * wo, dw, want_dw)
    assert bool(((dw.double() - want_dw.double()).abs() <= lim).all()), float((dw - want_dw).abs().max())


# The shipped step's C convs at batch 100, forward and input gradient (the
# forward kernel on the cotangent against the flipped kernel, halo 2 - 1).
# The step runs them through the Winograd pipeline: one launch of it, none
# of the forward kernel, within the pipeline's bound against the exact conv
# (tests/test_torch_winograd_cuda.py). The forward kernel
# (``conv3x3_direct``) at the same calls: 128 -> 128 at 32x32 runs 792 whole
# 128 x 128 tiles and shares the last 8 out stream-K; 256 -> 256 at 16x16
# one whole wave of 264 tiles, then 136 tiles stream-K. Both take the
# k-major im2col tile.
_SHIPPED_C_CONVS = [(100, 32, 32, 128, 128, 1), (100, 16, 16, 256, 256, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("role", ["fwd", "dgrad"])
@pytest.mark.parametrize("shape", _SHIPPED_C_CONVS)
def test_f32_shipped_c_convs_match_plain_on_card(shape, role, cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    n, h, w, cin, cout, pad = shape
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.normal(size=(n, h, w, cin)).astype(np.float32)).to(cuda)
    if role == "fwd":
        wt = torch.from_numpy((rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)).to(cuda)
    else:  # x is the cotangent of a cout -> cin conv's output, wt that conv's flipped kernel
        w0 = torch.from_numpy((rng.normal(size=(3, 3, cout, cin)) / np.sqrt(9 * cout)).astype(np.float32))
        wt = w0.flip((0, 1)).transpose(2, 3).contiguous().to(cuda)
    from triplegan_tpu_torch.ops.winograd import winograd_magnitude

    key = (role, n, h, w, cin, cout, pad, "float32")
    assert cv.f32_wino_plan(n, h, w, cin, cout) is not None
    before = (cv.wino_launches[key], cv.fwd_launches.total())
    shipped = cv.conv3x3_nopad(x, wt, pad, role=role)
    torch.cuda.synchronize()
    assert (cv.wino_launches[key], cv.fwd_launches.total()) == (before[0] + 1, before[1])
    xp = cv._pad_hw(x, pad)
    exact = cv.reference_conv3x3_nopad(cv._pad_hw(x.double(), pad), wt.double())
    lim = (cin + 32) * 2.0 ** -24 * winograd_magnitude(x, wt, pad).double()
    assert bool(((shipped.double() - exact).abs() <= lim).all()), float((shipped.double() - exact).abs().max())

    plan = cv.f32_fwd_plan(n * h * w, cin, cout)
    assert plan[2] > 0 and cv.f32_fwd_block(plan[0]) == (128, 128, "k-major")  # stream-K runs too
    before = (cv.fwd_launches[key], cv.fwd_block_launches[128, 128, "k-major"])
    got = cv.conv3x3_direct(x, wt, pad, role=role)
    torch.cuda.synchronize()
    assert (cv.fwd_launches[key], cv.fwd_block_launches[128, 128, "k-major"]) == (before[0] + 1, before[1] + 1)
    want = cv.reference_conv3x3_nopad(xp, wt)
    lim = _conv_limit(cv.reference_conv3x3_nopad(xp.abs(), wt.abs()).float(), 9 * cin, got, want)
    assert bool(((got.double() - want.double()).abs() <= lim).all()), float((got.double() - want.double()).abs().max())


# (padding, (N, H, W, Cin, Cout)): Cin 13 (4-byte copies), Cin 16 VALID, and
# 256 -> 512 at 8x8, whose forward and input gradient are stream-K alone
_F32_CONV_SHAPES = [("SAME", (3, 10, 9, 13, 40)), ("VALID", (2, 8, 8, 16, 24)), ("SAME", (3, 8, 8, 256, 512))]


def _conv_inputs(shape):
    n, h, w, cin, cout = shape
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.normal(size=(n, h, w, cin)).astype(np.float32))
    wt = torch.from_numpy((rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32))
    return x, wt


def _conv_call(x, wt, padding, dev):
    """The conv function's y, dx and dW on ``dev`` for the cotangent
    cos(0, 1, ...) made there, all as CPU tensors beside gy."""
    xd = x.to(dev, copy=True).requires_grad_()
    wd = wt.to(dev, copy=True).requires_grad_()
    y = cv.conv3x3(xd, wd, padding)
    gy = torch.cos(torch.arange(y.numel(), device=y.device, dtype=torch.float32)).reshape(y.shape)
    dx, dw = torch.autograd.grad(y, (xd, wd), gy)
    return {k: t.detach().cpu() for k, t in (("gy", gy), ("y", y), ("dx", dx), ("dw", dw))}


def _save_failing(name, x, wt, **sides):
    """Writes the failing call's inputs and every side's outputs to an npz
    under the temporary directory (``TMPDIR``); returns its path."""
    import os
    import tempfile
    import time

    path = os.path.join(tempfile.gettempdir(), f"{name}-{os.getpid()}-{time.time_ns()}.npz")
    arrays = {"x": x.numpy(), "w": wt.numpy()}
    for side, outs in sides.items():
        arrays.update({f"{side}_{k}": t.numpy() for k, t in outs.items()})
    np.savez(path, **arrays)
    return path


def _assert_card_matches_cpu(card, cpu, name, x, wt):
    try:
        for k in ("y", "dx", "dw"):
            torch.testing.assert_close(card[k], cpu[k], rtol=1e-4, atol=1e-4, msg=lambda m, k=k: f"{k}: {m}")
    except AssertionError as e:
        raise AssertionError(f"{e}\nthe call's tensors: {_save_failing(name, x, wt, card=card, cpu=cpu)}") from None


@pytest.mark.cuda
def test_conv_function_grads_match_plain_on_card(cuda):
    """y, dx and dW of the float32 conv function on the card against the
    CPU's plain version; a failing call's inputs and both sides' outputs
    are saved under TMPDIR, named in the failure."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for padding, shape in _F32_CONV_SHAPES:
        x, wt = _conv_inputs(shape)
        _assert_card_matches_cpu(_conv_call(x, wt, padding, cuda), _conv_call(x, wt, padding, "cpu"),
                                 f"conv_grads_{padding}", x, wt)


@pytest.mark.cuda
@pytest.mark.parametrize("padding,shape", _F32_CONV_SHAPES)
def test_f32_conv_function_is_bitwise_repeatable_on_card(padding, shape, cuda):
    """The float32 conv's forward, input gradient and filter gradient sum in
    a fixed order, so 200 calls at the shapes of the test above give the
    same bits as the first; the freed blocks are refilled with NaN between
    calls, so a read of memory the kernels never wrote would show. The
    CPU's plain version is repeated beside each call (its bits too must
    repeat) and each card call is held to it as the test above holds it; a
    failing call's tensors, and the first call's, are saved under TMPDIR."""
    x, wt = _conv_inputs(shape)
    rng = np.random.RandomState(3)
    first = None
    for rep in range(200):
        junk = [torch.full((int(rng.randint(1, 40000)),), float("nan"), device=cuda) for _ in range(16)]
        del junk
        got = {"card": _conv_call(x, wt, padding, cuda), "cpu": _conv_call(x, wt, padding, "cpu")}
        if first is None:
            first = got
        for side in got:
            diff = {k: int((got[side][k] != first[side][k]).sum()) for k in got[side]}
            if any(diff.values()):
                path = _save_failing(f"conv_repeat_{padding}", x, wt, **{f"first_{s}": first[s] for s in first},
                                     **got)
                raise AssertionError(f"call {rep + 1}, {side}: elements differing from the first call {diff}; "
                                     f"the calls' tensors: {path}")
        _assert_card_matches_cpu(got["card"], got["cpu"], f"conv_repeat_{padding}", x, wt)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetch_copies_the_bytes_and_orders_the_consumer_after_them(depth, cuda):
    """Host batches from the sampler (gathered by the native library)
    through ``device_prefetch``: every tensor lands on the card with the
    host batch's bytes, read by the consumer's stream after a slow kernel
    there, so a copy that the consumer did not wait for, or memory handed to
    a later batch while the consumer still reads it, would show as wrong
    bytes. Each depth rotates its ``depth + 1`` pinned slots anew."""
    from triplegan_tpu_torch.data import native
    from triplegan_tpu_torch.data.datasets import synthetic_dataset
    from triplegan_tpu_torch.data.pipeline import BatchSampler, device_prefetch

    data = synthetic_dataset(32, 3, 10, n_train=4096, n_test=4, num_labeled=400, seed=0)
    sampler = BatchSampler(data, 384, seed=3)
    host = []

    def batches():
        for _ in range(8):
            b = sampler.next_triple(100, 10)
            host.append(b)
            yield b

    copies = []
    for batch in device_prefetch(batches(), cuda, depth=depth):
        torch.cuda._sleep(2_000_000)  # the consumer's stream is busy before it reads the batch
        copies.append({(s, k): v.clone() for s, d in batch.items() for k, v in d.items()})
        assert all(v.device.type == "cuda" for d in batch.values() for v in d.values())
    torch.cuda.synchronize()
    assert native.native_available()
    assert len(copies) == len(host) == 8
    for got, want in zip(copies, host):
        assert len(got) == sum(len(d) for d in want.values())
        for (s, k), v in got.items():
            assert v.dtype == torch.from_numpy(want[s][k]).dtype
            np.testing.assert_array_equal(v.cpu().numpy(), want[s][k], err_msg=f"{s}.{k}")


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["SAME", "VALID", "weight_norm", "deconv"])
def test_bf16_layer_filter_gradients_are_bf16_on_card(route, cuda):
    """At bfloat16 the kernel arm's layers convolve with the kernel cast to
    bfloat16 first, as the JAX layers do, so the filter gradient that
    reaches the float32 weight is a bfloat16 value (the wgrad kernel's
    float32 sum rounded once): every coordinate of dW is representable in
    bfloat16, and the kernels launched."""
    from triplegan_tpu_torch.nn import layers as L

    rng = np.random.RandomState(4)
    cin, cout = 16, 32
    x = torch.from_numpy(rng.normal(size=(4, 8, 8, cin)).astype(np.float32)).to(cuda, torch.bfloat16)
    if route == "deconv":
        w = torch.from_numpy((rng.normal(size=(5, 5, cin, cout)) * 0.1).astype(np.float32)).to(cuda)
        p = {"w": w.requires_grad_()}
        y = L.deconv2d_apply(p, x, use_pallas=True)
    elif route == "weight_norm":
        v = torch.from_numpy((rng.normal(size=(cout, cin, 3, 3)) * 0.1).astype(np.float32)).to(cuda)
        p = {"v": v.requires_grad_(), "g": torch.ones(cout, device=cuda), "b": torch.zeros(cout, device=cuda)}
        y = L._conv(x, p["v"], 1, "SAME", True)  # the weight-norm route's conv, as conv2d_wn_act_apply calls it
    else:
        w = torch.from_numpy((rng.normal(size=(cout, cin, 3, 3)) * 0.1).astype(np.float32)).to(cuda)
        p = {"w": w.requires_grad_()}
        y = L.conv2d_apply(p, x, padding=route, use_pallas=True)
    leaf = p["w"] if "w" in p else p["v"]
    before = cv.wgrad_launches.total()
    (dw,) = torch.autograd.grad(y, leaf, torch.randn_like(y))
    torch.cuda.synchronize()
    assert cv.wgrad_launches.total() == before + 1
    assert dw.dtype == torch.float32 and bool(torch.isfinite(dw).all())
    assert torch.equal(dw, dw.bfloat16().float())


@pytest.mark.cuda
def test_conv_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros(2, 6, 6, 8, device=cuda)
    wt = torch.zeros(3, 3, 8, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cv.conv3x3_nopad(x.permute(0, 2, 1, 3), wt, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cv.conv3x3_nopad(x.half(), wt.half(), 1)
    with pytest.raises(TypeError, match="one dtype"):
        cv.conv3x3_nopad(x, wt.bfloat16(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        cv.conv3x3_wgrad(x, torch.zeros(2, 6, 4, 6, device=cuda).transpose(2, 3), 1)
    with pytest.raises(ValueError, match=r"\(3, 3, 8, Cout\)"):
        cv.conv3x3_nopad(x, torch.zeros(3, 3, 5, 4, device=cuda), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_wgrad_is_bitwise_repeatable(dtype, cuda):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.normal(size=(64, 16, 16, 42)).astype(np.float32)).to(cuda, _DT[dtype])
    g = torch.from_numpy(rng.normal(size=(64, 16, 16, 64)).astype(np.float32)).to(cuda, _DT[dtype])
    # the split reduction is exercised
    if dtype == "float32":
        assert cv.f32_wgrad_plan(64 * 16 * 16, 42, 64)[2] > 1
    else:
        assert cv.sm90_wgrad_plan(64 * 16 * 16, 48, 64)[1] > 1
    a = cv.conv3x3_wgrad(x, g, 1)
    b = cv.conv3x3_wgrad(x, g, 1)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_conv_raises_when_its_kernel_cannot_launch(cuda, monkeypatch):
    # The C entry points refuse what they do not take, with cudaErrorInvalidValue.
    fwd, wgrad = cv._lib_sm90()
    x = torch.zeros(2, 6, 6, 8, device=cuda, dtype=torch.bfloat16)
    wp = torch.zeros(48, 128, device=cuda, dtype=torch.bfloat16)
    y = torch.empty(2, 6, 6, 40, device=cuda, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    assert fwd(x.data_ptr(), wp.data_ptr(), y.data_ptr(), 2, 6, 6, 8, 40, 1, 48, 48, 128,
               stream) == 1  # no block 48 wide
    out = torch.empty(3, 3, 8, 40, device=cuda)
    assert wgrad(x.data_ptr(), y.data_ptr(), out.data_ptr(), out.data_ptr(), 2, 6, 6, 8, 40, 8, 40,
                 1, 64, 1, 100, stream) == 1  # chunk not a multiple of 64
    # A bf16 call whose kernel refuses raises; it takes neither the float32
    # kernel nor the plain version, and counts nothing.
    monkeypatch.setattr(cv, "_lib_sm90", lambda: (lambda *a: 98, lambda *a: 98))
    monkeypatch.setattr(cv, "_lib", lambda: pytest.fail("the float32 kernel was called"))
    monkeypatch.setattr(cv, "reference_conv3x3_nopad", lambda *a: pytest.fail("plain version called"))
    monkeypatch.setattr(cv, "reference_conv3x3_wgrad", lambda *a: pytest.fail("plain version called"))
    before = (cv.fwd_launches.copy(), cv.wgrad_launches.copy())
    wt = torch.zeros(3, 3, 8, 40, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="cudaError 98"):
        cv.conv3x3_nopad(x, wt, 1)
    with pytest.raises(RuntimeError, match="cudaError 98"):
        cv.conv3x3_wgrad(x, torch.zeros(2, 6, 6, 40, device=cuda, dtype=torch.bfloat16), 1)
    assert (cv.fwd_launches, cv.wgrad_launches) == before


@pytest.mark.cuda
def test_bf16_conv_takes_a_view_off_16_byte_alignment(cuda):
    rng = np.random.RandomState(5)
    n, h, w, cin, cout = 2, 8, 8, 64, 64
    flat = torch.from_numpy(rng.normal(size=n * h * w * cin + 1).astype(np.float32)).to(cuda, torch.bfloat16)
    x = flat[1:].view(n, h, w, cin)  # contiguous, 2 bytes past an aligned address
    gflat = torch.from_numpy(rng.normal(size=n * h * w * cout + 3).astype(np.float32)).to(cuda, torch.bfloat16)
    g = gflat[3:].view(n, h, w, cout)
    assert x.data_ptr() % 16 and g.data_ptr() % 16
    wt = torch.from_numpy((rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)).to(cuda, torch.bfloat16)
    got, dw = cv.conv3x3_nopad(x, wt, 1), cv.conv3x3_wgrad(x, g, 1)
    torch.cuda.synchronize()
    xa, ga = x.clone(), g.clone()
    assert torch.equal(got, cv.conv3x3_nopad(xa, wt, 1))
    assert torch.equal(dw, cv.conv3x3_wgrad(xa, ga, 1))


@pytest.mark.cuda
def test_f32_conv_raises_when_its_kernel_cannot_launch(cuda, monkeypatch):
    # The C entry points refuse what they do not take, with cudaErrorInvalidValue.
    fwd, wgrad = cv._lib()
    x = torch.zeros(2, 6, 6, 8, device=cuda)
    wt = torch.zeros(3, 3, 8, 40, device=cuda)
    y = torch.empty(2, 6, 6, 40, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    assert fwd(x.data_ptr(), wt.data_ptr(), y.data_ptr(), None, 2, 6, 6, 8, 40, 1, 48, 1, 0,
               stream) == 1  # no block 48 wide
    assert fwd(x.data_ptr(), wt.data_ptr(), y.data_ptr(), None, 2, 6, 6, 8, 40, 1, 64, 0, 2,
               stream) == 1  # stream-K runs with no workspace
    out = torch.empty(3, 3, 8, 40, device=cuda)
    assert wgrad(x.data_ptr(), y.data_ptr(), out.data_ptr(), out.data_ptr(), 2, 6, 6, 8, 40, 1, 128, 64, 1,
                 100, stream) == 1  # chunk not a multiple of 16
    assert wgrad(x.data_ptr(), y.data_ptr(), out.data_ptr(), out.data_ptr(), 2, 6, 6, 8, 40, 1, 128, 16, 1,
                 96, stream) == 1  # no block 16 wide
    assert wgrad(x.data_ptr(), y.data_ptr(), out.data_ptr(), out.data_ptr(), 2, 6, 6, 8, 40, 1, 32, 64, 1,
                 96, stream) == 1  # the 32-row block is 128 wide
    # A float32 call whose kernel refuses raises; it takes neither the
    # bfloat16 kernel nor the plain version, and counts nothing.
    monkeypatch.setattr(cv, "_lib", lambda: (lambda *a: 98, lambda *a: 98))
    monkeypatch.setattr(cv, "_lib_sm90", lambda: pytest.fail("the bfloat16 kernel was called"))
    monkeypatch.setattr(cv, "reference_conv3x3_nopad", lambda *a: pytest.fail("plain version called"))
    monkeypatch.setattr(cv, "reference_conv3x3_wgrad", lambda *a: pytest.fail("plain version called"))
    before = (cv.fwd_launches.copy(), cv.wgrad_launches.copy())
    with pytest.raises(RuntimeError, match="cudaError 98"):
        cv.conv3x3_nopad(x, wt, 1)
    with pytest.raises(RuntimeError, match="cudaError 98"):
        cv.conv3x3_wgrad(x, torch.zeros(2, 6, 6, 40, device=cuda), 1)
    assert (cv.fwd_launches, cv.wgrad_launches) == before


@pytest.mark.cuda
def test_f32_conv_takes_a_view_off_16_byte_alignment(cuda):
    # A view 4 bytes past an aligned address takes the 4-byte copies; the
    # products and their order are the same, so the bits are too.
    rng = np.random.RandomState(6)
    n, h, w, cin, cout = 2, 8, 8, 64, 64
    flat = torch.from_numpy(rng.normal(size=n * h * w * cin + 1).astype(np.float32)).to(cuda)
    x = flat[1:].view(n, h, w, cin)
    gflat = torch.from_numpy(rng.normal(size=n * h * w * cout + 3).astype(np.float32)).to(cuda)
    g = gflat[3:].view(n, h, w, cout)
    wflat = torch.from_numpy((rng.normal(size=9 * cin * cout + 2) * 0.1).astype(np.float32)).to(cuda)
    wt = wflat[2:].view(3, 3, cin, cout)
    assert x.data_ptr() % 16 and g.data_ptr() % 16 and wt.data_ptr() % 16
    got, dw = cv.conv3x3_nopad(x, wt, 1), cv.conv3x3_wgrad(x, g, 1)
    torch.cuda.synchronize()
    xa, ga, wa = x.clone(), g.clone(), wt.clone()
    assert torch.equal(got, cv.conv3x3_nopad(xa, wa, 1))
    assert torch.equal(dw, cv.conv3x3_wgrad(xa, ga, 1))


def _small_train(dtype="float32"):
    """cifar10_4k's layers at a few channels, every stochastic layer and
    augmentation on, 16 steps in all (1 an epoch: α_P switches on at step
    1, the lr decays from count 8); a seeded state, the data on the card."""
    from triplegan_tpu_torch.configs import get_config, make_networks
    from triplegan_tpu_torch.configs.base import apply_runtime
    from triplegan_tpu_torch.data.datasets import synthetic_dataset
    from triplegan_tpu_torch.train import step as S
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state

    cfg = get_config("cifar10_4k")
    cfg.gen.widths = (16, 8, 8)
    cfg.disc.widths = (8, 8, 16, 16, 16, 16)
    cfg.clf.conv_blocks = ((16, 16, 16), (16, 16, 16))
    cfg.clf.tail = (16, 16, 16)
    cfg.batch_size, cfg.z_dim, cfg.compute_dtype = 8, 16, dtype
    cfg.epochs, cfg.alpha_p_warmup_epochs, cfg.lr_decay_start_frac = 16, 1, 0.5
    apply_runtime(cfg)
    data = synthetic_dataset(32, 3, 10, n_train=256, n_test=8, num_labeled=40)
    nets = make_networks(cfg)
    opts = make_optimizers(cfg, 16)
    state = create_state(cfg, nets, opts, device="cuda")
    return cfg, nets, opts, state, S.upload_device_data(data, "cuda"), S


def _state_tensors(state):
    from triplegan_tpu_torch.train import step as S

    return list(S._state_tensors(state))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_step_equals_eager_step_bitwise_on_card(dtype, cuda):
    """A chunk of one step captured as a CUDA graph and replayed twice
    equals two eager steps from the same state, bitwise: parameters, BN
    stats, Adam moments and metrics (the lr and α_P change between them);
    the kernels count at capture (and in the warm-up step), not at
    replays."""
    cfg, nets, opts, state, data, S = _small_train(dtype)
    eager = S._clone_state(state)
    step = S.make_device_train_step(cfg, nets, opts, 16)
    chunk = S.make_scan_device_train_step(cfg, nets, opts, 16, 1, log=lambda *a, **k: None)
    want = []
    for _ in range(2):
        eager, m = step(eager, data)
        want.append(m)
    sba.launches.clear()
    got = []
    for _ in range(2):
        state, m = chunk(state, data)
        got.append(m)
    torch.cuda.synchronize()
    assert (chunk.captures, chunk.replays, chunk.warmup_steps) == (1, 2, 1)
    assert chunk.graph_stats["nodes"] > 0 and chunk.graph_stats["pool_bytes"] > 0
    assert sba.launches.total() > 0 and sba.launches.total() % 2 == 0  # warm-up + capture: 2 steps' worth
    assert float(want[0]["alpha_p"]) == 0.0 < float(want[1]["alpha_p"])
    for g, w in zip(got, want):
        for k in S.METRICS:
            assert torch.equal(g[k], w[k]), k
    assert state.step == eager.step == 2
    for a, b in zip(_state_tensors(state), _state_tensors(eager)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_profiled_replay_holds_each_phase_mark_a_step_in_order_on_card(cuda):
    """A K = 4 chunk's replay under the profiler runs the seven phase marks
    of each step in order, 4 times; the replay's first mark starts after
    the host span of the replay starts (one clock for both); no span leaves
    a record on the card; the state equals an unprofiled twin's bitwise."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, nets, opts, state, data, S = _small_train()
    twin = S._clone_state(state)
    quiet = lambda *a, **k: None  # noqa: E731
    chunk = S.make_scan_device_train_step(cfg, nets, opts, 16, 4, log=quiet)
    chunk.prepare(state, data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)  # the window's edges lie on the host's clock: margins on both sides
        state, got = chunk(state, data)
        torch.cuda.synchronize()
        time.sleep(0.2)
    twin, want = S.make_scan_device_train_step(cfg, nets, opts, 16, 4, log=quiet)(twin, data)
    torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    on_card = [e for e in events if e.device_type() == DeviceType.CUDA]
    marks = sorted((e.start_ns(), e.name()) for e in on_card if e.name().startswith("tg_phase_"))
    phases = ("d_grad", "d_adam", "g_grad", "g_adam", "c_grad", "c_adam", "end")
    assert [n for _, n in marks] == [f"tg_phase_{p}" for p in phases] * 4
    replays = [e for e in events if e.name() == "tg::chunk.replay" and e.device_type() != DeviceType.CUDA]
    assert len(replays) == 1 and replays[0].start_ns() < marks[0][0]
    assert not [e.name() for e in on_card if e.name().startswith("tg::")]
    for k in S.METRICS:
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(_state_tensors(state), _state_tensors(twin)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_host_sync_in_a_captured_step_raises_and_runs_nothing(cuda):
    """A step that reads a device value on the host cannot be captured: the
    chunk raises GraphCaptureError naming the line, leaves the state as it
    was (nothing ran eagerly in the graph's place) and restores the sync
    debug mode."""
    cfg, nets, opts, state, data, S = _small_train()
    step = S.make_device_train_step(cfg, nets, opts, 16)

    def syncing_body(st, d, gens, sc):
        new, m = step.body(st, d, gens, sc)
        float(m["loss_d"])  # a host read inside the step
        return new, m

    chunk = S.ScanChunk(S.TrainStep(syncing_body, step.values, step.domains), 2, log=lambda *a, **k: None)
    before = [t.clone() for t in _state_tensors(state)]
    with pytest.raises(S.GraphCaptureError, match=r"test_torch_cuda\.py:\d+ \(float\(m\[\"loss_d\"\]\)"):
        chunk(state, data)
    torch.cuda.synchronize()
    assert torch.cuda.get_sync_debug_mode() == 0
    assert chunk.captures == chunk.replays == 0 and state.step == 0
    for a, b in zip(_state_tensors(state), before):
        assert torch.equal(a, b)


def _mesh_of_one(backend, tmp_path):
    """A process group of this process alone, with ``backend``, on the card
    (a FileStore: no port), and its mesh."""
    import torch.distributed as dist

    from triplegan_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    return make_mesh(1, "cuda:0")


@pytest.mark.cuda
def test_graphed_chunk_under_gloo_on_card_raises_naming_the_backend(cuda, tmp_path):
    """Gloo's collectives on CUDA tensors stage through the host: a chunk
    under a gloo group on the card raises GraphCaptureError naming gloo,
    and nothing runs eagerly in the graph's place."""
    import torch.distributed as dist

    cfg, nets, opts, state, data, S = _small_train()
    mesh = _mesh_of_one("gloo", tmp_path)
    try:
        chunk = S.make_scan_device_train_step(cfg, nets, opts, 16, 2, log=lambda *a, **k: None, mesh=mesh)
        before = [t.clone() for t in _state_tensors(state)]
        with pytest.raises(S.GraphCaptureError, match="under a gloo process group"):
            chunk(state, data)
        assert chunk.captures == chunk.replays == chunk.warmup_steps == 0 and state.step == 0
        for a, b in zip(_state_tensors(state), before):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_graphed_chunk_under_nccl_equals_eager_steps_bitwise_on_card(cuda, tmp_path):
    """Under an NCCL group (of one: the card machine's) the chunk captures
    the step's collectives into the graph; its replays equal the same
    steps run eagerly under the group, bitwise."""
    import torch.distributed as dist

    cfg, nets, opts, state, data, S = _small_train()
    mesh = _mesh_of_one("nccl", tmp_path)
    try:
        eager = S._clone_state(state)
        step = S.make_device_train_step(cfg, nets, opts, 16, mesh=mesh)
        chunk = S.make_scan_device_train_step(cfg, nets, opts, 16, 2, log=lambda *a, **k: None, mesh=mesh)
        want = []
        for _ in range(4):
            eager, m = step(eager, data)
            want.append(m)
        got = []
        for _ in range(2):
            state, m = chunk(state, data)
            got.append(m)
        torch.cuda.synchronize()
        assert (chunk.captures, chunk.replays) == (1, 2)
        for g, w in zip(got, want[1::2]):
            for k in S.METRICS:
                assert torch.equal(g[k], w[k]), k
        assert state.step == eager.step == 4
        for a, b in zip(_state_tensors(state), _state_tensors(eager)):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_operators_launch_the_kernels_and_match_plain_on_card(dtype, cuda):
    """``torch.ops.triplegan_torch.scale_bias_act`` and ``conv3x3_fwd`` on
    CUDA tensors: one counted launch each, the plain versions' values (the
    tolerances above); the wrappers outside autograd take the operators,
    bitwise; the fakes give the shapes alone."""
    dt = _DT[dtype]
    x, k, b = (t.to(dt) for t in _inputs((5, 7, 9, 24), cuda))
    before = sba.launches.total()
    got = torch.ops.triplegan_torch.scale_bias_act(x, k, b, "leaky_relu", 0.1)
    assert sba.launches.total() == before + 1
    ok, err = _elementwise_ok(got, sba.reference_scale_bias_act(x, k, b, "leaky_relu", 0.1))
    assert ok, err
    with torch.no_grad():
        assert torch.equal(sba.scale_bias_act(x, k, b, "leaky_relu", 0.1), got)
    assert sba.launches.total() == before + 2
    rng = np.random.RandomState(4)
    xc = torch.from_numpy(rng.normal(size=(3, 9, 11, 24)).astype(np.float32)).to(cuda, dt)
    wc = torch.from_numpy((rng.normal(size=(3, 3, 24, 40)) * 0.1).astype(np.float32)).to(cuda, dt)
    before = cv.fwd_launches.total()
    y = torch.ops.triplegan_torch.conv3x3_fwd(xc, wc, 1)
    assert cv.fwd_launches.total() == before + 1
    want = cv.reference_conv3x3_nopad(cv._pad_hw(xc, 1), wc)
    ref_abs = cv.reference_conv3x3_nopad(cv._pad_hw(xc.abs(), 1), wc.abs())
    assert bool(((y.double() - want.double()).abs() <= _conv_limit(ref_abs, 9 * 24, y, want)).all())
    with torch.no_grad():
        assert torch.equal(cv.conv3x3(xc, wc, "SAME"), y)
    meta = torch.ops.triplegan_torch.conv3x3_fwd(xc.to("meta"), wc.to("meta"), 0)
    assert meta.shape == (3, 7, 9, 40) and meta.dtype == dt
    assert torch.ops.triplegan_torch.scale_bias_act(x.to("meta"), k.to("meta"), b.to("meta"), "relu",
                                                     0.1).shape == x.shape


@pytest.mark.cuda
def test_pt2_exported_on_card_launches_the_kernels_and_moves_to_the_cpu(cuda, tmp_path):
    """An artifact exported on the card (cifar10_4k's layers at a few
    channels, batch 4): on the card each call launches the forward kernels
    as often as the network has convs and epilogues and agrees with
    ``make_serving_fns`` there; moved to the CPU it launches nothing and
    agrees with the card within float32's 1e-4."""
    from triplegan_tpu_torch.cli import _apply_overrides
    from triplegan_tpu_torch.configs import get_config, make_networks
    from triplegan_tpu_torch.export import export_artifacts, load_pt2, make_serving_fns
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state

    cfg = _apply_overrides(get_config("cifar10_4k"), [
        "zca=False", "gen.widths=(32,16,8)", "clf.conv_blocks=((16,16),(32,))", "clf.tail=(32,16)"])
    nets = make_networks(cfg)
    state = create_state(cfg, nets, make_optimizers(cfg, 1), device=cuda)
    cpath, gpath = export_artifacts(cfg, nets, state, str(tmp_path), batch_size=4, device=cuda)
    classify, generate = make_serving_fns(cfg, nets, state, device=cuda)
    rng = np.random.RandomState(5)
    imgs = torch.from_numpy(rng.randint(0, 256, size=(4, 32, 32, 3)).astype(np.uint8))
    z = torch.from_numpy(rng.normal(size=(4, cfg.z_dim)).astype(np.float32))
    y = torch.tensor([0, 4, 9, 2], dtype=torch.int32)
    n_c, n_g = 3 + 2, 3 + 1  # epilogues: C's convs; G's BNs and its output
    convs_c, convs_g = 3 + 1, 3  # 3x3 stride-1 convs: C's SAME and t0; G's phase convs
    for path, args, ref, n_sba, n_conv in ((cpath, (imgs,), classify, n_c, convs_c),
                                           (gpath, (z, y), generate, n_g, convs_g)):
        art = load_pt2(path, device=cuda)
        before = (sba.launches.total(), cv.fwd_launches.total())
        got = art(*args)
        torch.cuda.synchronize()
        assert (sba.launches.total(), cv.fwd_launches.total()) == (before[0] + n_sba, before[1] + n_conv)
        torch.testing.assert_close(got, ref(*(a.to(cuda) for a in args)), rtol=0, atol=1e-5)
        on_cpu = load_pt2(path, device="cpu")
        before = (sba.launches.total(), cv.fwd_launches.total())
        out = on_cpu(*args)
        assert out.device.type == "cpu"
        assert (sba.launches.total(), cv.fwd_launches.total()) == before
        torch.testing.assert_close(out, got.cpu(), rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [20, 100])
def test_graphed_supervised_step_equals_eager_steps_bitwise_on_card(cuda, batch):
    """The digits campaign's supervised arm
    (``tools/digits_experiment.py::SupervisedBaseline``): its step, a
    one-step ``ScanChunk`` captured once and replayed 3 times, equals 3
    eager steps of its ``train_step`` from the same weights, bitwise
    (losses, parameters, BN statistics, Adam moments), noise and dropout
    drawn from the same per-step seeds; its eval too. At batch 100 the
    shapes are those of the campaign (100 labels, one batch)."""
    from triplegan_tpu_torch.configs import get_config
    from triplegan_tpu_torch.tools.digits_experiment import SupervisedBaseline
    from triplegan_tpu_torch.train.step import _state_tensors

    cfg = get_config("mnist100")
    cfg.batch_size = batch
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (batch, 28, 28, 1)).astype(np.uint8)
    y = np.arange(batch) % 10
    eager, graphed = (SupervisedBaseline(cfg, x, y, cuda, noise_seed=5) for _ in range(2))
    e_losses = []
    for _ in range(3):
        eager.state, m = eager.train_step(eager.state, eager.data)
        e_losses.append(float(m["loss"]))
    assert [float(graphed.step()) for _ in range(3)] == e_losses
    assert (graphed.chunk.captures, graphed.chunk.replays) == (1, 3)
    got, want = list(_state_tensors(graphed.state)), list(_state_tensors(eager.state))
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    assert eager.state.step == graphed.state.step == 3
    assert eager.state.opt["clf"].count == graphed.state.opt["clf"].count == 3
    x_test = rng.randint(0, 256, (50, 28, 28, 1)).astype(np.uint8)
    assert eager.error(x_test, np.zeros(50)) == graphed.error(x_test, np.zeros(50))
