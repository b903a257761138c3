"""The batch norms' train-mode moments (``ops/scale_bias_act.py``:
``reference_bn_moments``, ``bn_moments`` and its ``autograd.Function``) on
the CPU: the plain twin equals the formula the layers computed before it bit
for bit; the Function's closed-form backward, on its plain path, equals
autograd of that formula (float64 within 1e-12, float32 within 1e-6
relative, bfloat16 within one bfloat16 ulp of the float32 value both round
once), alone and through both callers; the ``use_pallas=False`` arm and eval
mode are the layers' old computation bit for bit; and the moments' kernel
names (``bnm_*``) match no kernel-name pattern of the benchmark's metrics.
The kernels themselves run on the card (``tests/test_torch_cuda.py``)."""

import glob
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from triplegan_tpu_torch.nn import layers as L  # noqa: E402
from triplegan_tpu_torch.ops import scale_bias_act as sba  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(6, 8), (10, 12), (2, 5, 3, 8), (3, 4, 4, 12)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


def _old_moments(x):
    """The layers' train-mode moments as they were computed before the twin."""
    axes = tuple(range(x.dim() - 1))
    xf = x.float()
    return torch.mean(xf, dim=axes), torch.mean(torch.square(xf), dim=axes)


def _x(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=shape) * 1.5 + 0.3
    return torch.from_numpy(x).to(DTYPES[dtype])


def _cotangents(c, seed=1):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.normal(size=(c,)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(c,)).astype(np.float32)))


def _close(got, want, dtype):
    """float64 within 1e-12 and float32 within 1e-6 of the largest |want|;
    bfloat16 within one bfloat16 ulp of each value."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    if dtype == "bfloat16":
        mag = torch.clamp_min(torch.maximum(got.abs(), want.abs()), 2.0 ** -126)
        return bool((err <= torch.exp2(torch.floor(torch.log2(mag)) - 7)).all())
    tol = 1e-12 if dtype == "float64" else 1e-6
    return bool((err <= tol * want.abs().max()).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_bn_moments_equals_the_old_formula_bitwise(shape, dtype):
    x = _x(shape, dtype)
    got, want = sba.reference_bn_moments(x), _old_moments(x)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_moments_function_backward_equals_autograd_of_the_formula(shape, dtype):
    gm, gq = (v.to(torch.promote_types(DTYPES[dtype], torch.float32)) for v in _cotangents(shape[-1]))
    x = _x(shape, dtype).requires_grad_()
    outs = sba._BNMoments.apply(x)
    (dx,) = torch.autograd.grad(outs, x, (gm, gq))
    x2 = x.detach().requires_grad_()
    want_outs = sba.reference_bn_moments(x2)
    (want,) = torch.autograd.grad(want_outs, x2, (gm, gq))
    for g, w in zip(outs, want_outs):
        assert torch.equal(g, w)
    assert dx.dtype == x.dtype and dx.shape == x.shape
    assert _close(dx, want, dtype), float((dx.double() - want.double()).abs().max())


@pytest.mark.parametrize("missing", ["mean", "mean_sq", "both"])
def test_moments_function_takes_a_missing_cotangent_as_zero(missing):
    x = _x((4, 3, 8), "float32").requires_grad_()
    gm, gq = _cotangents(8)
    mean, mean_sq = sba._BNMoments.apply(x)
    used = {"mean": mean_sq * gq, "mean_sq": mean * gm, "both": x.sum() * 0.0}[missing]
    (dx,) = torch.autograd.grad(used.sum(), x)
    x2 = x.detach().requires_grad_()
    m2, q2 = sba.reference_bn_moments(x2)
    used2 = {"mean": q2 * gq, "mean_sq": m2 * gm, "both": x2.sum() * 0.0}[missing]
    (want,) = torch.autograd.grad(used2.sum(), x2)
    assert _close(dx, want, "float32")


def _call(caller, x, p, s, y, use_pallas, train=True):
    if caller == "batchnorm_act_apply":
        return L.batchnorm_act_apply(p, s, x, train=train, act="leaky_relu", slope=0.1, momentum=0.9,
                                     use_pallas=use_pallas)
    return L.cond_batchnorm_act_apply(p, s, x, y, train=train, act="relu", momentum=0.9, use_pallas=use_pallas)


def _caller_params(caller, c, seed=2):
    rng = np.random.RandomState(seed)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    if caller == "batchnorm_act_apply":
        p = {"scale": 1.0 + 0.2 * t(c), "bias": 0.1 * t(c)}
    else:
        p = {"gamma": 1.0 + 0.2 * t(10, c), "beta": 0.1 * t(10, c)}
    s = {"mean": 0.1 * t(c), "var": 1.0 + 0.1 * t(c).abs()}
    return p, s


CALLERS = ["batchnorm_act_apply", "cond_batchnorm_act_apply"]


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 8), (3, 4, 4, 12)])
@pytest.mark.parametrize("caller", CALLERS)
def test_moments_function_through_the_callers_equals_the_plain_moments(caller, shape, dtype, monkeypatch):
    p, s = _caller_params(caller, shape[-1])
    y = torch.arange(shape[0]) % 10

    def grads(x):
        x = x.detach().requires_grad_()
        pp = {k: v.detach().requires_grad_() for k, v in p.items()}
        out, new_s = _call(caller, x, pp, s, y, use_pallas=False)
        g = torch.from_numpy(np.random.RandomState(3).normal(size=shape)).to(out.dtype)
        return out, new_s, torch.autograd.grad(out, [x, *pp.values()], g)

    x = _x(shape, dtype)
    want = grads(x)
    monkeypatch.setattr(L, "reference_bn_moments", sba._BNMoments.apply)
    got = grads(x)
    assert torch.equal(got[0], want[0])
    for key in ("mean", "var"):
        assert torch.equal(got[1][key], want[1][key])
    for g, w in zip(got[2], want[2]):
        assert g.dtype == w.dtype and _close(g, w, dtype if g.dtype == x.dtype else "float32")


def _old_batchnorm_act(caller, p, s, x, y, train, use_pallas):
    """The two callers as they were before the moments kernels: mean and var
    from ``_old_moments`` (train) or the running stats (eval)."""
    eps, momentum = 1e-3, 0.9
    if train:
        mean, mean_sq = _old_moments(x)
        var = torch.clamp_min(mean_sq - mean * mean, 0.0)
        with torch.no_grad():
            new_s = {"mean": momentum * s["mean"] + (1.0 - momentum) * mean,
                     "var": momentum * s["var"] + (1.0 - momentum) * var}
    else:
        mean, var, new_s = s["mean"], s["var"], s
    if caller == "batchnorm_act_apply":
        k = p["scale"] * torch.rsqrt(var + eps)
        b = p["bias"] - mean * k
        return L._scale_bias_act(x, k.to(x.dtype), b.to(x.dtype), "leaky_relu", 0.1, use_pallas), new_s
    k = p["gamma"][y.long()] * torch.rsqrt(var + eps)
    b = p["beta"][y.long()] - mean * k
    k, b = k.to(x.dtype), b.to(x.dtype)
    if use_pallas:
        return sba.scale_bias_act_cond(x.contiguous(), k, b, "relu", 0.1), new_s
    shp = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    return sba.apply_act(x * k.reshape(shp) + b.reshape(shp), "relu", 0.1).to(x.dtype), new_s


@pytest.mark.parametrize("mode", ["train, use_pallas off", "eval, use_pallas off", "eval, use_pallas on"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("caller", CALLERS)
def test_plain_arm_and_eval_mode_are_unchanged_bitwise(caller, dtype, mode):
    shape = (3, 4, 4, 12)
    train, use_pallas = mode.startswith("train"), mode.endswith("on")
    p, s = _caller_params(caller, shape[-1])
    y = torch.arange(shape[0]) % 10
    results = []
    for fn in (lambda *a: _call(caller, *a[:4], use_pallas, train),
               lambda x, p, s, y: _old_batchnorm_act(caller, p, s, x, y, train, use_pallas)):
        x = _x(shape, dtype).requires_grad_()
        pp = {k: v.detach().requires_grad_() for k, v in p.items()}
        out, new_s = fn(x, pp, s, y)
        g = torch.from_numpy(np.random.RandomState(3).normal(size=shape)).to(out.dtype)
        results.append((out, new_s, torch.autograd.grad(out, [x, *pp.values()], g)))
    (out, new_s, grads), (old_out, old_s, old_grads) = results
    assert torch.equal(out, old_out)
    for key in ("mean", "var"):
        assert torch.equal(new_s[key], old_s[key])
    for g, w in zip(grads, old_grads):
        assert torch.equal(g, w)


def test_kernel_arm_on_the_cpu_takes_the_twin_and_launches_nothing():
    x = _x((3, 4, 4, 12), "float32")
    before = sba.moments_launches.total(), sba.moments_bwd_launches.total()
    got = sba.bn_moments(x)
    assert (sba.moments_launches.total(), sba.moments_bwd_launches.total()) == before
    for g, w in zip(got, _old_moments(x)):
        assert torch.equal(g, w)


def _bnm_kernel_names():
    with open(os.path.join(ROOT, "triplegan_tpu_torch", "ops", "csrc", "scale_bias_act.cu")) as f:
        src = f.read()
    return sorted(set(re.findall(r"^(bnm_\w+)\(", src, flags=re.M)))


def _metric_patterns():
    out = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "benchmark", "metrics", "*", "*.txt"))):
        with open(path) as f:
            out[os.path.relpath(path, ROOT)] = [ln.strip() for ln in f
                                                if ln.strip() and not ln.lstrip().startswith("#")]
    return out


def test_bnm_kernel_names_match_no_benchmark_pattern():
    names = _bnm_kernel_names()
    assert names == ["bnm_bwd_rows", "bnm_fwd_rows", "bnm_reduce"]
    patterns = _metric_patterns()
    assert {"benchmark/metrics/epilogue_roofline.train/scale_bias_act.txt",
            "benchmark/metrics/cbn_roofline.train_snresnet/cbn.txt",
            "benchmark/metrics/conv_roofline.train/conv3x3.txt"} <= set(patterns)
    # the kernels as the profiler names them, at every dtype they are built for
    records = [f"void (anonymous namespace)::{n}<{t}>({t} const*, float*, long long, int)"
               for n in names for t in ("float", "__nv_bfloat16")]
    records += ["(anonymous namespace)::bnm_reduce(float const*, int, int, float, float*, float*)"]
    for path, pats in patterns.items():
        for pat in pats:
            hits = [r for r in records if re.search(pat, r)]
            assert not hits, (path, pat, hits)
    # the patterns do match the kernels they are for
    assert re.search(patterns["benchmark/metrics/epilogue_roofline.train/scale_bias_act.txt"][0],
                     "void (anonymous namespace)::sba_fwd_rows<float, 4, 2>(float const*)")
