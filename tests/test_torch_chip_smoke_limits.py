"""chip_smoke.py's limit on the epilogue backward's channel sums (dk, db),
on the CPU: it passes float32 sums of the plain backward's terms taken in
another order, and fails sums that left out as few rows as one block of
the backward kernel sums (1/400 of them here) or a tenth of them.

The limit is γ_n·Σ|terms| (n the depth of the sums: 120 here, above the
≈111 additions of the order below and of the order of what the kernel
reaches at the path's widest shapes), plus one bfloat16 ulp at bfloat16;
``chip_smoke.bwd_sums_excess``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from triplegan_tpu_torch.ops import scale_bias_act as sba  # noqa: E402

DEPTH = 120


def _case(dtype, seed=0):
    rng = np.random.RandomState(seed)
    shape = (40, 32, 32, 16)
    c = shape[-1]
    x = torch.from_numpy((rng.normal(size=shape) * 2.0).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    k = torch.from_numpy((rng.normal(size=c) * 0.5 + 1.0).astype(np.float32)).to(dtype)
    b = torch.from_numpy((rng.normal(size=c) * 0.3).astype(np.float32)).to(dtype)
    t = sba.reference_bwd_t(x, k, b, g, "leaky_relu", 0.1)
    m = x.numel() // c
    return {"dk": (t * x).reshape(m, c), "db": t.reshape(m, c)}


def _f32_sum(terms, keep):
    """A float32 sum of the kept rows in an order other than the exact
    sum's: 400 chains of every 400th row, then the chains, rounded once to
    the terms' dtype."""
    rows = terms.float()[keep]
    n = rows.shape[0] - rows.shape[0] % 400
    total = rows[:n].reshape(-1, 400, rows.shape[1]).sum(0).sum(0) + rows[n:].sum(0)
    return total.to(terms.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fault", [None, "one block", "a tenth"])
def test_sum_limit_passes_a_reordered_sum_and_fails_dropped_rows(dtype, fault):
    for name, terms in _case(getattr(torch, dtype)).items():
        m = terms.shape[0]
        keep = torch.ones(m, dtype=torch.bool)
        drop = {None: 0, "one block": m // 400, "a tenth": m // 10}[fault]
        keep[m // 3:m // 3 + drop] = False
        err, excess, share = chip_smoke.bwd_sums_excess(_f32_sum(terms, keep), terms, DEPTH)
        if fault is None:
            assert excess <= 0, (name, err, share)
        else:
            assert excess > 0, (name, err, share)
