"""The scale_bias_act CUDA kernel against its plain PyTorch version, on the
card. Skips where there is no CUDA device (the kernel has no CPU mode).

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: float32 |kernel − plain| ≤ 1e-6·(1 + |plain|); bfloat16 within
one bfloat16 ulp (the kernel rounds as the plain version does, so both are
met with room).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
            before = sba.launches
            got = sba.scale_bias_act(x, k, b, act, 0.1)
            torch.cuda.synchronize()
            assert sba.launches == before + 1
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
