"""Winograd F(2×2, 3×3) convolution (NHWC, stride 1): the port of
``triplegan_tpu/ops/winograd.py`` (``conv3x3_winograd``, SAME), and the
plain version of the float32 Winograd pipeline of ``ops/conv3x3.py``
(``winograd_nopad``: ``conv3x3_nopad``'s semantics, a VALID conv of x read
with a zero halo of 0, 1 or 2 pixels, any output size).

The 3×3 conv over each 2×2 output tile becomes 16 products of contraction
depth Cin, one for each of the 4×4 Winograd-domain positions: 16/36 of the
direct conv's multiply-adds, paid for with the input and output tile
transforms and an activation tensor 4× as large (overlapping 4×4 tiles at
stride 2). Where Ho or Wo is odd the last row or column of tiles reads
zeros past the input's halo and its second output row or column is
dropped, as the pipeline's kernels mask it.

Transform matrices (Lavin & Gray 2015), as in the JAX module:
    Bᵀ = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]]
    G  = [[1,0,0],[½,½,½],[½,−½,½],[0,0,1]]
    Aᵀ = [[1,1,1,0],[0,1,-1,-1]]
"""

from __future__ import annotations

import torch

_BT = ((1, 0, -1, 0), (0, 1, 1, 0), (0, -1, 1, 0), (0, 1, 0, -1))
_G = ((1, 0, 0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0, 0, 1))
_AT = ((1, 1, 1, 0), (0, 1, -1, -1))


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b batched, in a's dtype with float32 sums and a float32 result
    (JAX's ``preferred_element_type=float32``). For bfloat16 on the CPU,
    the same numbers through float32: a product of two bfloat16 values is
    exact in float32."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _winograd(x: torch.Tensor, w: torch.Tensor, pad: int, bt, g, at) -> torch.Tensor:
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    if tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"conv3x3_winograd: w must be (3, 3, {cin}, Cout) HWIO, got {tuple(w.shape)}")
    if pad not in (0, 1, 2):
        raise ValueError(f"halo must be 0, 1 or 2 pixels, got {pad}")
    ho, wo = h + 2 * pad - 2, wd + 2 * pad - 2
    if ho <= 0 or wo <= 0:
        raise ValueError(f"input {tuple(x.shape)} with halo {pad} is smaller than the 3x3 kernel")
    h2, w2 = -(-ho // 2), -(-wo // 2)
    f32 = dict(dtype=torch.float32, device=x.device)
    bt, g, at = (torch.tensor(m, **f32) for m in (bt, g, at))

    # kernel transform U = G w Gᵀ → (4, 4, Cin, Cout), float32
    u = torch.einsum("ki,ijco,lj->klco", g, w.float(), g)
    # overlapping 4×4 input tiles at stride 2 of the input with its halo, and
    # zeros past it to whole tiles: 16 strided slices → (4, 4, N, H2, W2, Cin)
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad + 2 * w2 - wo, pad, pad + 2 * h2 - ho))
    tiles = torch.stack([torch.stack([xp[:, dy:dy + 2 * h2:2, dx:dx + 2 * w2:2, :] for dx in range(4)])
                         for dy in range(4)])
    # input transform V = Bᵀ X B over the two tile axes (float32), then x's dtype
    v = torch.einsum("ki,ijnhwc,lj->klnhwc", bt, tiles.float(), bt).to(x.dtype)
    # 16 products in the Winograd domain, float32 sums
    m = _bmm_f32(v.reshape(16, n * h2 * w2, cin), u.to(x.dtype).reshape(16, cin, cout))
    m = m.reshape(4, 4, n, h2, w2, cout)
    # output transform Y = Aᵀ M A → (N, H2, 2, W2, 2, Cout): the 2×2 phases
    # interleaved, and a ragged last row or column of tiles cut to Ho, Wo
    y = torch.einsum("ak,klnhwd,bl->nhawbd", at, m, at)
    return y.reshape(n, 2 * h2, 2 * w2, cout)[:, :ho, :wo].to(x.dtype)


def conv3x3_winograd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 SAME conv through F(2×2, 3×3); ``x`` (N, H, W, Cin)
    with even H and W (``ValueError`` otherwise), ``w`` (3, 3, Cin, Cout)
    HWIO → (N, H, W, Cout) in x's dtype. The transforms run in float32, the
    16 products in x's dtype with float32 sums, as in the JAX module."""
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"conv3x3_winograd: F(2x2, 3x3) tiles need even H and W, got {x.shape[1]}x{x.shape[2]}")
    return _winograd(x, w, 1, _BT, _G, _AT)


def winograd_nopad(x: torch.Tensor, w: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """``conv3x3_nopad(x, w, pad)`` through F(2×2, 3×3): the VALID 3×3 conv
    of NHWC ``x`` read with a zero halo of ``pad`` (0, 1 or 2) pixels, with
    the HWIO ``w`` → (N, Ho, Wo, Cout) in x's dtype, Ho = H + 2·pad − 2 of
    any parity. What the float32 Winograd pipeline on the card computes,
    as ``conv3x3_winograd`` computes it."""
    return _winograd(x, w, pad, _BT, _G, _AT)


def winograd_magnitude(x: torch.Tensor, w: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """The same computation on |x| and |w| with the transform matrices'
    absolute values, in float32, for the halo ``pad`` (1: SAME): at each
    output, a bound on the sum of the magnitudes of the terms that every
    rounding of ``winograd_nopad`` (``conv3x3_winograd`` at pad 1) acts
    on, which scales its rounding error."""
    def mag(m):
        return tuple(tuple(abs(v) for v in row) for row in m)

    return _winograd(x.abs().float(), w.abs().float(), pad, mag(_BT), mag(_G), mag(_AT))
