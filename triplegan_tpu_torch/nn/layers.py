"""Layer functions of the serving path, over plain dicts of tensors.

Each function mirrors its namesake in ``triplegan_tpu/nn/layers.py`` and
takes the same parameter names. Activations are NHWC at every public
function, as in the JAX package. Weight layouts follow PyTorch where a
library call takes them: a conv kernel is OIHW (the bridge permutes JAX's
HWIO); a dense kernel stays (in, out); a deconv kernel stays JAX's
(k, k, in, out), because the subpixel plan reads its taps directly.

A contiguous NHWC tensor permuted to NCHW is a channels_last view, which
``F.conv2d`` takes without a copy and answers in channels_last, so the
result permuted back is contiguous NHWC again: the rows of C channels that
the epilogue kernel reads.

Init functions keep JAX's shapes and scales (normal, std 0.05; g = 1,
b = 0; BN scale 1, bias 0, mean 0, var 1) and draw from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from triplegan_tpu_torch.ops.scale_bias_act import apply_act, scale_bias_act

Params = Dict[str, torch.Tensor]


def _normal(gen: torch.Generator, shape, stddev: float) -> torch.Tensor:
    return stddev * torch.randn(tuple(shape), generator=gen, dtype=torch.float32)


def _wn_kernel(v: torch.Tensor, g: torch.Tensor, reduce_axes: Tuple[int, ...]) -> torch.Tensor:
    """w = g · v / ‖v‖ per output channel, the norm taken over ``reduce_axes``
    (every axis but the output axis)."""
    norm = torch.sqrt(torch.sum(v * v, dim=reduce_axes, keepdim=True) + 1e-12)
    return v * (g.reshape(norm.shape) / norm)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


def dense_init(gen, in_dim, out_dim, *, w_std=0.05) -> Params:
    return {"w": _normal(gen, (in_dim, out_dim), w_std), "b": torch.zeros(out_dim)}


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Conv2D (NHWC activations, OIHW kernels), stride 1
# ---------------------------------------------------------------------------


def conv2d_init(gen, in_ch, out_ch, *, kernel=3, w_std=0.05, use_bias=True) -> Params:
    p: Params = {"w": _normal(gen, (out_ch, in_ch, kernel, kernel), w_std)}
    if use_bias:
        p["b"] = torch.zeros(out_ch)
    return p


def _conv_nhwc(x: torch.Tensor, w_oihw: torch.Tensor, padding) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_apply(p: Params, x: torch.Tensor, *, padding: str = "SAME") -> torch.Tensor:
    """Stride-1 conv with TF padding names; SAME pads (k−1)/2 on each side
    of an odd kernel, VALID pads nothing. (The Discriminator's stride-2 and
    weight-norm convs come with the training slice.)"""
    w = p["w"]
    kh, kw = w.shape[2:]
    if padding == "SAME":
        if kh % 2 == 0 or kw % 2 == 0:
            raise NotImplementedError("SAME padding of an even kernel")
        pad = ((kh - 1) // 2, (kw - 1) // 2)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    y = _conv_nhwc(x, w.to(x.dtype), pad)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Transposed Conv2D (TF conv2d_transpose SAME), evaluated as a subpixel conv
# ---------------------------------------------------------------------------


def deconv2d_init(gen, in_ch, out_ch, *, kernel=5, weight_norm=False, w_std=0.05,
                  use_bias=True) -> Params:
    v = _normal(gen, (kernel, kernel, in_ch, out_ch), w_std)
    p: Params = {"v": v, "g": torch.ones(out_ch)} if weight_norm else {"w": v}
    if use_bias:
        p["b"] = torch.zeros(out_ch)
    return p


def _subpixel_plan(k: int, s: int):
    """Phase decomposition of a stride-``s`` SAME transposed conv: for each
    output phase a = o mod s, the kernel taps ``(p, offset)`` that reach it,
    and the least and greatest offset. Same plan as the JAX package's."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    phases = []
    offsets = []
    for a in range(s):
        taps = [(p, (a + p - pad_a) // s) for p in range(k) if (a + p - pad_a) % s == 0]
        phases.append(taps)
        offsets += [d for _, d in taps]
    return phases, min(offsets), max(offsets)


def phase_kernel(w: torch.Tensor, stride: int) -> torch.Tensor:
    """The dense (s²·Cout, Cin, kk, kk) conv kernel equivalent to the
    transposed-conv kernel ``w`` (k, k, Cin, Cout): output channel
    ``(a·s + b)·Cout + cout`` holds phase (a, b). Built in w's dtype."""
    k, _, cin, cout = w.shape
    s = stride
    phases, d_min, d_max = _subpixel_plan(k, s)
    kk = d_max - d_min + 1
    wp = torch.zeros((kk, kk, cin, s * s, cout), dtype=w.dtype, device=w.device)
    for a in range(s):
        for b in range(s):
            for pu, du in phases[a]:
                for pv, dv in phases[b]:
                    wp[du - d_min, dv - d_min, :, a * s + b, :] = w[pu, pv]
    return wp.reshape(kk, kk, cin, s * s * cout).permute(3, 2, 0, 1).contiguous()


def _deconv2d_subpixel(x: torch.Tensor, wp: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``conv_transpose`` SAME of NHWC x as one dense conv with the phase
    kernel ``wp`` (from :func:`phase_kernel`), then depth-to-space."""
    s = stride
    n, h, wd, _ = x.shape
    _, d_min, d_max = _subpixel_plan(k, s)
    cout = wp.shape[0] // (s * s)
    xc = x.permute(0, 3, 1, 2)
    if -d_min == d_max:
        y = F.conv2d(xc, wp.to(x.dtype), padding=d_max)
    else:
        y = F.conv2d(F.pad(xc, (-d_min, d_max, -d_min, d_max)), wp.to(x.dtype))
    y = y.permute(0, 2, 3, 1)  # (n, h, w, s·s·cout), phases outermost
    y = y.reshape(n, h, wd, s, s, cout).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h * s, wd * s, cout)


def deconv2d_apply(p: Params, x: torch.Tensor, *, stride: int = 2,
                   wp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """TF-semantics ``conv2d_transpose`` with SAME padding: out = in · stride.
    ``wp`` is the layer's phase kernel when the caller built it at load; it
    is built from ``p`` here otherwise."""
    w = _wn_kernel(p["v"], p["g"], (0, 1, 2)) if "v" in p else p["w"]
    if wp is None:
        wp = phase_kernel(w, stride)
    y = _deconv2d_subpixel(x, wp, w.shape[0], stride)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Batch norm (eval) and fused epilogues
# ---------------------------------------------------------------------------


def batchnorm_init(num_features: int) -> Tuple[Params, Params]:
    params = {"scale": torch.ones(num_features), "bias": torch.zeros(num_features)}
    state = {"mean": torch.zeros(num_features), "var": torch.ones(num_features)}
    return params, state


def _scale_bias_act(x, k, b, act, slope, use_pallas):
    """Per-channel affine + activation: the Hopper kernel when ``use_pallas``
    (its plain version for a CPU tensor), else the plain epilogue that the
    JAX package's non-Pallas branch computes, in x's dtype."""
    if use_pallas:
        return scale_bias_act(x, k, b, act or "linear", slope)
    return apply_act(x * k + b, act or "linear", slope).to(x.dtype)


def batchnorm_act_apply(p: Params, s: Params, x: torch.Tensor, *, act: Optional[str] = None,
                        slope: float = 0.1, eps: float = 1e-3,
                        use_pallas: bool = False) -> torch.Tensor:
    """Eval-mode batch norm folded to ``act(x·k + b)`` with
    k = scale·rsqrt(var + eps), b = bias − mean·k, from the running stats.
    Train mode (batch moments) comes with the training slice."""
    k = p["scale"] * torch.rsqrt(s["var"] + eps)
    b = p["bias"] - s["mean"] * k
    return _scale_bias_act(x, k.to(x.dtype), b.to(x.dtype), act, slope, use_pallas)


def deconv2d_wn_act_apply(p: Params, x: torch.Tensor, *, stride: int = 2,
                          act: Optional[str] = None, slope: float = 0.2,
                          use_pallas: bool = False,
                          wp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weight-norm transposed conv with the norm as a fused epilogue:
    deconv(x, v·g/‖v‖) = deconv(x, v)·(g/‖v‖) per output channel. With
    ``use_pallas`` the raw-v deconv runs and k = g/‖v‖ goes into the kernel;
    without it, the normalized kernel is applied as ``deconv2d_apply`` does.
    ``wp`` is the phase kernel of whichever of the two this path convolves."""
    if "v" not in p or not use_pallas:
        return apply_act(deconv2d_apply(p, x, stride=stride, wp=wp), act or "linear", slope)
    v, g = p["v"], p["g"]
    norm = torch.sqrt(torch.sum(v * v, dim=(0, 1, 2)) + 1e-12)
    k = (g / norm).to(x.dtype)
    b = p["b"].to(x.dtype) if "b" in p else torch.zeros_like(k)
    if wp is None:
        wp = phase_kernel(v, stride)
    y = _deconv2d_subpixel(x, wp, v.shape[0], stride).to(x.dtype)
    return _scale_bias_act(y.contiguous(), k, b, act, slope, True)


# ---------------------------------------------------------------------------
# Pooling and labels
# ---------------------------------------------------------------------------


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Non-overlapping (stride = window) max pool with TF SAME padding,
    NHWC. SAME then pads only the far edge of an odd size, which
    ``ceil_mode`` reproduces."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, window, ceil_mode=True)
    return y.permute(0, 2, 3, 1).contiguous()


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=(1, 2))


def onehot(labels: torch.Tensor, num_classes: int, dtype=torch.float32) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).to(dtype)
