"""Layer functions of the three networks, over plain dicts of tensors.

Each function mirrors its namesake in ``triplegan_tpu/nn/layers.py`` and
takes the same parameter names, in eval and in train mode. Activations are
NHWC at every public function, as in the JAX package. Weight layouts
follow PyTorch where a library call takes them: a conv kernel is OIHW (the
bridge permutes JAX's HWIO); a dense kernel stays (in, out); a deconv
kernel stays JAX's (k, k, in, out), because the subpixel plan reads its
taps directly.

``use_pallas`` routes every 3×3 stride-1 conv (the Classifier's SAME convs
and its VALID ``t0``, the Discriminator's stride-1 convs, and the
Generator's subpixel phase convs) through the Hopper conv kernels
(``ops/conv3x3.py``), every epilogue through the Hopper
``scale_bias_act`` kernel and every train-mode batch norm's moments
through the ``bn_moments`` kernels; on the CPU those take their plain
versions.
1×1 convs, stride-2 convs and every conv with ``use_pallas`` off go to
``F.conv2d``; StyleGAN2's stride-2 transposed convs (its up-convs'
forwards, its stride-2 convs' input gradients) go, with ``use_pallas`` at
float32, to the hand-written ``tconv3x3_s2`` kernel.

A contiguous NHWC tensor permuted to NCHW is a channels_last view, which
``F.conv2d`` takes without a copy and answers in channels_last, so the
result permuted back is contiguous NHWC again: the rows of C channels that
the epilogue kernel reads.

The SN-ResNet pair (``networks.py``) adds layers the JAX package does not
have: class-conditional batch norm (per-class γ and β tables folded into
a per-sample epilogue, ``scale_bias_act_cond``), spectral normalisation
(one power iteration from a kept vector u, σ = u'ᵀ·W·v, W/σ; in the
kernel arm 1/σ goes into the epilogue as k), nearest 2× upsampling, 2×2
average pooling and a global sum.

The StyleGAN2 pair (``networks.py``) adds StyleGAN2-ADA's layers
(Karras et al., arXiv:1912.04958 and arXiv:2006.06676; NVlabs/
stylegan2-ada-pytorch ``training/networks.py``): equalised-learning-rate
dense and conv layers (each weight drawn N(0, 1) and scaled by its gain
1/√fan_in, times the lr multiplier, at use), the second-moment
normalisation of the mapping's inputs, the modulated conv (x ⊙ s, the
shared-weight conv, then the demodulation d, the noise, the bias, leaky
ReLU times √2 and the clamp, as StyleGAN2-ADA trains: in the kernel arm
x ⊙ s is one launch of the per-sample epilogue with act linear, and what
follows the conv one launch of ``scale_bias_act_noise``, with √2 folded
into k, b and the noise term, as leaky ReLU is positively homogeneous),
ToRGB, the FIR filter [1, 3, 3, 1] ⊗ [1, 3, 3, 1] / 64 (upfirdn2d's
paddings), the up-conv (a stride-2 transposed conv and the filter at gain
4), D's filtered stride-2 conv and the minibatch standard deviation.

Init functions keep JAX's shapes and scales (normal, std 0.05; g = 1,
b = 0; BN scale 1, bias 0, mean 0, var 1) and draw from an explicit
``torch.Generator``. The stochastic layers (noise, dropout) draw from an
explicit generator too; with none they are the identity, as JAX's are
with no key.

The layer variants the JAX package reads from the environment compute
JAX's layer here too, read when JAX reads them: ``TRIPLEGAN_DECONV``
(``transpose``: ``conv_transpose``) and ``TRIPLEGAN_MAXPOOL``
(``reshape``, ``maskbwd``) at import, ``TRIPLEGAN_SMALLCIN`` (``patches``)
and ``TRIPLEGAN_DROPOUT_BITS`` (``8``) at each call. ``patches`` and
``transpose`` take their convs off the Hopper kernels in either arm.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from triplegan_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_s2, conv_transpose3x3_s2
from triplegan_tpu_torch.ops.scale_bias_act import (apply_act, bn_moments, reference_bn_moments, scale_bias_act,
                                                    scale_bias_act_cond, scale_bias_act_noise)

Params = Dict[str, torch.Tensor]


def _normal(gen: torch.Generator, shape, stddev: float) -> torch.Tensor:
    return stddev * torch.randn(tuple(shape), generator=gen, dtype=torch.float32)


def _wn_kernel(v: torch.Tensor, g: torch.Tensor, reduce_axes: Tuple[int, ...]) -> torch.Tensor:
    """w = g · v / ‖v‖ per output channel, the norm sqrt(Σv² + 1e-12) taken
    over ``reduce_axes`` (every axis but the output axis). ``torch.square``,
    not ``v * v``: autograd then gives v one gradient term, 2·v·g, as
    ``jnp.square`` does, not two that round apart."""
    norm = torch.sqrt(torch.sum(torch.square(v), dim=reduce_axes, keepdim=True) + 1e-12)
    return v * (g.reshape(norm.shape) / norm)


def _weight(p: Params, reduce_axes: Tuple[int, ...]) -> torch.Tensor:
    return _wn_kernel(p["v"], p["g"], reduce_axes) if "v" in p else p["w"]


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


def dense_init(gen, in_dim, out_dim, *, weight_norm=False, w_std=0.05, use_bias=True) -> Params:
    v = _normal(gen, (in_dim, out_dim), w_std)
    p: Params = {"v": v, "g": torch.ones(out_dim)} if weight_norm else {"w": v}
    if use_bias:
        p["b"] = torch.zeros(out_dim)
    return p


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ _weight(p, (0,)).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Conv2D (NHWC activations, OIHW kernels)
# ---------------------------------------------------------------------------


def conv2d_init(gen, in_ch, out_ch, *, kernel=3, weight_norm=False, w_std=0.05,
                use_bias=True) -> Params:
    v = _normal(gen, (out_ch, in_ch, kernel, kernel), w_std)
    p: Params = {"v": v, "g": torch.ones(out_ch)} if weight_norm else {"w": v}
    if use_bias:
        p["b"] = torch.zeros(out_ch)
    return p


def _tf_pads(size: int, k: int, stride: int, padding: str) -> Tuple[int, int]:
    """(before, after) padding of one spatial axis under TF's rules: SAME
    gives ceil(size/stride) outputs and puts the odd pixel after (so a
    stride-2 3×3 conv of an even size pads (0, 1)); VALID pads nothing."""
    if padding == "VALID":
        return 0, 0
    if padding != "SAME":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv_nhwc(x: torch.Tensor, w_oihw: torch.Tensor, stride: int, padding: str) -> torch.Tensor:
    kh, kw = w_oihw.shape[2:]
    ph, pw = _tf_pads(x.shape[1], kh, stride, padding), _tf_pads(x.shape[2], kw, stride, padding)
    xc = x.permute(0, 3, 1, 2)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv2d(xc, w_oihw, stride=stride, padding=(ph[0], pw[0]))
    else:
        y = F.conv2d(F.pad(xc, (pw[0], pw[1], ph[0], ph[1])), w_oihw, stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def _conv(x: torch.Tensor, w_oihw: torch.Tensor, stride: int, padding: str,
          use_pallas: bool) -> torch.Tensor:
    """The conv itself, in x's dtype: the Hopper 3×3 kernel for a 3×3
    stride-1 conv under ``use_pallas``, else ``F.conv2d``. Either way the
    kernel is cast to x's dtype first, as the JAX layers convolve with
    ``w.astype(x.dtype)``, so a bfloat16 conv's filter gradient reaches the
    float32 weight rounded to bfloat16 as it does there."""
    if use_pallas and stride == 1 and tuple(w_oihw.shape[2:]) == (3, 3):
        return conv3x3(x.contiguous(), w_oihw.permute(2, 3, 1, 0).to(x.dtype), padding)
    return _conv_nhwc(x, w_oihw.to(x.dtype), stride, padding)


def _conv3x3_patches(x: torch.Tensor, w_oihw: torch.Tensor, padding: str) -> torch.Tensor:
    """A 3×3 stride-1 conv as the nine shifted views of x concatenated on
    channels, in (dy, dx, c) order, and one matmul with the (9·Cin, Cout)
    kernel, summed in float32 and cast to x's dtype: JAX's
    ``_conv3x3_patches`` (``TRIPLEGAN_SMALLCIN=patches``)."""
    pad = 1 if padding == "SAME" else 0
    xp = F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x
    n, hp, wp, c = xp.shape
    ho, wo = hp - 2, wp - 2
    patches = torch.cat([xp[:, dy:dy + ho, dx:dx + wo, :] for dy in range(3) for dx in range(3)], dim=-1)
    w2 = w_oihw.permute(2, 3, 1, 0).reshape(9 * c, -1)
    y = patches.reshape(-1, 9 * c).float() @ w2.float()
    return y.reshape(n, ho, wo, -1).to(x.dtype)


def _smallcin_patches(w_oihw: torch.Tensor, stride: int) -> bool:
    """Whether JAX's ``conv2d_apply`` takes the patches form for this conv:
    ``TRIPLEGAN_SMALLCIN=patches`` (read at each call, as JAX reads it)
    and a 3×3 stride-1 kernel with 9·Cin ≤ 128."""
    return (os.environ.get("TRIPLEGAN_SMALLCIN", "conv") == "patches"
            and tuple(w_oihw.shape[2:]) == (3, 3) and stride == 1 and 9 * w_oihw.shape[1] <= 128)


def conv2d_apply(p: Params, x: torch.Tensor, *, stride: int = 1, padding: str = "SAME",
                 use_pallas: bool = False) -> torch.Tensor:
    """Conv with TF padding names and strides; a weight-norm layer (``v``,
    ``g``) convolves with g·v/‖v‖, the norm over (I, H, W). Under
    ``TRIPLEGAN_SMALLCIN=patches`` a 3×3 stride-1 conv with 9·Cin ≤ 128 is
    the patches matmul instead, in either arm, as in JAX."""
    w = _weight(p, (1, 2, 3))
    if _smallcin_patches(w, stride):
        y = _conv3x3_patches(x, w.to(x.dtype), padding)
    else:
        y = _conv(x, w, stride, padding, use_pallas)
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


@functools.lru_cache(maxsize=None)
def _phase_index(k: int, s: int, device: torch.device) -> torch.Tensor:
    """(kk, kk, s, s) index of the tap of a k×k kernel (row-major, k·k for
    none) at each position of the phase kernel, on ``device``: made once a
    device, so that a step copies nothing from the host (a CUDA graph could
    not capture the copy). Built outside inference mode even when first
    asked for inside it (serving), so that a later train step can save it
    for backward."""
    phases, d_min, d_max = _subpixel_plan(k, s)
    kk = d_max - d_min + 1
    with torch.inference_mode(False):
        idx = torch.full((kk, kk, s, s), k * k, dtype=torch.long)
        for a in range(s):
            for b in range(s):
                for pu, du in phases[a]:
                    for pv, dv in phases[b]:
                        idx[du - d_min, dv - d_min, a, b] = pu * k + pv
        return idx.to(device)


def phase_kernel(w: torch.Tensor, stride: int) -> torch.Tensor:
    """The dense HWIO (kk, kk, Cin, s²·Cout) conv kernel equivalent to the
    transposed-conv kernel ``w`` (k, k, Cin, Cout): output channel
    ``(a·s + b)·Cout + cout`` holds phase (a, b). One gather, in w's dtype
    and differentiable in w."""
    k, _, cin, cout = w.shape
    s = stride
    idx = _phase_index(k, s, w.device)
    taps = torch.cat([w.reshape(k * k, cin, cout), w.new_zeros((1, cin, cout))])
    kk = idx.shape[0]
    wp = taps[idx]  # (kk, kk, s, s, cin, cout)
    return wp.permute(0, 1, 4, 2, 3, 5).reshape(kk, kk, cin, s * s * cout)


def _deconv2d_subpixel(x: torch.Tensor, wp: torch.Tensor, k: int, stride: int,
                       use_pallas: bool = False) -> torch.Tensor:
    """``conv_transpose`` SAME of NHWC x as one dense conv with the HWIO
    phase kernel ``wp`` (from :func:`phase_kernel`), then depth-to-space.
    The phase conv of the networks' k = 5, stride-2 deconvs is 3×3 with
    halo 1, which ``use_pallas`` runs on the Hopper conv kernel."""
    s = stride
    n, h, wd, _ = x.shape
    _, d_min, d_max = _subpixel_plan(k, s)
    cout = wp.shape[-1] // (s * s)
    if use_pallas and -d_min == d_max == 1:
        y = conv3x3(x.contiguous(), wp.to(x.dtype), "SAME")
    else:
        xc = x.permute(0, 3, 1, 2)
        w_oihw = wp.permute(3, 2, 0, 1).to(x.dtype)
        if -d_min == d_max:
            y = F.conv2d(xc, w_oihw, padding=d_max)
        else:
            y = F.conv2d(F.pad(xc, (-d_min, d_max, -d_min, d_max)), w_oihw)
        y = y.permute(0, 2, 3, 1)  # (n, h, w, s·s·cout), phases outermost
    y = y.reshape(n, h, wd, s, s, cout).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h * s, wd * s, cout)


def _deconv_transpose(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """JAX's ``lax.conv_transpose(x, w, (s, s), "SAME",
    transpose_kernel=False)`` of NHWC x with the (k, k, Cin, Cout) kernel w
    (in x's dtype): ``F.conv_transpose2d`` with the kernel flipped, whose
    full output is cropped (or zero-padded at the far edge) to in·stride,
    starting k − 1 − pad_a in, pad_a being JAX's leading SAME pad."""
    k, s = w.shape[0], stride
    pad_a = k - 1 if s > k - 1 else int(math.ceil((k + s - 2) / 2))
    off = k - 1 - pad_a
    n, h, wd, _ = x.shape
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.flip((0, 1)).permute(2, 3, 0, 1), stride=s)
    short = off + h * s - y.shape[2]
    if short > 0:
        y = F.pad(y, (0, short, 0, short))
    return y[:, :, off:off + h * s, off:off + wd * s].permute(0, 2, 3, 1)


# The deconv lowering the JAX package reads from TRIPLEGAN_DECONV at import:
# "transpose" for lax.conv_transpose, anything else the subpixel conv.
_DECONV_IMPL = os.environ.get("TRIPLEGAN_DECONV", "subpixel")


def _deconv_raw(x: torch.Tensor, w: torch.Tensor, stride: int, use_pallas: bool) -> torch.Tensor:
    """The transposed conv itself, for every deconv path (the weight-norm
    epilogue's too), as JAX's ``_deconv_raw``: under
    ``TRIPLEGAN_DECONV=transpose`` ``_deconv_transpose`` (cuDNN in either
    arm), else the subpixel conv, through the Hopper conv kernel under
    ``use_pallas``."""
    if _DECONV_IMPL == "transpose":
        return _deconv_transpose(x, w.to(x.dtype), stride)
    return _deconv2d_subpixel(x, phase_kernel(w, stride), w.shape[0], stride, use_pallas)


def deconv2d_apply(p: Params, x: torch.Tensor, *, stride: int = 2,
                   use_pallas: bool = False) -> torch.Tensor:
    """TF-semantics ``conv2d_transpose`` with SAME padding: out = in · stride."""
    y = _deconv_raw(x, _weight(p, (0, 1, 2)), stride, use_pallas)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Batch norm and fused epilogues
# ---------------------------------------------------------------------------


def batchnorm_init(num_features: int) -> Tuple[Params, Params]:
    params = {"scale": torch.ones(num_features), "bias": torch.zeros(num_features)}
    state = {"mean": torch.zeros(num_features), "var": torch.ones(num_features)}
    return params, state


def _moments(p: Params, s: Params, x: torch.Tensor, train: bool, momentum: float, mesh=None,
             use_pallas: bool = False):
    """(mean, var, new running stats). In train mode the batch moments E[x]
    and E[x²] in float32 over all axes but the channel axis (with
    ``use_pallas`` from ``bn_moments``, the hand-written kernels for a CUDA
    x; else from ``reference_bn_moments``), the biased
    variance max(E[x²] − E[x]², 0), and the running stats advanced as
    momentum·old + (1 − momentum)·new, outside autograd; in eval mode the
    running stats, unchanged. With a ``mesh`` (``parallel/mesh.py``) E[x]
    and E[x²] are averaged over its ranks before the variance (sync-BN, as
    JAX's ``axis_name`` pmean), in one all-reduce whose backward averages
    their cotangents, so every rank normalizes with the global batch's
    moments."""
    if not train:
        return s["mean"], s["var"], s
    mean, mean_sq = bn_moments(x) if use_pallas else reference_bn_moments(x)
    if mesh is not None:
        mean, mean_sq = mesh.pmean_grad(torch.stack([mean, mean_sq])).unbind()
    var = torch.clamp_min(mean_sq - mean * mean, 0.0)
    with torch.no_grad():
        new_s = {
            "mean": momentum * s["mean"] + (1.0 - momentum) * mean,
            "var": momentum * s["var"] + (1.0 - momentum) * var,
        }
    return mean, var, new_s


def batchnorm_apply(p: Params, s: Params, x: torch.Tensor, *, train: bool,
                    momentum: float = 0.99, eps: float = 1e-3, mesh=None):
    """BN over all axes but the last: (y in x's dtype, new running stats);
    ``mesh`` as in ``_moments``."""
    mean, var, new_s = _moments(p, s, x, train, momentum, mesh)
    inv = torch.rsqrt(var + eps) * p["scale"]
    y = (x.float() - mean) * inv + p["bias"]
    return y.to(x.dtype), new_s


def _scale_bias_act(x, k, b, act, slope, use_pallas):
    """Per-channel affine + activation: the Hopper kernel when ``use_pallas``
    (its plain version for a CPU tensor), else the plain epilogue that the
    JAX package's non-Pallas branch computes, in x's dtype."""
    if use_pallas:
        return scale_bias_act(x.contiguous(), k, b, act or "linear", slope)
    return apply_act(x * k + b, act or "linear", slope).to(x.dtype)


def batchnorm_act_apply(p: Params, s: Params, x: torch.Tensor, *, train: bool = False,
                        act: Optional[str] = None, slope: float = 0.1, momentum: float = 0.99,
                        eps: float = 1e-3, use_pallas: bool = False, mesh=None):
    """Batch norm folded to ``act(x·k + b)`` with k = scale·rsqrt(var + eps),
    b = bias − mean·k, from the batch moments (train; synced over ``mesh``
    as in ``_moments``) or the running stats (eval). Returns (y in x's
    dtype, new running stats)."""
    mean, var, new_s = _moments(p, s, x, train, momentum, mesh, use_pallas)
    k = p["scale"] * torch.rsqrt(var + eps)
    b = p["bias"] - mean * k
    return _scale_bias_act(x, k.to(x.dtype), b.to(x.dtype), act, slope, use_pallas), new_s


def conv2d_wn_act_apply(p: Params, x: torch.Tensor, *, stride: int = 1, padding: str = "SAME",
                        act: Optional[str] = None, slope: float = 0.2,
                        use_pallas: bool = False) -> torch.Tensor:
    """Weight-norm conv with the norm as a fused epilogue:
    conv(x, v·g/‖v‖) = conv(x, v)·(g/‖v‖) per output channel. With
    ``use_pallas`` the raw-v conv runs and k = g/‖v‖ goes into the
    epilogue kernel; without it, the normalized kernel is applied as
    ``conv2d_apply`` does."""
    if "v" not in p or not use_pallas:
        return apply_act(conv2d_apply(p, x, stride=stride, padding=padding), act or "linear", slope)
    v, g = p["v"], p["g"]
    norm = torch.sqrt(torch.sum(torch.square(v), dim=(1, 2, 3)) + 1e-12)
    k = (g / norm).to(x.dtype)
    b = p["b"].to(x.dtype) if "b" in p else torch.zeros_like(k)
    y = _conv(x, v, stride, padding, True).to(x.dtype)
    return _scale_bias_act(y, k, b, act, slope, True)


def deconv2d_wn_act_apply(p: Params, x: torch.Tensor, *, stride: int = 2,
                          act: Optional[str] = None, slope: float = 0.2,
                          use_pallas: bool = False) -> torch.Tensor:
    """Weight-norm transposed conv with the norm as a fused epilogue:
    deconv(x, v·g/‖v‖) = deconv(x, v)·(g/‖v‖) per output channel. With
    ``use_pallas`` the raw-v deconv runs and k = g/‖v‖ goes into the kernel;
    without it, the normalized kernel is applied as ``deconv2d_apply`` does."""
    if "v" not in p or not use_pallas:
        return apply_act(deconv2d_apply(p, x, stride=stride), act or "linear", slope)
    v, g = p["v"], p["g"]
    norm = torch.sqrt(torch.sum(torch.square(v), dim=(0, 1, 2)) + 1e-12)
    k = (g / norm).to(x.dtype)
    b = p["b"].to(x.dtype) if "b" in p else torch.zeros_like(k)
    y = _deconv_raw(x, v, stride, True).to(x.dtype)
    return _scale_bias_act(y, k, b, act, slope, True)


def cond_batchnorm_init(num_classes: int, num_features: int) -> Tuple[Params, Params]:
    """Class-conditional batch norm: per-class ``gamma`` (ones) and
    ``beta`` (zeros) tables of (num_classes, C) in place of the affine, and
    the usual running statistics."""
    params = {"gamma": torch.ones(num_classes, num_features), "beta": torch.zeros(num_classes, num_features)}
    return params, {"mean": torch.zeros(num_features), "var": torch.ones(num_features)}


def cond_batchnorm_act_apply(p: Params, s: Params, x: torch.Tensor, y: torch.Tensor, *, train: bool = False,
                             act: Optional[str] = None, slope: float = 0.1, momentum: float = 0.99,
                             eps: float = 1e-3, use_pallas: bool = False, mesh=None):
    """Class-conditional batch norm and activation, ``act(x·k_n + b_n)``
    with k_n = gamma[y_n]·rsqrt(var + eps) and b_n = beta[y_n] − mean·k_n,
    (N, C) a sample, the moments as in ``batchnorm_act_apply``. With
    ``use_pallas`` one launch of the per-sample epilogue kernel. Returns
    (y in x's dtype, new running stats)."""
    mean, var, new_s = _moments(p, s, x, train, momentum, mesh, use_pallas)
    yl = y.long()
    k = p["gamma"][yl] * torch.rsqrt(var + eps)
    b = p["beta"][yl] - mean * k
    k, b = k.to(x.dtype), b.to(x.dtype)
    if use_pallas:
        return scale_bias_act_cond(x.contiguous(), k, b, act or "linear", slope), new_s
    n, c = k.shape
    shape = (n,) + (1,) * (x.dim() - 2) + (c,)
    return apply_act(x * k.reshape(shape) + b.reshape(shape), act or "linear", slope).to(x.dtype), new_s


def conv2d_act_apply(p: Params, x: torch.Tensor, *, act: Optional[str] = None, slope: float = 0.2,
                     use_pallas: bool = False) -> torch.Tensor:
    """A stride-1 SAME conv with its bias and activation: with
    ``use_pallas`` the conv, then bias and activation as one epilogue
    (k = 1); without it ``conv2d_apply`` and the activation."""
    if not use_pallas:
        return apply_act(conv2d_apply(p, x), act or "linear", slope)
    b = p["b"].to(x.dtype)
    return _scale_bias_act(_conv(x, p["w"], 1, "SAME", True).to(x.dtype), torch.ones_like(b), b, act, slope, True)


# ---------------------------------------------------------------------------
# Spectral normalisation (Miyato et al., arXiv:1802.05957)
# ---------------------------------------------------------------------------


def sn_matrix(w: torch.Tensor, dense: bool = False) -> torch.Tensor:
    """The matrix W whose largest singular value normalises a weight: a
    conv kernel (O, I, kh, kw) as (O, I·kh·kw); a dense kernel (in, out) as
    (out, in); an embedding (classes, C) as it is."""
    if dense:
        return w.t()
    return w.reshape(w.shape[0], -1)


def _l2normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.sqrt(torch.sum(v * v)) + 1e-12)


def power_iteration(w_mat: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One power iteration from the kept u, outside autograd: (u', v) with
    v = normalise(Wᵀu) and u' = normalise(W·v)."""
    with torch.no_grad():
        w = w_mat.detach()
        v = _l2normalize(w.t() @ u)
        return _l2normalize(w @ v), v


def sn_sigma(w_mat: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """σ = u'ᵀ·W·v, differentiable in W (u' and v are constants)."""
    return torch.dot(u, w_mat @ v)


def sn_init(gen: torch.Generator, rows: int) -> Params:
    """A spectrally normalised layer's statistics: the power iteration's
    vector ``u`` (rows,), drawn normal."""
    return {"u": torch.randn(rows, generator=gen)}


def sn_conv_act_apply(p: Params, sigma: torch.Tensor, x: torch.Tensor, *, act: Optional[str] = None,
                      slope: float = 0.2, use_pallas: bool = False) -> torch.Tensor:
    """A spectrally normalised stride-1 SAME conv with its bias and
    activation: conv(x, W/σ) + b. With ``use_pallas`` the raw-W conv runs
    and 1/σ goes into the epilogue kernel as k, as the weight-norm convs'
    g/‖v‖ does; without it, W/σ is convolved."""
    w, b = p["w"], p["b"]
    if not use_pallas:
        return apply_act(_conv(x, (w / sigma).to(x.dtype), 1, "SAME", False) + b.to(x.dtype),
                         act or "linear", slope).to(x.dtype)
    k = torch.reciprocal(sigma).to(x.dtype).expand(w.shape[0])
    return _scale_bias_act(_conv(x, w, 1, "SAME", True).to(x.dtype), k, b.to(x.dtype), act, slope, True)


# ---------------------------------------------------------------------------
# StyleGAN2 (Karras et al., arXiv:1912.04958; StyleGAN2-ADA's layers,
# arXiv:2006.06676, NVlabs/stylegan2-ada-pytorch training/networks.py)
# ---------------------------------------------------------------------------

SQRT2 = math.sqrt(2.0)
LRELU_SLOPE = 0.2
_FIR_TAPS = (1.0, 3.0, 3.0, 1.0)


def eq_dense_init(gen, in_dim, out_dim, *, lr_mult=1.0, bias_init=0.0) -> Params:
    """An equalised-learning-rate dense layer, as StyleGAN2-ADA's
    ``FullyConnectedLayer``: ``w`` (in, out) drawn N(0, 1/lr_mult²), ``b``
    filled with ``bias_init``; both scaled by lr_mult at use."""
    return {"w": _normal(gen, (in_dim, out_dim), 1.0 / lr_mult), "b": torch.full((out_dim,), float(bias_init))}


def eq_dense_apply(p: Params, x: torch.Tensor, *, lr_mult: float = 1.0, act: bool = False) -> torch.Tensor:
    """x·(w·lr_mult/√in) + b·lr_mult, then (``act``) leaky ReLU(0.2) times
    √2."""
    w = p["w"] * (lr_mult / math.sqrt(p["w"].shape[0]))
    y = x @ w.to(x.dtype) + (p["b"] * lr_mult).to(x.dtype)
    return F.leaky_relu(y, LRELU_SLOPE) * SQRT2 if act else y


def normalize_2nd_moment(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)


def _fir1d(x: torch.Tensor, axis: int, gain: float) -> torch.Tensor:
    """The taps [1, 3, 3, 1]/8 times ``gain`` along ``axis`` (VALID: 3
    fewer), as sums of shifted slices: the filter is symmetric, so its
    convolution is its correlation, and the slices' autograd (adds and
    scalar products) is twice differentiable at elementwise cost, where a
    depthwise conv's double backward runs a conv a channel."""
    n = x.shape[axis] - 3
    s = [x.narrow(axis, a, n) for a in range(4)]
    return (s[0] + s[3]) * (gain * _FIR_TAPS[0] / 8) + (s[1] + s[2]) * (gain * _FIR_TAPS[1] / 8)


def upfirdn(x: torch.Tensor, *, up: int = 1, pad: int = 0, pad_after: Optional[int] = None,
            gain: float = 1.0) -> torch.Tensor:
    """upfirdn2d of NHWC x with the FIR filter [1, 3, 3, 1] ⊗ [1, 3, 3, 1] /
    64: zeros inserted after each pixel (``up`` 2), ``pad`` pixels of zeros
    before and ``pad_after`` (default ``pad``) after on H and W, the filter
    times ``gain`` (√gain a pass, H then W, ``_fir1d``). Returns contiguous
    NHWC."""
    n, h, w, c = x.shape
    if up > 1:
        x = F.pad(x.reshape(n, h, 1, w, 1, c), (0, 0, 0, up - 1, 0, 0, 0, up - 1)).reshape(n, h * up, w * up, c)
    after = pad if pad_after is None else pad_after
    x = F.pad(x, (0, 0, pad, after, pad, after))
    g1 = math.sqrt(gain)
    return _fir1d(_fir1d(x, 1, g1), 2, g1).contiguous()


def _tconv_arm(x: torch.Tensor, use_pallas: bool) -> bool:
    """Whether a stride-2 conv's transposed direction runs on the
    hand-written kernel (``ops/conv3x3.py`` ``tconv3x3_s2``): in the kernel
    arm at float32; bfloat16 stays on cuDNN."""
    return use_pallas and x.dtype == torch.float32


def down_conv(x: torch.Tensor, w_oihw: torch.Tensor, use_pallas: bool = False) -> torch.Tensor:
    """StyleGAN2-ADA's ``conv2d_resample`` with down = 2 and a 3×3 kernel:
    the FIR filter with 2 pixels of zeros each side, then a VALID stride-2
    conv (``F.conv2d``); (N, H, W, Cin) → (N, H/2, W/2, Cout). In the
    kernel arm (``_tconv_arm``) the conv's input gradient is the
    transposed conv's kernel (``conv3x3_s2``)."""
    xb = upfirdn(x, pad=2)
    if _tconv_arm(xb, use_pallas):
        return conv3x3_s2(xb, w_oihw.to(x.dtype))
    return F.conv2d(xb.permute(0, 3, 1, 2), w_oihw.to(x.dtype), stride=2).permute(0, 2, 3, 1).contiguous()


def up_conv(x: torch.Tensor, w_oihw: torch.Tensor, use_pallas: bool = False) -> torch.Tensor:
    """StyleGAN2-ADA's ``conv2d_resample`` with up = 2 and a 3×3 kernel:
    the stride-2 transposed conv by the (O, I) kernel taken as (I, O),
    unflipped (``F.conv_transpose2d``: (N, H, W) → 2H + 1, 2W + 1; in the
    kernel arm, ``_tconv_arm``, the hand-written kernel,
    ``conv_transpose3x3_s2``), then the FIR filter at gain 4 with a pixel
    of zeros each side → 2H, 2W."""
    if _tconv_arm(x, use_pallas):
        y = conv_transpose3x3_s2(x.contiguous(), w_oihw.permute(2, 3, 1, 0).to(x.dtype).contiguous())
        return upfirdn(y, pad=1, gain=4.0)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w_oihw.transpose(0, 1).to(x.dtype), stride=2)
    return upfirdn(y.permute(0, 2, 3, 1), pad=1, gain=4.0)


def upsample_image(img: torch.Tensor) -> torch.Tensor:
    """``upfirdn2d.upsample2d``: zeros inserted, paddings (2, 1), the filter
    at gain 4."""
    return upfirdn(img, up=2, pad=2, pad_after=1, gain=4.0)


def modulated_init(gen, cin: int, cout: int, w_dim: int, *, kernel: int = 3, noise_init: float = 0.0) -> Params:
    """A modulated layer: kernel ``w`` (Cout, Cin, k, k) drawn N(0, 1), bias
    ``b`` 0, its affine ``aw`` (w_dim, Cin) N(0, 1) and ``ab`` 1 (the style
    starts at 1), and with ``noise_init`` not None the noise strength
    ``r``."""
    p: Params = {"w": _normal(gen, (cout, cin, kernel, kernel), 1.0), "b": torch.zeros(cout),
                 "aw": _normal(gen, (w_dim, cin), 1.0), "ab": torch.ones(cin)}
    if noise_init is not None:
        p["r"] = torch.tensor(float(noise_init))
    return p


def _styles(p: Params, w_lat: torch.Tensor) -> torch.Tensor:
    return eq_dense_apply({"w": p["aw"], "b": p["ab"]}, w_lat)


def _scale_input(x: torch.Tensor, s: torch.Tensor, use_pallas: bool) -> torch.Tensor:
    """x ⊙ s_n over channels: one launch of the per-sample epilogue (act
    linear, no bias) in the kernel arm."""
    if use_pallas:
        return scale_bias_act_cond(x.contiguous(), s.to(x.dtype), torch.zeros_like(s, dtype=x.dtype), "linear")
    return x * s.to(x.dtype)[:, None, None, :]


def modulated_conv_apply(p: Params, x: torch.Tensor, w_lat: torch.Tensor, *, up: bool = False,
                         noise: Optional[torch.Tensor] = None, clamp: float = 256.0,
                         use_pallas: bool = False) -> torch.Tensor:
    """StyleGAN2's modulated and demodulated 3×3 layer, trained as
    StyleGAN2-ADA trains it: s = A(w) (bias 1), d_j = (Σ_{i,u,v} (W_jiuv·
    s_i)² + 1e-8)^−½, y = conv(x ⊙ s, W) (``up``: the up-conv), then
    clamp(lrelu(y·d + r·ν + b)·√2, ±clamp). ``noise`` ν (N, H, W) at the
    output's size, or None (no noise term). With ``use_pallas`` the 3×3
    conv runs on the Hopper conv kernels and the rest on the epilogue
    kernels."""
    w = p["w"]
    s = _styles(p, w_lat)
    d = torch.rsqrt(torch.square(s) @ torch.sum(torch.square(w), dim=(2, 3)).t() + 1e-8)
    xs = _scale_input(x, s, use_pallas)
    y = up_conv(xs, w, use_pallas) if up else _conv(xs, w, 1, "SAME", use_pallas)
    n, h, wd, c = y.shape
    q = (torch.zeros((n, h, wd), dtype=y.dtype, device=y.device) if noise is None
         else noise.to(y.dtype) * p["r"].to(y.dtype))
    if use_pallas:
        return scale_bias_act_noise(y.contiguous(), (d * SQRT2).to(y.dtype), (p["b"] * SQRT2).to(y.dtype),
                                    q * SQRT2, "leaky_relu", LRELU_SLOPE, clamp)
    z = y * d.to(y.dtype)[:, None, None, :] + q[..., None] + p["b"].to(y.dtype)
    return torch.clamp(F.leaky_relu(z, LRELU_SLOPE) * SQRT2, -clamp, clamp)


def torgb_apply(p: Params, x: torch.Tensor, w_lat: torch.Tensor, *, clamp: float = 256.0,
                use_pallas: bool = False) -> torch.Tensor:
    """ToRGB: a 1×1 modulated conv without demodulation, the style scaled
    by 1/√Cin, plus the bias, clamped to ±clamp."""
    s = _styles(p, w_lat) * (1.0 / math.sqrt(p["w"].shape[1]))
    y = _conv_nhwc(_scale_input(x, s, use_pallas), p["w"].to(x.dtype), 1, "SAME")
    return torch.clamp(y + p["b"].to(y.dtype), -clamp, clamp)


def eq_conv_act_apply(p: Params, x: torch.Tensor, *, down: bool = False, clamp: float = 256.0,
                      use_pallas: bool = False) -> torch.Tensor:
    """StyleGAN2-ADA's ``Conv2dLayer`` with leaky ReLU: the conv by w times
    its gain 1/√(Cin·k²) (``down``: the filtered stride-2 conv), plus b,
    leaky ReLU(0.2) times √2, clamped to ±clamp. With ``use_pallas`` the
    conv runs on the raw w (a 3×3 stride-1 one on the Hopper conv kernels)
    and √2·gain and √2·b go into the per-channel epilogue kernel as k and
    b; the clamp follows it."""
    w = p["w"]
    gain = 1.0 / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
    if not use_pallas:
        w = w * gain
    y = down_conv(x, w, use_pallas) if down else _conv(x, w, 1, "SAME", use_pallas)
    if use_pallas:
        c = y.shape[-1]
        k = torch.full((c,), SQRT2 * gain, dtype=y.dtype, device=y.device)
        y = scale_bias_act(y.contiguous(), k, (p["b"] * SQRT2).to(y.dtype), "leaky_relu", LRELU_SLOPE)
    else:
        y = F.leaky_relu(y + p["b"].to(y.dtype), LRELU_SLOPE) * SQRT2
    return torch.clamp(y, -clamp, clamp)


def minibatch_stddev(x: torch.Tensor, group: int, channels: int = 1, streams: int = 1) -> torch.Tensor:
    """StyleGAN2's minibatch standard deviation of NHWC x, one more
    ``channels`` planes: each of the ``streams`` equal runs of rows is cut
    as StyleGAN2-ADA cuts a batch, into groups of G = min(group, rows) whose
    members stand rows/G apart (row i in group i mod rows/G); a group's
    stddev over its members, +1e-8 under the root, is averaged over the
    channels of each of ``channels`` slices and the pixels, and given to
    each member as its planes."""
    n, h, w, c = x.shape
    if n % streams:
        raise ValueError(f"{n} rows do not cut into {streams} equal streams")
    outs = []
    for xs in x.split(n // streams):
        m = xs.shape[0]
        g = min(group, m)
        if m % g:
            raise ValueError(f"a stream of {m} rows does not cut into groups of {g}")
        y = xs.reshape(g, -1, h, w, channels, c // channels)
        y = torch.sqrt(torch.mean(torch.square(y - y.mean(dim=0)), dim=0) + 1e-8)
        y = y.mean(dim=(1, 2, 4))  # (m / g, channels)
        outs.append(y.repeat(g, 1)[:, None, None, :].expand(m, h, w, channels))
    return torch.cat([x, torch.cat(outs).to(x.dtype)], dim=-1)


# ---------------------------------------------------------------------------
# Resampling and pooling of the ResNet blocks
# ---------------------------------------------------------------------------


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsampling of NHWC x."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


def avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    """2×2 average pooling of NHWC x (even sizes)."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def global_sum_pool(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=(1, 2))


# ---------------------------------------------------------------------------
# Stochastic layers
# ---------------------------------------------------------------------------


def gaussian_noise(gen: Optional[torch.Generator], x: torch.Tensor, sigma: float, *,
                   train: bool) -> torch.Tensor:
    if not train or sigma <= 0.0 or gen is None:
        return x
    return x + sigma * torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)


def dropout(gen: Optional[torch.Generator], x: torch.Tensor, rate: float, *,
            train: bool) -> torch.Tensor:
    """``x · mask · (1/keep)`` with a Bernoulli(keep) mask, keep = 1 − rate
    (JAX's 32-bit branch). Under ``TRIPLEGAN_DROPOUT_BITS=8`` (read at each
    call, as JAX reads it) the mask comes from uint8 bits instead: kept
    where bits < thresh = max(round(keep·256), 1), scaled by 256/thresh,
    and x is returned as it is where thresh reaches 256."""
    if not train or rate <= 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    if os.environ.get("TRIPLEGAN_DROPOUT_BITS", "32") == "8":
        thresh = max(int(round(keep * 256.0)), 1)
        if thresh >= 256:
            return x
        bits = torch.randint(0, 256, x.shape, generator=gen, device=x.device, dtype=torch.uint8)
        return x * ((bits < thresh).to(x.dtype) * (256.0 / thresh))
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return x * (mask.to(x.dtype) * (1.0 / keep))


# ---------------------------------------------------------------------------
# Activations, pooling and labels
# ---------------------------------------------------------------------------


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


# The max-pool lowering the JAX package reads from TRIPLEGAN_MAXPOOL at
# import: "window" (reduce_window; any other value too), "reshape" or
# "maskbwd".
_MAXPOOL_IMPL = os.environ.get("TRIPLEGAN_MAXPOOL", "window")


def _max_pool_window(x: torch.Tensor, window: int) -> torch.Tensor:
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, window, ceil_mode=True)
    return y.permute(0, 2, 3, 1).contiguous()


def _pool_repeat(a: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """A pooled map broadcast back to the input positions (each belongs to
    one window), cut to (h, w)."""
    return a.repeat_interleave(window, 1)[:, :h].repeat_interleave(window, 2)[:, :, :w]


class _MaxPoolMaskBwd(torch.autograd.Function):
    """JAX's ``_max_pool_maskbwd``: the window max forward, and a backward
    that splits each window's gradient evenly over the elements equal to
    its max (``_mp_bwd``), in the gradient's dtype."""

    @staticmethod
    def forward(ctx, x, window):
        y = _max_pool_window(x, window)
        ctx.window = window
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        win = ctx.window
        n, h, w, c = x.shape
        ho, wo = y.shape[1:3]
        mask = (x == _pool_repeat(y, win, h, w)).to(g.dtype)
        padded = F.pad(mask, (0, 0, 0, wo * win - w, 0, ho * win - h))
        cnt = padded.reshape(n, ho, win, wo, win, c).sum(dim=(2, 4))
        return mask * _pool_repeat(g / cnt, win, h, w), None


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Non-overlapping (stride = window) max pool with TF SAME padding,
    NHWC. SAME then pads only the far edge of an odd size, which
    ``ceil_mode`` reproduces. The gradient goes to one element of each
    window, as through JAX's ``reduce_window``; under
    ``TRIPLEGAN_MAXPOOL=reshape`` (sizes divisible by the window) it is an
    ``amax`` over the window axes, whose gradient splits ties evenly as
    JAX's reduce-max does, and under ``maskbwd`` ``_MaxPoolMaskBwd``."""
    n, h, w, c = x.shape
    if _MAXPOOL_IMPL == "reshape" and h % window == 0 and w % window == 0:
        return x.reshape(n, h // window, window, w // window, window, c).amax(dim=(2, 4))
    if _MAXPOOL_IMPL == "maskbwd" and x.dtype.is_floating_point:
        return _MaxPoolMaskBwd.apply(x, window)
    return _max_pool_window(x, window)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=(1, 2))


def onehot(labels: torch.Tensor, num_classes: int, dtype=torch.float32) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).to(dtype)


def label_concat_spatial(x: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """Broadcast one-hot labels to spatial planes and concat on channels."""
    n, h, w, _ = x.shape
    planes = y_onehot[:, None, None, :].to(x.dtype).expand(n, h, w, y_onehot.shape[-1])
    return torch.cat([x, planes], dim=-1)
