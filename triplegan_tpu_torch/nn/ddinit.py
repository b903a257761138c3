"""Data-dependent weight-norm initialization (Salimans & Kingma 2016): the
port of ``triplegan_tpu/nn/ddinit.py``.

With w = g·v/‖v‖, one batch runs through each weight-normed layer with
g = 1, b = 0 (the direction-only kernel v/‖v‖), and per output channel

    g ← init_scale / (std(t) + ε),    b ← −mean(t) · g,

t being the layer's pre-activation, so that every weight-norm layer starts
with zero-mean pre-activations of standard deviation init_scale. The
adjustment is sequential (fixing layer k changes layer k+1's input), so
each function runs the forward once, normalizing as it goes, and returns
new parameters. std is the population std (``jnp.std``), and ε = 1e-8
sits both inside the square root of ‖v‖² and beside the std, as in JAX.
Stochastic layers are off; batch-norm layers are left alone.

The convs go through the port's own layers, so that with ``use_pallas``
(the network's own setting) the hand-written kernels run here too: the
Discriminator's stride-1 3×3 convs through ``layers._conv`` (its
stride-2 convs on cuDNN, as in the networks), and the Generator's deconvs,
the output deconv's direction-only pre-activation included, through
``layers._deconv_raw`` (the subpixel conv, or ``conv_transpose`` under
``TRIPLEGAN_DECONV=transpose``). JAX's ``wn_deconv_ddinit`` calls
``lax.conv_transpose`` directly: the same sums in another order.

Layouts are the port's: a conv's v is OIHW (the norm over I, H, W), a
deconv's (k, k, in, out) (the norm over the first three axes), a dense
layer's (in, out).
"""

from __future__ import annotations

from typing import Tuple

import torch

from triplegan_tpu_torch.nn import layers as L

_EPS = 1e-8


def _stats(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    axes = tuple(range(t.dim() - 1))
    return torch.mean(t, dim=axes), torch.std(t, dim=axes, correction=0)


def _adjust(p, t, init_scale):
    """(new params, normalized output) from the direction-only
    pre-activation t (g = 1, b = 0)."""
    m, s = _stats(t)
    g = init_scale / (s + _EPS)
    b = -m * g
    y = (t - m) / (s + _EPS) * init_scale
    new_p = dict(p)
    new_p["g"] = g.to(p["g"].dtype)
    if "b" in p:
        new_p["b"] = b.to(p["b"].dtype)
    return new_p, y


def _direction(v: torch.Tensor, axes) -> torch.Tensor:
    return v / torch.sqrt(torch.sum(torch.square(v), dim=axes, keepdim=True) + _EPS)


def wn_dense_ddinit(p, x, init_scale=1.0):
    t = x @ _direction(p["v"], (0,)).to(x.dtype)
    return _adjust(p, t, init_scale)


def wn_conv_ddinit(p, x, *, stride=1, padding="SAME", init_scale=1.0, use_pallas=False):
    t = L._conv(x, _direction(p["v"], (1, 2, 3)), stride, padding, use_pallas)
    return _adjust(p, t, init_scale)


def wn_deconv_ddinit(p, x, *, stride=2, init_scale=1.0, use_pallas=False):
    t = L._deconv_raw(x, _direction(p["v"], (0, 1, 2)), stride, use_pallas)
    return _adjust(p, t, init_scale)


@torch.no_grad()
def ddinit_discriminator(disc, params, x, y, init_scale=1.0):
    """Data-dependent init of every weight-norm conv and the weight-norm
    head of D, on one real (x, y) batch. Returns new params."""
    new_params = dict(params)
    y1h = L.onehot(y, disc.num_classes, dtype=x.dtype)
    h = L.label_concat_spatial(x, y1h)
    for i, s in enumerate(disc.strides):
        name = f"conv{i}"
        new_params[name], h = wn_conv_ddinit(params[name], h, stride=s, init_scale=init_scale,
                                             use_pallas=disc.use_pallas)
        h = L.leaky_relu(h, disc.lrelu_slope)
        if s == 2 and disc.label_reconcat and i + 1 < len(disc.widths):
            h = L.label_concat_spatial(h, y1h)
    h = torch.cat([L.global_avg_pool(h), y1h], dim=-1)
    new_params["head"], _ = wn_dense_ddinit(params["head"], h, init_scale)
    return new_params


@torch.no_grad()
def ddinit_generator(gen, params, bn_state, z, y, init_scale=1.0):
    """Data-dependent init of G's weight-norm output deconv: the forward to
    the last hidden layer (batch norm on the batch's moments), then the
    output deconv's pre-tanh activations normalized. Returns new params."""
    s0 = gen.base_size
    y1h = L.onehot(y, gen.num_classes, dtype=z.dtype)
    h = L.dense_apply(params["dense"], torch.cat([z, y1h], dim=-1))
    h = h.reshape(h.shape[0], s0, s0, gen.widths[0])
    h, _ = L.batchnorm_apply(params["bn0"], bn_state["bn0"], h, train=True)
    h = torch.relu(h)
    for i in range(len(gen.widths) - 1):
        h = L.deconv2d_apply(params[f"deconv{i}"], h, stride=2, use_pallas=gen.use_pallas)
        h, _ = L.batchnorm_apply(params[f"bn{i + 1}"], bn_state[f"bn{i + 1}"], h, train=True)
        h = torch.relu(h)
    new_params = dict(params)
    new_params["deconv_out"], _ = wn_deconv_ddinit(params["deconv_out"], h,
                                                   init_scale=init_scale, use_pallas=gen.use_pallas)
    return new_params
