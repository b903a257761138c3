"""A plain PyTorch reference of the StyleGAN2 pair under Triple-GAN's
three-player step, for the CPU tests (``tests/test_torch_stylegan2.py``):
StyleGAN2's G and D (Karras et al., arXiv:1912.04958) as StyleGAN2-ADA
computes them (arXiv:2006.06676; NVlabs/stylegan2-ada-pytorch
training/networks.py and training/loss.py), the lazy R1 penalty, G's EMA
copy and w_avg, with ``plain_snresnet.py``'s classifier, losses and Adam.

Written from the papers with ``F.conv2d``, ``F.conv_transpose2d``, a
depthwise FIR filter with upfirdn2d's paddings and plain tensor
arithmetic, NCHW inside the networks, in float32 with TF32 off (float64
where the tests hand it float64); it imports nothing of the package under
test. The step takes its batches as given, with no augmentation, dropout
or input noise and the argmax pseudo-labels; it draws only G's noise
planes, (N, H, W) a modulated conv in layer order, from the generator the
test hands it for each step.

Layouts, as the tests hand them over: images NHWC; conv kernels OIHW;
dense kernels (in, out); the learned constant (4, 4, C); D's flattened
4×4 map in (H, W, C) order.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from plain_snresnet import _grads, _live, _logp, _softplus, adam, classifier, float32, images

Tree = Dict[str, Dict[str, torch.Tensor]]
SQRT2 = math.sqrt(2.0)


def upfirdn2d(x, up=1, pad=(0, 0, 0, 0), gain=1.0):
    """upfirdn2d of NCHW x with [1, 3, 3, 1] ⊗ [1, 3, 3, 1] / 64: zeros
    inserted, padded (x0, x1, y0, y1), convolved with the filter at gain."""
    n, c, h, w = x.shape
    if up > 1:
        x = F.pad(x.reshape(n, c, h, 1, w, 1), [0, up - 1, 0, 0, 0, up - 1]).reshape(n, c, h * up, w * up)
    x = F.pad(x, list(pad))
    f1 = torch.tensor([1.0, 3.0, 3.0, 1.0], dtype=x.dtype)
    f = (torch.outer(f1, f1) / 64.0 * gain).flip([0, 1])
    return F.conv2d(x, f[None, None].repeat(c, 1, 1, 1), groups=c)


def fc(p, x, lr_mult=1.0, act=False):
    y = x @ (p["w"] * (lr_mult / math.sqrt(p["w"].shape[0]))) + p["b"] * lr_mult
    return F.leaky_relu(y, 0.2) * SQRT2 if act else y


def bias_act(x, b, clamp, act=True):
    x = x + b.reshape(1, -1, 1, 1)
    if act:
        x = F.leaky_relu(x, 0.2) * SQRT2
    return x.clamp(-clamp, clamp)


def norm2(x):
    return x * (x.square().mean(dim=1, keepdim=True) + 1e-8).rsqrt()


def modulated_conv2d(x, weight, styles, noise=None, up=False, demodulate=True):
    """StyleGAN2-ADA's modulated_conv2d, its non-fused path."""
    n = x.shape[0]
    if demodulate:
        w = weight[None] * styles.reshape(n, 1, -1, 1, 1)
        dcoefs = (w.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt()
    x = x * styles.reshape(n, -1, 1, 1)
    if up:
        x = upfirdn2d(F.conv_transpose2d(x, weight.transpose(0, 1), stride=2), pad=(1, 1, 1, 1), gain=4.0)
    else:
        x = F.conv2d(x, weight, padding=weight.shape[-1] // 2)
    if demodulate:
        x = x * dcoefs.reshape(n, -1, 1, 1)
    return x if noise is None else x + noise


def mbstd(x, group, channels=1):
    n, c, h, w = x.shape
    g = min(group, n)
    y = x.reshape(g, -1, channels, c // channels, h, w)
    y = (y - y.mean(dim=0)).square().mean(dim=0)
    y = (y + 1e-8).sqrt().mean(dim=[2, 3, 4])
    return torch.cat([x, y.reshape(-1, channels, 1, 1).repeat(g, 1, h, w)], dim=1)


def generator(P: Tree, z, y, hp: dict, gen=None):
    """(NHWC images, w): the mapping (embed, 2nd-moment normalisation,
    ``hp["map_layers"]`` dense layers at lr multiplier 0.01), then the skip
    synthesis from 4×4 over ``hp["gen_widths"]``; noise planes drawn from
    ``gen`` (none without it)."""
    nc = hp["num_classes"]
    e = fc(P["embed"], F.one_hot(y, nc).to(z.dtype))
    w = torch.cat([norm2(z), norm2(e)], dim=1)
    for i in range(hp["map_layers"]):
        w = fc(P[f"map{i}"], w, 0.01, act=True)
    n = z.shape[0]

    def layer(name, x, res, up=False):
        p = P[name]
        nz = None if gen is None else torch.randn((n, res, res), generator=gen, dtype=z.dtype)[:, None] * p["r"]
        return bias_act(modulated_conv2d(x, p["w"], fc({"w": p["aw"], "b": p["ab"]}, w), nz, up=up), p["b"], 256.0)

    def torgb(name, x):
        p = P[name]
        s = fc({"w": p["aw"], "b": p["ab"]}, w) / math.sqrt(p["w"].shape[1])
        return bias_act(modulated_conv2d(x, p["w"], s, demodulate=False), p["b"], 256.0, act=False)

    x = P["b4_const"]["w"].permute(2, 0, 1)[None].repeat(n, 1, 1, 1)
    img = None
    for i in range(len(hp["gen_widths"])):
        res = 4 * 2 ** i
        if res > 4:
            x = layer(f"b{res}_conv0", x, res, up=True)
        x = layer(f"b{res}_conv1", x, res)
        rgb = torgb(f"b{res}_torgb", x)
        img = rgb if img is None else upfirdn2d(img, up=2, pad=(2, 1, 2, 1), gain=4.0) + rgb
    return img.permute(0, 2, 3, 1), w


def discriminator(P: Tree, x, y, hp: dict, streams: int = 1):
    """D's logits for NHWC x and labels y, the stddev groups (``hp["group"]``)
    within each of ``streams`` equal runs of rows."""
    s = x.shape[1]

    def conv(name, h, down=False):
        p = P[name]
        wt = p["w"] / math.sqrt(p["w"][0].numel())
        h = F.conv2d(upfirdn2d(h, pad=(2, 2, 2, 2)), wt, stride=2) if down else F.conv2d(h, wt, padding=wt.shape[-1] // 2)
        return bias_act(h, p["b"], 256.0)

    h = conv(f"b{s}_fromrgb", x.permute(0, 3, 1, 2))
    res = s
    while res > 4:
        h = conv(f"b{res}_conv1", conv(f"b{res}_conv0", h), down=True)
        res //= 2
    h = torch.cat([mbstd(t, hp["group"]) for t in h.split(h.shape[0] // streams)])
    h = fc(P["b4_fc"], conv("b4_conv", h).permute(0, 2, 3, 1).flatten(1), act=True)
    h = fc(P["b4_out"], h)
    c = norm2(fc(P["cmap_embed"], F.one_hot(y, hp["num_classes"]).to(x.dtype)))
    for i in range(hp["d_map_layers"]):
        c = fc(P[f"cmap{i}"], c, 0.01, act=True)
    return (h * c).sum(dim=1) / math.sqrt(c.shape[1])


def r1_grads(P: Tree, x, y, hp: dict, weight: float) -> Tuple[Tree, torch.Tensor]:
    """(the gradient of weight·mean ‖∇ₓD(x, y)‖² in D's parameters, a leaf
    it does not reach taking zeros; the penalty)."""
    x = x.detach().requires_grad_(True)
    pd = _live(P)
    (gx,) = torch.autograd.grad(discriminator(pd, x, y, hp).sum(), x, create_graph=True)
    pen = gx.square().sum(dim=[1, 2, 3]).mean() * weight
    flat = iter(torch.autograd.grad(pen, [t for a in pd.values() for t in a.values()], allow_unused=True,
                                    materialize_grads=True))
    return {l: {k: next(flat) for k in a} for l, a in pd.items()}, pen


def train_steps(P: Dict[str, Tree], S: Dict[str, Tree], batches, hp: dict, gens, regs) -> Tuple[dict, list]:
    """The three-player step over ``batches`` (each {"d", "c": x_l, y_l,
    x_u, z, y_g; "g": z, y_g}), step t drawing G's noise from ``gens[t]``
    and opening with D's R1 update where ``regs[t]``; the learning rates
    constant, α_P on: ({"params", "stats", "counts"} after them, [(metrics,
    D's pseudo-labels) a step]). ``hp``: "alpha", "alpha_p", "gen_widths",
    "map_layers", "d_map_layers", "group", "num_classes", "clf_blocks",
    "clf_tail", "lr", "b1", "b2", "eps", "r1_weight" (γ/2 times the
    interval), "ema_betas" (a step's β), "w_avg_beta"."""
    with float32():
        return _train_steps(P, S, batches, hp, gens, regs)


def _train_steps(P, S, batches, hp, gens, regs):
    alpha, a_p = hp["alpha"], hp["alpha_p"]
    cb, ct = hp["clf_blocks"], hp["clf_tail"]
    opt = {p: {"count": 0, "mu": {l: {k: torch.zeros_like(t) for k, t in a.items()} for l, a in P[p].items()},
               "nu": {l: {k: torch.zeros_like(t) for k, t in a.items()} for l, a in P[p].items()}} for p in P}
    step_adam = lambda p, g, player: adam(p, g, opt[player], hp["lr"], hp["b1"], hp["b2"], hp["eps"])  # noqa: E731
    P = {p: {l: {k: t.detach() for k, t in a.items()} for l, a in tree.items()} for p, tree in P.items()}
    S = {p: {l: dict(a) for l, a in tree.items()} for p, tree in S.items()}
    last = f"map{hp['map_layers'] - 1}"
    out = []
    for t, batch in enumerate(batches):
        g = gens[t]
        bd, bg, bc = batch["d"], batch["g"], batch["c"]
        b = bd["z"].shape[0]
        x_l = images(bd["x_l"])
        pen = None
        if regs[t]:
            grads, pen = r1_grads(P["disc"], x_l, bd["y_l"].long(), hp, hp["r1_weight"])
            P["disc"], opt["disc"] = step_adam(P["disc"], grads, "disc")
        x_u = images(bd["x_u"])
        with torch.no_grad():
            x_g, _ = generator(P["gen"], bd["z"], bd["y_g"].long(), hp, g)
            y_c = torch.argmax(classifier(P["clf"], S["clf"], x_u, cb, ct)[0], dim=-1)
        pd = _live(P["disc"])
        logits = discriminator(pd, torch.cat([x_l, x_u, x_g]), torch.cat([bd["y_l"].long(), y_c, bd["y_g"].long()]),
                               hp, streams=3)
        lr_, lc_, lg_ = logits[:b], logits[b:2 * b], logits[2 * b:]
        d_real, d_cla, d_gen = (_softplus(-lr_).mean(), alpha * _softplus(lc_).mean(),
                                (1 - alpha) * _softplus(lg_).mean())
        loss_d = d_real + d_cla + d_gen
        P["disc"], opt["disc"] = step_adam(P["disc"], _grads(loss_d, pd), "disc")

        pg = _live(P["gen"])
        x_raw, w = generator(pg, bg["z"], bg["y_g"].long(), hp, g)
        loss_g = (1 - alpha) * _softplus(-discriminator(P["disc"], x_raw, bg["y_g"].long(), hp)).mean()
        P["gen"], opt["gen"] = step_adam(P["gen"], _grads(loss_g, pg), "gen")
        with torch.no_grad():
            S["gen"][last]["w_avg"] = w.mean(dim=0).lerp(S["gen"][last]["w_avg"], hp["w_avg_beta"])
            for l, arrays in P["gen"].items():
                for k, p in arrays.items():
                    S["gen"][l][k + "_ema"] = p.lerp(S["gen"][l][k + "_ema"], hp["ema_betas"][t])

        x_l, x_u = images(bc["x_l"]), images(bc["x_u"])
        with torch.no_grad():
            x_g, _ = generator(P["gen"], bc["z"], bc["y_g"].long(), hp, g)
        pc = _live(P["clf"])
        log_l, s1 = classifier(pc, S["clf"], x_l, cb, ct)
        log_u, s2 = classifier(pc, s1, x_u, cb, ct)
        log_g, s3 = classifier(pc, s2, x_g, cb, ct)
        y_c2 = torch.argmax(log_u.detach(), dim=-1)
        with torch.no_grad():
            wd = -_softplus(discriminator(P["disc"], x_u, y_c2, hp))
        c_sup = -_logp(log_l, bc["y_l"].long()).mean()
        c_adv = alpha * torch.mean((wd - wd.mean()) * _logp(log_u, y_c2))
        c_pseudo = a_p * -_logp(log_g, bc["y_g"].long()).mean()
        loss_c = c_sup + c_adv + c_pseudo
        P["clf"], opt["clf"] = step_adam(P["clf"], _grads(loss_c, pc), "clf")
        S["clf"] = s3
        metrics = {"loss_d": loss_d, "loss_g": loss_g, "loss_c": loss_c, "d_real": d_real, "d_cla": d_cla,
                   "d_gen": d_gen, "c_sup": c_sup, "c_adv": c_adv, "c_pseudo": c_pseudo}
        out.append(({k: float(v.detach()) for k, v in metrics.items()}, y_c, None if pen is None else float(pen.detach())))
    return {"params": P, "stats": S, "counts": {p: o["count"] for p, o in opt.items()}}, out
