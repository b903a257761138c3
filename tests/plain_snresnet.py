"""A plain PyTorch reference of the SN-ResNet pair under Triple-GAN's
three-player step, for the CPU tests (``tests/test_torch_snresnet.py``):
the ResNet generator with class-conditional batch norm and the spectrally
normalised projection discriminator of Miyato & Koyama (cGANs with
Projection Discriminator, arXiv:1802.05637; pfnet-research/sngan_projection,
gen_models/resnet_32.py, dis_models/snresnet_32.py), the conv-large
classifier, the Triple-GAN losses (arXiv:1703.02291) and Adam.

Written from the papers with ``F.conv2d`` and plain tensor arithmetic, in
float32 with TF32 off; it imports nothing of the package under test. The
step takes its batches as given, with no noise, dropout or augmentation
and the argmax pseudo-labels, so it draws nothing.

Layouts, as the tests hand them over: images and activations NHWC; conv
kernels OIHW; dense kernels (in, out); the class embedding (classes, C).
Spectral normalisation keeps one vector ``u`` a layer; from it one power
iteration gives v = normalise(Wᵀu), u' = normalise(W·v) (constants to the
gradient) and σ = u'ᵀ·W·v (not), W the kernel as (out, in·kh·kw). D's
update keeps u'; G's and C's updates use that and keep nothing.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Tree = Dict[str, Dict[str, torch.Tensor]]
EPS = 1e-3          # batch norm's
MOMENTUM = 0.99     # running statistics: m·old + (1 − m)·batch


@contextlib.contextmanager
def float32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def conv(x, w, b=None):
    """Stride-1 conv of NHWC x, padded to keep its size (k odd)."""
    k = w.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=k // 2).permute(0, 2, 3, 1)
    return y if b is None else y + b


def moments(x):
    return x.mean(dim=(0, 1, 2)), x.var(dim=(0, 1, 2), unbiased=False)


def running(s, mean, var):
    return {"mean": MOMENTUM * s["mean"] + (1 - MOMENTUM) * mean.detach(),
            "var": MOMENTUM * s["var"] + (1 - MOMENTUM) * var.detach()}


def cbn_relu(p, s, x, y, train):
    """Class-conditional batch norm, then ReLU: (out, new stats)."""
    mean, var = moments(x) if train else (s["mean"], s["var"])
    h = (x - mean) / torch.sqrt(var + EPS)
    out = torch.relu(h * p["gamma"][y][:, None, None, :] + p["beta"][y][:, None, None, :])
    return out, (running(s, mean, var) if train else s)


def up(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def pool(x):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def generator(P: Tree, S: Tree, z, y, widths, train=True):
    """Images from codes and integer labels: (images, new stats)."""
    n = z.shape[0]
    s0 = int(round((P["l1"]["w"].shape[1] // widths[0]) ** 0.5))
    h = (z @ P["l1"]["w"] + P["l1"]["b"]).reshape(n, s0, s0, widths[0])
    new = {}
    for i in range(len(widths)):
        blk = f"block{i + 2}"
        t, new[f"{blk}_b1"] = cbn_relu(P[f"{blk}_b1"], S[f"{blk}_b1"], h, y, train)
        t = conv(up(t), P[f"{blk}_c1"]["w"], P[f"{blk}_c1"]["b"])
        t, new[f"{blk}_b2"] = cbn_relu(P[f"{blk}_b2"], S[f"{blk}_b2"], t, y, train)
        t = conv(t, P[f"{blk}_c2"]["w"], P[f"{blk}_c2"]["b"])
        h = t + conv(up(h), P[f"{blk}_c_sc"]["w"], P[f"{blk}_c_sc"]["b"])
    mean, var = moments(h) if train else (S["b5"]["mean"], S["b5"]["var"])
    h = torch.relu((h - mean) / torch.sqrt(var + EPS) * P["b5"]["scale"] + P["b5"]["bias"])
    new["b5"] = running(S["b5"], mean, var) if train else S["b5"]
    return torch.tanh(conv(h, P["c5"]["w"], P["c5"]["b"])), new


def _unit(v):
    return v / (torch.sqrt(torch.sum(v * v)) + 1e-12)


def _matrix(name, w):
    return w.t() if name == "l5" else w.reshape(w.shape[0], -1)


def spectral(P: Tree, U: Tree):
    """Each layer's (u', v), one power iteration from the kept u, and its
    σ = u'ᵀ·W·v (in autograd where W is)."""
    out = {}
    for name, s in U.items():
        w = _matrix(name, P[name]["w"])
        with torch.no_grad():
            v = _unit(w.detach().t() @ s["u"])
            u = _unit(w.detach() @ v)
        out[name] = (u, torch.dot(u, w @ v))
    return out


def discriminator(P: Tree, U: Tree, x, y, strides):
    """The logit that (x, y) is a real pair, and the stats with u'."""
    sn = spectral(P, U)

    def c(name, h):
        return conv(h, P[name]["w"] / sn[name][1], P[name]["b"])

    h, cin = x, x.shape[-1]
    for i, s in enumerate(strides):
        blk = f"block{i + 1}"
        t = c(f"{blk}_c2", torch.relu(c(f"{blk}_c1", h if i == 0 else torch.relu(h))))
        width = P[f"{blk}_c1"]["w"].shape[0]
        if s == 2:
            t = pool(t)
        if i == 0:
            sc = c(f"{blk}_c_sc", pool(h) if s == 2 else h)
        elif cin != width or s == 2:
            sc = c(f"{blk}_c_sc", h)
            sc = pool(sc) if s == 2 else sc
        else:
            sc = h
        h, cin = t + sc, width
    h = torch.relu(h).sum(dim=(1, 2))
    out = h @ (P["l5"]["w"] / sn["l5"][1]) + P["l5"]["b"]
    proj = torch.sum(P["l_y"]["w"][y] / sn["l_y"][1] * h, dim=-1)
    return out[:, 0] + proj, {name: {"u": u} for name, (u, _) in sn.items()}


def classifier(P: Tree, S: Tree, x, blocks, tail):
    """Conv-large in train mode (batch moments), no noise or dropout:
    (logits, new stats)."""
    new = {}

    def cbl(name, h, pad):
        h = F.conv2d(h.permute(0, 3, 1, 2), P[name]["w"], padding=pad).permute(0, 2, 3, 1)
        mean, var = moments(h)
        new[f"{name}_bn"] = running(S[f"{name}_bn"], mean, var)
        bn = P[f"{name}_bn"]
        return F.leaky_relu((h - mean) / torch.sqrt(var + EPS) * bn["scale"] + bn["bias"], 0.1)

    h = x
    for bi, widths in enumerate(blocks):
        for ci in range(len(widths)):
            h = cbl(f"b{bi}c{ci}", h, 1)
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2, ceil_mode=True).permute(0, 2, 3, 1)
    for ti in range(len(tail)):
        h = cbl(f"t{ti}", h, 0)  # t0 a VALID 3×3 conv, the rest 1×1
    return h.mean(dim=(1, 2)) @ P["head"]["w"] + P["head"]["b"], new


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _logp(logits, y):
    return F.log_softmax(logits, dim=-1).gather(1, y[:, None])[:, 0]


def _grads(loss, tree: Tree) -> Tree:
    flat = torch.autograd.grad(loss, [t for a in tree.values() for t in a.values()])
    it = iter(flat)
    return {layer: {k: next(it) for k in arrays} for layer, arrays in tree.items()}


def _live(tree: Tree) -> Tree:
    return {layer: {k: t.detach().clone().requires_grad_(True) for k, t in a.items()} for layer, a in tree.items()}


def adam(params: Tree, grads: Tree, st: dict, lr: float, b1: float, b2: float, eps: float):
    t = st["count"] + 1
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    new, mu, nu = {}, {}, {}
    with torch.no_grad():
        for layer, arrays in params.items():
            new[layer], mu[layer], nu[layer] = {}, {}, {}
            for k, p in arrays.items():
                g = grads[layer][k]
                mu[layer][k] = (1 - b1) * g + b1 * st["mu"][layer][k]
                nu[layer][k] = (1 - b2) * g * g + b2 * st["nu"][layer][k]
                new[layer][k] = p.detach() - lr * ((mu[layer][k] / bc1) / (torch.sqrt(nu[layer][k] / bc2) + eps))
    return new, {"count": t, "mu": mu, "nu": nu}


def images(x_u8):
    return x_u8.float() / 127.5 - 1.0


def train_steps(P: Dict[str, Tree], S: Dict[str, Tree], batches, sz: dict) -> Tuple[dict, list]:
    """The three-player step over ``batches`` (each {"d", "c": x_l, y_l,
    x_u, z, y_g; "g": z, y_g}), the learning rates constant, α_P on:
    ({"params", "stats"} after them, [(metrics, D's pseudo-labels) a
    step]). ``sz``: "alpha", "alpha_p", "gen_widths", "disc_strides",
    "clf_blocks", "clf_tail", "lr", "b1", "b2", "eps"."""
    with float32():
        return _train_steps(P, S, batches, sz)


def _train_steps(P, S, batches, sz):
    alpha, a_p = sz["alpha"], sz["alpha_p"]
    gw, ds, cb, ct = sz["gen_widths"], sz["disc_strides"], sz["clf_blocks"], sz["clf_tail"]
    opt = {p: {"count": 0, "mu": {l: {k: torch.zeros_like(t) for k, t in a.items()} for l, a in P[p].items()},
               "nu": {l: {k: torch.zeros_like(t) for k, t in a.items()} for l, a in P[p].items()}} for p in P}
    step_adam = lambda p, g, player: adam(p, g, opt[player], sz["lr"], sz["b1"], sz["b2"], sz["eps"])  # noqa: E731
    P = {p: {l: {k: t.detach() for k, t in a.items()} for l, a in tree.items()} for p, tree in P.items()}
    S = dict(S)
    out = []
    for batch in batches:
        bd, bg, bc = batch["d"], batch["g"], batch["c"]
        b = bd["z"].shape[0]
        x_l, x_u = images(bd["x_l"]), images(bd["x_u"])
        with torch.no_grad():
            x_g, _ = generator(P["gen"], S["gen"], bd["z"], bd["y_g"].long(), gw)
            y_c = torch.argmax(classifier(P["clf"], S["clf"], x_u, cb, ct)[0], dim=-1)
        pd = _live(P["disc"])
        logits, S_disc = discriminator(pd, S["disc"], torch.cat([x_l, x_u, x_g]),
                                       torch.cat([bd["y_l"].long(), y_c, bd["y_g"].long()]), ds)
        lr_, lc_, lg_ = logits[:b], logits[b:2 * b], logits[2 * b:]
        d_real, d_cla, d_gen = (_softplus(-lr_).mean(), alpha * _softplus(lc_).mean(),
                                (1 - alpha) * _softplus(lg_).mean())
        loss_d = d_real + d_cla + d_gen
        P["disc"], opt["disc"] = step_adam(P["disc"], _grads(loss_d, pd), "disc")
        S["disc"] = S_disc

        pg = _live(P["gen"])
        x_raw, S_gen = generator(pg, S["gen"], bg["z"], bg["y_g"].long(), gw)
        loss_g = (1 - alpha) * _softplus(-discriminator(P["disc"], S["disc"], x_raw, bg["y_g"].long(), ds)[0]).mean()
        P["gen"], opt["gen"] = step_adam(P["gen"], _grads(loss_g, pg), "gen")
        S["gen"] = S_gen

        x_l, x_u = images(bc["x_l"]), images(bc["x_u"])
        with torch.no_grad():
            x_g, _ = generator(P["gen"], S["gen"], bc["z"], bc["y_g"].long(), gw)
        pc = _live(P["clf"])
        log_l, s1 = classifier(pc, S["clf"], x_l, cb, ct)
        log_u, s2 = classifier(pc, s1, x_u, cb, ct)
        log_g, s3 = classifier(pc, s2, x_g, cb, ct)
        y_c2 = torch.argmax(log_u.detach(), dim=-1)
        with torch.no_grad():
            w = -_softplus(discriminator(P["disc"], S["disc"], x_u, y_c2, ds)[0])
        c_sup = -_logp(log_l, bc["y_l"].long()).mean()
        c_adv = alpha * torch.mean((w - w.mean()) * _logp(log_u, y_c2))
        c_pseudo = a_p * -_logp(log_g, bc["y_g"].long()).mean()
        loss_c = c_sup + c_adv + c_pseudo
        P["clf"], opt["clf"] = step_adam(P["clf"], _grads(loss_c, pc), "clf")
        S["clf"] = s3
        metrics = {"loss_d": loss_d, "loss_g": loss_g, "loss_c": loss_c, "d_real": d_real, "d_cla": d_cla,
                   "d_gen": d_gen, "c_sup": c_sup, "c_adv": c_adv, "c_pseudo": c_pseudo}
        out.append(({k: float(v.detach()) for k, v in metrics.items()}, y_c))
    return {"params": P, "stats": S}, out
