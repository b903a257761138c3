"""Plain PyTorch reference of Triple-GAN (arXiv:1703.02291) with the
SN-ResNet pair as G and D: the CIFAR-10 ResNet generator with
class-conditional batch norm and the spectrally normalised ResNet
discriminator with a projection head (Miyato & Koyama, cGANs with
Projection Discriminator, arXiv:1802.05637; Miyato et al., Spectral
Normalization for GANs, arXiv:1802.05957; code: pfnet-research/
sngan_projection, gen_models/resnet_32.py, dis_models/snresnet_32.py).

Written from the papers and the configuration file's sizes, in float32
with TF32 off, with ``F.conv2d`` and plain tensor arithmetic only. C, the
ZCA fit, the input transform, the draws, the losses and Adam are
``triplegan.py``'s, which this module imports and does not change. It
imports nothing of the program under test.

Spectral normalisation: each weight W, seen as a matrix (a conv kernel
(O, I, kh, kw) as (O, I·kh·kw), the dense head (in, out) as (out, in), the
class embedding (classes, C) as it is), keeps a vector u. One power
iteration from the kept u gives v = normalise(Wᵀu) and u' =
normalise(W·v), constants to the gradient, and σ = u'ᵀ·W·v, which is not;
the layer uses W/σ. D's update makes that iteration and keeps u'; G's and
C's updates call D with the kept u and keep nothing.

Layouts: images and activations NHWC; conv kernels OIHW; dense kernels
(in, out); the class embedding (classes, C).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from reference import triplegan as base

Tree = Dict[str, Dict[str, torch.Tensor]]
fit_zca = base.fit_zca
EPS = 1e-3


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def conv(x, w, b):
    """Stride-1 conv of NHWC x padded to keep its size, plus a bias."""
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=w.shape[-1] // 2).permute(0, 2, 3, 1) + b


def normalize(x):
    """Batch norm without an affine, with the batch's moments."""
    return (x - x.mean(dim=(0, 1, 2))) * torch.rsqrt(x.var(dim=(0, 1, 2), unbiased=False) + EPS)


def up(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def pool(x):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def unit(v):
    return v / (torch.sqrt(torch.sum(v * v)) + 1e-12)


def matrix(name: str, w):
    return w.t() if name == "l5" else w.reshape(w.shape[0], -1)


# ---------------------------------------------------------------------------
# G and D
# ---------------------------------------------------------------------------


def generator_fwd(P: Tree, z, y, sz: dict):
    """Images in [-1, 1] (train-mode batch norm): l1 → 4×4×W0, up-blocks of
    cBN·ReLU → upsample → conv → cBN·ReLU → conv plus an upsampled 1×1
    shortcut, then BN·ReLU, a 3×3 conv to RGB and tanh."""
    widths = sz["gen"]["widths"]
    s0 = sz["image_size"] // 2 ** len(widths)
    h = (z @ P["l1"]["w"] + P["l1"]["b"]).reshape(-1, s0, s0, widths[0])

    def cbn_relu(name, x):
        p = P[name]
        return torch.relu(normalize(x) * p["gamma"][y][:, None, None, :] + p["beta"][y][:, None, None, :])

    for i in range(len(widths)):
        blk = f"block{i + 2}"
        t = conv(up(cbn_relu(f"{blk}_b1", h)), P[f"{blk}_c1"]["w"], P[f"{blk}_c1"]["b"])
        t = conv(cbn_relu(f"{blk}_b2", t), P[f"{blk}_c2"]["w"], P[f"{blk}_c2"]["b"])
        h = t + conv(up(h), P[f"{blk}_c_sc"]["w"], P[f"{blk}_c_sc"]["b"])
    h = torch.relu(normalize(h) * P["b5"]["scale"] + P["b5"]["bias"])
    return torch.tanh(conv(h, P["c5"]["w"], P["c5"]["b"]))


def spectral(P: Tree, U: Tree):
    """{layer: (u', σ)}: one power iteration from each kept u."""
    out = {}
    for name, s in U.items():
        w = matrix(name, P[name]["w"])
        with torch.no_grad():
            v = unit(w.detach().t() @ s["u"])
            u = unit(w.detach() @ v)
        out[name] = (u, torch.dot(u, w @ v))
    return out


def discriminator_fwd(P: Tree, U: Tree, x, y, sz: dict):
    """(the logit that (x, y) is a real pair, {layer: {"u": u'}}): the
    optimised block (conv, ReLU, conv, pool; shortcut pool then 1×1 conv),
    blocks of ReLU, conv, ReLU, conv (pooled at stride 2; shortcut a 1×1
    conv then the pool where the block pools or widens, else x), ReLU, a
    sum over H and W, l5 plus the projection onto embed(y)."""
    sn = spectral(P, U)

    def c(name, h):
        return conv(h, P[name]["w"] / sn[name][1], P[name]["b"])

    d = sz["disc"]
    h, cin = x, sz["channels"]
    for i, (w, s) in enumerate(zip(d["widths"], d["strides"])):
        blk = f"block{i + 1}"
        t = c(f"{blk}_c2", torch.relu(c(f"{blk}_c1", h if i == 0 else torch.relu(h))))
        if s == 2:
            t = pool(t)
        if i == 0:
            sc = c(f"{blk}_c_sc", pool(h) if s == 2 else h)
        elif cin != w or s == 2:
            sc = c(f"{blk}_c_sc", h)
            sc = pool(sc) if s == 2 else sc
        else:
            sc = h
        h, cin = t + sc, w
    h = torch.relu(h).sum(dim=(1, 2))
    logit = (h @ (P["l5"]["w"] / sn["l5"][1]) + P["l5"]["b"])[:, 0]
    logit = logit + torch.sum(P["l_y"]["w"][y] / sn["l_y"][1] * h, dim=-1)
    return logit, {name: {"u": u} for name, (u, _) in sn.items()}


# ---------------------------------------------------------------------------
# the three-player step
# ---------------------------------------------------------------------------


def train_steps(P: Dict[str, Tree], S: Dict[str, Tree], data, zca, sz: dict, seed: int, start_step: int,
                n_steps: int, tf32: bool = False):
    """``n_steps`` three-player updates from ``P`` and the statistics ``S``
    (D's kept u; the batch norms run on the batch's moments) at step
    ``start_step``, in float32 with TF32 off (``tf32``: allowed, the
    control). Returns ``triplegan.train_steps``'s readings and "u", D's
    kept u after the steps."""
    with base.precision(tf32):
        return _train_steps(P, S, data, zca, sz, seed, start_step, n_steps)


def _train_steps(P, S, data, zca, sz, seed, start_step, n_steps):
    b, alpha = sz["batch_size"], sz["alpha"]
    steps_per_epoch = max(data["x_u"].shape[0] // b, 1)
    opts = {p: base.Adam(sz[f"lr_{k}"], sz["adam_b1"], sz["adam_b2"], sz["adam_eps"])
            for p, k in (("gen", "g"), ("disc", "d"), ("clf", "c"))}
    total = sz["epochs"] * steps_per_epoch
    if start_step + n_steps > int(sz["lr_decay_start_frac"] * total) or sz["lr_c_anneal_factor"] != 1.0:
        raise ValueError("the reference holds each learning rate constant: the steps lie before the decay")
    opt_state = {p: opts[p].init(P[p]) for p in P}
    P = {p: {l: {k: t.detach() for k, t in a.items()} for l, a in tree.items()} for p, tree in P.items()}
    U = {l: {"u": a["u"].detach()} for l, a in S["disc"].items()}
    losses, first = [], None
    dev = data["x_u"].device
    for i in range(n_steps):
        step = start_step + i
        a_p = base.alpha_p_at(step, sz, steps_per_epoch)
        g = base.step_generator(dev, seed, step, 0)
        batch = base.draw_batch(base.step_generator(dev, seed, step, base.SAMPLER_STREAM), data, b, sz)

        # D's update, with G and C as they are; D keeps its new u
        bd = batch["d"]
        x_l, x_u = base.preprocess(bd["x_l"], zca, sz, g), base.preprocess(bd["x_u"], zca, sz, g)
        with torch.no_grad():
            x_g = base.whiten(generator_fwd(P["gen"], bd["z"], bd["y_g"], sz), zca)
            y_c = base.pseudo_labels(g, base.classifier_fwd(P["clf"], x_u, sz, g))
        pd = base._with_grad(P["disc"])
        logits, U = discriminator_fwd(pd, U, torch.cat([x_l, x_u, x_g]), torch.cat([bd["y_l"], y_c, bd["y_g"]]), sz)
        l_real, l_cla, l_gen = logits[:b], logits[b:2 * b], logits[2 * b:]
        loss_d = (-base.log_sig(l_real).mean() - alpha * base.log_sig(-l_cla).mean()
                  - (1 - alpha) * base.log_sig(-l_gen).mean())
        grad_d = base._grad(loss_d, pd)
        P["disc"], opt_state["disc"] = opts["disc"].update(P["disc"], grad_d, opt_state["disc"])

        # G's update, scored by the new D
        bg = batch["g"]
        pg = base._with_grad(P["gen"])
        logit_g, _ = discriminator_fwd(P["disc"], U, base.whiten(generator_fwd(pg, bg["z"], bg["y_g"], sz), zca),
                                       bg["y_g"], sz)
        loss_g = -(1 - alpha) * base.log_sig(logit_g).mean()
        grad_g = base._grad(loss_g, pg)
        P["gen"], opt_state["gen"] = opts["gen"].update(P["gen"], grad_g, opt_state["gen"])

        # C's update, seeing the new D and G
        bc = batch["c"]
        x_l, x_u = base.preprocess(bc["x_l"], zca, sz, g), base.preprocess(bc["x_u"], zca, sz, g)
        with torch.no_grad():
            x_g = base.whiten(generator_fwd(P["gen"], bc["z"], bc["y_g"], sz), zca)
        pc = base._with_grad(P["clf"])
        log_l = base.classifier_fwd(pc, x_l, sz, g)
        log_u = base.classifier_fwd(pc, x_u, sz, g)
        log_g = base.classifier_fwd(pc, x_g, sz, g)
        y_c = base.pseudo_labels(g, log_u)
        with torch.no_grad():
            w = base.log_sig(-discriminator_fwd(P["disc"], U, x_u, y_c, sz)[0])
        logp_u = F.log_softmax(log_u, dim=-1).gather(1, y_c[:, None])[:, 0]
        loss_c = (base.ce(log_l, bc["y_l"]) + alpha * torch.mean((w - w.mean()) * logp_u)
                  + a_p * base.ce(log_g, bc["y_g"]))
        grad_c = base._grad(loss_c, pc)
        P["clf"], opt_state["clf"] = opts["clf"].update(P["clf"], grad_c, opt_state["clf"])

        losses.append((float(loss_d.detach()), float(loss_g.detach()), float(loss_c.detach())))
        if first is None:
            first = {"gen": grad_g, "disc": grad_d, "clf": grad_c}
    return {"losses": losses, "grads": first, "mu": {p: s["mu"] for p, s in opt_state.items()}, "params": P,
            "u": U}


# ---------------------------------------------------------------------------
# weights from the seed
# ---------------------------------------------------------------------------


def layout(sz: dict) -> Dict[str, Dict[str, Dict[str, Tuple[Tuple[int, ...], str]]]]:
    """Every array of the three players, as ``triplegan.layout``'s, C's
    from there; G's and D's inits: "normal" (std 0.05) for kernels and D's
    u, "one"/"zero", "run_mean"/"run_var", and "cbn_gamma"/"cbn_beta" for
    the class-conditional tables."""
    nc, ch = sz["num_classes"], sz["channels"]
    out = {"gen": {}, "disc": {}, "clf": base.layout(sz)["clf"]}
    gw = sz["gen"]["widths"]
    s0 = sz["image_size"] // 2 ** len(gw)

    def conv_(player, name, cin, cout, k):
        out[player][name] = {"w": ((cout, cin, k, k), "normal"), "b": ((cout,), "zero")}
        if player == "disc":
            out["disc"][name]["u"] = ((cout,), "normal")

    def cbn(name, width):
        out["gen"][name] = {"gamma": ((nc, width), "cbn_gamma"), "beta": ((nc, width), "cbn_beta"),
                            "mean": ((width,), "run_mean"), "var": ((width,), "run_var")}

    out["gen"]["l1"] = {"w": ((sz["z_dim"], s0 * s0 * gw[0]), "normal"), "b": ((s0 * s0 * gw[0],), "zero")}
    cin = gw[0]
    for i, w in enumerate(gw):
        blk = f"block{i + 2}"
        cbn(f"{blk}_b1", cin)
        conv_("gen", f"{blk}_c1", cin, w, 3)
        cbn(f"{blk}_b2", w)
        conv_("gen", f"{blk}_c2", w, w, 3)
        conv_("gen", f"{blk}_c_sc", cin, w, 1)
        cin = w
    out["gen"]["b5"] = {"scale": ((cin,), "one"), "bias": ((cin,), "zero"), "mean": ((cin,), "run_mean"),
                        "var": ((cin,), "run_var")}
    conv_("gen", "c5", cin, ch, 3)

    d = sz["disc"]
    cin = ch
    for i, (w, s) in enumerate(zip(d["widths"], d["strides"])):
        blk = f"block{i + 1}"
        conv_("disc", f"{blk}_c1", cin, w, 3)
        conv_("disc", f"{blk}_c2", w, w, 3)
        if i == 0 or cin != w or s == 2:
            conv_("disc", f"{blk}_c_sc", cin, w, 1)
        cin = w
    out["disc"]["l5"] = {"w": ((cin, 1), "normal"), "b": ((1,), "zero"), "u": ((1,), "normal")}
    out["disc"]["l_y"] = {"w": ((nc, cin), "normal"), "u": ((nc,), "normal")}
    return out


STATS = ("mean", "var", "u")
UNIFORM = ("run_mean", "run_var", "cbn_gamma", "cbn_beta")


def make_weights(sz: dict, seed: int, device) -> Tuple[Dict[str, Tree], Dict[str, Tree]]:
    """(params, statistics) of the three players from ``seed``, made on
    ``device`` in two draws: one normal draw for every kernel and D's u,
    one uniform draw for the running statistics and the class-conditional
    tables (γ uniform in [0.8, 1.2], β uniform with std 0.1: each class
    scales and shifts differently, as in a run well into training)."""
    lay = layout(sz)
    arrays = [(p, l, a, shape, init) for p, layers in lay.items() for l, arr in layers.items()
              for a, (shape, init) in arr.items()]
    normal = [r for r in arrays if r[4] == "normal"]
    uniform = [r for r in arrays if r[4] in UNIFORM]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat_n = 0.05 * torch.randn(sum(math.prod(r[3]) for r in normal), generator=gen, device=device)
    flat_u = torch.rand(sum(math.prod(r[3]) for r in uniform), generator=gen, device=device)
    params: Dict[str, Tree] = {p: {} for p in lay}
    stats: Dict[str, Tree] = {p: {} for p in lay}

    def put(p, l, a, t):
        (stats if a in STATS else params)[p].setdefault(l, {})[a] = t

    at = 0
    for p, l, a, shape, _ in normal:
        n = math.prod(shape)
        put(p, l, a, flat_n[at:at + n].reshape(shape).clone())
        at += n
    at = 0
    sym = math.sqrt(3.0)
    for p, l, a, shape, init in uniform:
        n = math.prod(shape)
        u = 2.0 * flat_u[at:at + n].reshape(shape) - 1.0  # uniform in [-1, 1]
        put(p, l, a, {"run_mean": 0.1 * sym * u, "run_var": 1.25 + 0.75 * u, "cbn_gamma": 1.0 + 0.2 * u,
                      "cbn_beta": 0.1 * sym * u}[init].clone())
        at += n
    for p, l, a, shape, init in arrays:
        if init in ("one", "zero"):
            put(p, l, a, (torch.ones if init == "one" else torch.zeros)(shape, device=device))
    return params, stats
