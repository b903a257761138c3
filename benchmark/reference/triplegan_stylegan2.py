"""Plain PyTorch reference of Triple-GAN (arXiv:1703.02291) with the
StyleGAN2 pair as G and D (Karras et al., Analyzing and Improving the Image
Quality of StyleGAN, arXiv:1912.04958), at StyleGAN2-ADA's cifar
configuration (arXiv:2006.06676; NVlabs/stylegan2-ada-pytorch, train.py
cfg_specs['cifar'], training/networks.py, training/loss.py): G the mapping
and the skip synthesis of modulated convs with noise, D ``orig`` with the
minibatch stddev and a projection onto its own label mapping, the lazy R1
penalty and G's EMA copy.

Written from the papers and StyleGAN2-ADA's layer equations, in float32
with TF32 off (R1's gradient in float64, below), NCHW inside the networks
as StyleGAN2-ADA computes them:
``F.conv2d``, ``F.conv_transpose2d``, a depthwise FIR filter with
upfirdn2d's paddings, modulated_conv2d's non-fused path (x ⊙ s, the conv by
the shared weight, then ⊙ d plus the noise), bias_act (leaky ReLU(0.2)
times √2, the clamp), the stddev over groups whose members stand N/G rows
apart. C, the ZCA fit, the input transform, the draws, the losses and
Adam are ``triplegan.py``'s, which this module imports and does not change.
It imports nothing of the program under test.

The step: on a step whose number is a multiple of ``r1_interval``, D's R1
update first, (γ/2)·interval·mean ‖∇ₓD(x_l, y_l)‖² over D's preprocessed
labelled images (those D's main update then uses), the gradient taken with
``create_graph``, one Adam step (D's Adam count then advances twice). That
gradient is computed in float64 and rounded once to float32: in float32 its
rounding reaches 5e-4 of its norm on some seeds (against a float64 one, at
the cell's size; every float32 implementation alike, the program's kernels
no worse than plain PyTorch), and the step is D's first Adam step in the
check, which moves each element by about ±lr by the sign of its gradient.
The control (TF32) computes it in float32 with TF32 allowed. Then
the three updates, D called on the 3B rows (real, pseudo-labelled,
generated) with its stddev groups inside each stream of B; G's noise planes
drawn from the step's generator in layer order at each G call; w_avg
advanced in G's own update, G's EMA copy after G's Adam.

Layouts, as the program's: images NHWC; conv kernels OIHW; dense kernels
(in, out); the learned constant (4, 4, C); D's flattened 4×4 map in (H, W,
C) order.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from reference import triplegan as base

Tree = Dict[str, Dict[str, torch.Tensor]]
fit_zca = base.fit_zca
SQRT2 = math.sqrt(2.0)
EMA = "_ema"


# ---------------------------------------------------------------------------
# layers (NCHW)
# ---------------------------------------------------------------------------


def fir(device, dtype=torch.float32):
    f = torch.tensor([1.0, 3.0, 3.0, 1.0], device=device, dtype=dtype)
    f = torch.outer(f, f)
    return f / f.sum()


def upfirdn2d(x, up=1, pad=(0, 0, 0, 0), gain=1.0):
    """StyleGAN2-ADA's reference upfirdn2d with the 4×4 filter: zeros
    inserted, padded (x0, x1, y0, y1), convolved (the flipped filter) at
    ``gain``."""
    n, c, h, w = x.shape
    if up > 1:
        x = F.pad(x.reshape(n, c, h, 1, w, 1), [0, up - 1, 0, 0, 0, up - 1]).reshape(n, c, h * up, w * up)
    x = F.pad(x, list(pad))
    f = (fir(x.device, x.dtype) * gain).flip([0, 1])
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
    n = x.shape[0]
    if demodulate:
        w = weight[None] * styles.reshape(n, 1, -1, 1, 1)
        dcoefs = (w.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt()
    x = x * styles.reshape(n, -1, 1, 1)
    if up:
        x = F.conv_transpose2d(x, weight.transpose(0, 1), stride=2)
        x = upfirdn2d(x, pad=(1, 1, 1, 1), gain=4.0)
    else:
        x = F.conv2d(x, weight, padding=weight.shape[-1] // 2)
    if demodulate:
        x = x * dcoefs.reshape(n, -1, 1, 1)
    return x if noise is None else x + noise


def mbstd(x, group, channels=1):
    """StyleGAN2-ADA's MinibatchStdLayer over one stream of rows."""
    n, c, h, w = x.shape
    g = min(group, n)
    y = x.reshape(g, -1, channels, c // channels, h, w)
    y = y - y.mean(dim=0)
    y = y.square().mean(dim=0)
    y = (y + 1e-8).sqrt()
    y = y.mean(dim=[2, 3, 4])
    y = y.reshape(-1, channels, 1, 1).repeat(g, 1, h, w)
    return torch.cat([x, y], dim=1)


# ---------------------------------------------------------------------------
# G and D
# ---------------------------------------------------------------------------


def mapping(P: Tree, z, y, sz: dict):
    g = sz["gen"]
    e = fc(P["embed"], F.one_hot(y, sz["num_classes"]).float())
    x = torch.cat([norm2(z), norm2(e)], dim=1)
    for i in range(g["map_layers"]):
        x = fc(P[f"map{i}"], x, g["map_lr_mult"], act=True)
    return x


def generator_fwd(P: Tree, z, y, sz: dict, g=None):
    """(NHWC images, w): the mapping, then the blocks from 4×4; each
    modulated conv's noise plane (N, H, W) drawn from ``g`` in layer order
    (none without one)."""
    gs = sz["gen"]
    w = mapping(P, z, y, sz)
    n, clamp = z.shape[0], gs["conv_clamp"]

    def layer(name, x, res, up=False):
        p = P[name]
        nz = None
        if g is not None:
            nz = torch.randn((n, res, res), generator=g, device=z.device)[:, None] * p["r"]
        x = modulated_conv2d(x, p["w"], fc({"w": p["aw"], "b": p["ab"]}, w), nz, up=up)
        return bias_act(x, p["b"], clamp)

    def torgb(name, x):
        p = P[name]
        s = fc({"w": p["aw"], "b": p["ab"]}, w) * (1.0 / math.sqrt(p["w"].shape[1]))
        return bias_act(modulated_conv2d(x, p["w"], s, demodulate=False), p["b"], clamp, act=False)

    x = P["b4_const"]["w"].permute(2, 0, 1)[None].repeat(n, 1, 1, 1)
    img = None
    for i in range(len(gs["widths"])):
        res = 4 * 2 ** i
        if res > 4:
            x = layer(f"b{res}_conv0", x, res, up=True)
        x = layer(f"b{res}_conv1", x, res)
        y = torgb(f"b{res}_torgb", x)
        img = y if img is None else upfirdn2d(img, up=2, pad=(2, 1, 2, 1), gain=4.0) + y
    return img.permute(0, 2, 3, 1), w


def discriminator_fwd(P: Tree, x, y, sz: dict, streams: int = 1):
    """The logits of NHWC x with labels y; the stddev groups within each of
    ``streams`` equal runs of rows."""
    d = sz["disc"]
    clamp, s = d["conv_clamp"], sz["image_size"]

    def conv(name, h, down=False):
        p = P[name]
        wt = p["w"] * (1.0 / math.sqrt(p["w"][0].numel()))
        if down:
            h = F.conv2d(upfirdn2d(h, pad=(2, 2, 2, 2)), wt, stride=2)
        else:
            h = F.conv2d(h, wt, padding=wt.shape[-1] // 2)
        return bias_act(h, p["b"], clamp)

    h = conv(f"b{s}_fromrgb", x.permute(0, 3, 1, 2))
    res = s
    while res > 4:
        h = conv(f"b{res}_conv1", conv(f"b{res}_conv0", h), down=True)
        res //= 2
    h = torch.cat([mbstd(t, d["mbstd_group"], d["mbstd_channels"]) for t in h.split(h.shape[0] // streams)])
    h = conv("b4_conv", h)
    h = fc(P["b4_fc"], h.permute(0, 2, 3, 1).flatten(1), act=True)
    h = fc(P["b4_out"], h)
    c = norm2(fc(P["cmap_embed"], F.one_hot(y, sz["num_classes"]).to(x.dtype)))
    for i in range(d["map_layers"]):
        c = fc(P[f"cmap{i}"], c, d["map_lr_mult"], act=True)
    return (h * c).sum(dim=1) * (1.0 / math.sqrt(d["cmap_dim"]))


# ---------------------------------------------------------------------------
# the three-player step
# ---------------------------------------------------------------------------


def train_steps(P: Dict[str, Tree], S: Dict[str, Tree], data, zca, sz: dict, seed: int, start_step: int,
                n_steps: int, tf32: bool = False):
    """``n_steps`` three-player updates (with R1 where due) from ``P`` and
    G's statistics in ``S`` at step ``start_step``, in float32 with TF32 off
    (``tf32``: allowed, the control). Returns ``triplegan.train_steps``'s
    readings and "stats", G's w_avg and EMA copy after the steps."""
    with base.precision(tf32):
        return _train_steps(P, S, data, zca, sz, seed, start_step, n_steps, torch.float32 if tf32 else torch.float64)


def _ema_beta(step: int, sz: dict) -> float:
    b = sz["batch_size"]
    nimg = min(sz["gen"]["ema_kimg"] * 1000.0, sz["gen"]["ema_rampup"] * step * b)
    return 0.5 ** (b / max(nimg, 1e-8))


def r1_gradient(P: Tree, x, y, sz: dict, dtype) -> Tree:
    """The gradient of D's R1 penalty at ``P`` on NHWC x with labels y,
    computed in ``dtype`` and returned in float32."""
    pr = {l: {k: t.detach().to(dtype).requires_grad_(True) for k, t in a.items()} for l, a in P.items()}
    x_r = x.detach().to(dtype).requires_grad_(True)
    (g_x,) = torch.autograd.grad(discriminator_fwd(pr, x_r, y, sz).sum(), x_r, create_graph=True)
    r1 = g_x.square().sum(dim=[1, 2, 3]).mean() * (sz["r1_gamma"] / 2.0 * sz["r1_interval"])
    leaves = base._leaves(pr)
    flat = iter(torch.autograd.grad(r1, leaves, allow_unused=True, materialize_grads=True))
    return {l: {k: next(flat).to(torch.float32) for k in a} for l, a in pr.items()}


def _train_steps(P, S, data, zca, sz, seed, start_step, n_steps, r1_dtype):
    b, alpha = sz["batch_size"], sz["alpha"]
    interval = sz["r1_interval"]
    steps_per_epoch = max(data["x_u"].shape[0] // b, 1)
    opts = {p: base.Adam(sz[f"lr_{k}"], sz["adam_b1"], sz["adam_b2"], sz["adam_eps"])
            for p, k in (("gen", "g"), ("disc", "d"), ("clf", "c"))}
    total = sz["epochs"] * steps_per_epoch
    if start_step + n_steps > int(sz["lr_decay_start_frac"] * total) or sz["lr_c_anneal_factor"] != 1.0:
        raise ValueError("the reference holds each learning rate constant: the steps lie before the decay")
    opt_state = {p: opts[p].init(P[p]) for p in P}
    P = {p: {l: {k: t.detach() for k, t in a.items()} for l, a in tree.items()} for p, tree in P.items()}
    GS = {l: {k: t.detach() for k, t in a.items()} for l, a in S["gen"].items()}
    last = f"map{sz['gen']['map_layers'] - 1}"
    losses, first = [], None
    dev = data["x_u"].device
    for i in range(n_steps):
        step = start_step + i
        a_p = base.alpha_p_at(step, sz, steps_per_epoch)
        g = base.step_generator(dev, seed, step, 0)
        batch = base.draw_batch(base.step_generator(dev, seed, step, base.SAMPLER_STREAM), data, b, sz)
        bd = batch["d"]
        x_l = base.preprocess(bd["x_l"], zca, sz, g)

        if interval > 0 and step % interval == 0:  # D's lazy R1 update
            grad_r = r1_gradient(P["disc"], x_l, bd["y_l"], sz, r1_dtype)
            P["disc"], opt_state["disc"] = opts["disc"].update(P["disc"], grad_r, opt_state["disc"])

        # D's update, with G and C as they are
        x_u = base.preprocess(bd["x_u"], zca, sz, g)
        with torch.no_grad():
            x_g = base.whiten(generator_fwd(P["gen"], bd["z"], bd["y_g"], sz, g)[0], zca)
            y_c = base.pseudo_labels(g, base.classifier_fwd(P["clf"], x_u, sz, g))
        pd = base._with_grad(P["disc"])
        logits = discriminator_fwd(pd, torch.cat([x_l, x_u, x_g]), torch.cat([bd["y_l"], y_c, bd["y_g"]]), sz,
                                   streams=3)
        l_real, l_cla, l_gen = logits[:b], logits[b:2 * b], logits[2 * b:]
        loss_d = (-base.log_sig(l_real).mean() - alpha * base.log_sig(-l_cla).mean()
                  - (1 - alpha) * base.log_sig(-l_gen).mean())
        grad_d = base._grad(loss_d, pd)
        P["disc"], opt_state["disc"] = opts["disc"].update(P["disc"], grad_d, opt_state["disc"])

        # G's update, scored by the new D; w_avg advances here alone, the EMA after G's Adam
        bg = batch["g"]
        pg = base._with_grad(P["gen"])
        img, w = generator_fwd(pg, bg["z"], bg["y_g"], sz, g)
        logit_g = discriminator_fwd(P["disc"], base.whiten(img, zca), bg["y_g"], sz)
        loss_g = -(1 - alpha) * base.log_sig(logit_g).mean()
        grad_g = base._grad(loss_g, pg)
        P["gen"], opt_state["gen"] = opts["gen"].update(P["gen"], grad_g, opt_state["gen"])
        with torch.no_grad():
            GS[last] = dict(GS[last], w_avg=w.detach().mean(dim=0).lerp(GS[last]["w_avg"], sz["gen"]["w_avg_beta"]))
            beta = _ema_beta(step, sz)
            for l, arrays in P["gen"].items():
                for k, p in arrays.items():
                    GS[l][k + EMA] = p.lerp(GS[l][k + EMA], beta)

        # C's update, seeing the new D and G
        bc = batch["c"]
        x_l, x_u = base.preprocess(bc["x_l"], zca, sz, g), base.preprocess(bc["x_u"], zca, sz, g)
        with torch.no_grad():
            x_g = base.whiten(generator_fwd(P["gen"], bc["z"], bc["y_g"], sz, g)[0], zca)
        pc = base._with_grad(P["clf"])
        log_l = base.classifier_fwd(pc, x_l, sz, g)
        log_u = base.classifier_fwd(pc, x_u, sz, g)
        log_g = base.classifier_fwd(pc, x_g, sz, g)
        y_c = base.pseudo_labels(g, log_u)
        with torch.no_grad():
            wd = base.log_sig(-discriminator_fwd(P["disc"], x_u, y_c, sz))
        logp_u = F.log_softmax(log_u, dim=-1).gather(1, y_c[:, None])[:, 0]
        loss_c = (base.ce(log_l, bc["y_l"]) + alpha * torch.mean((wd - wd.mean()) * logp_u)
                  + a_p * base.ce(log_g, bc["y_g"]))
        grad_c = base._grad(loss_c, pc)
        P["clf"], opt_state["clf"] = opts["clf"].update(P["clf"], grad_c, opt_state["clf"])

        losses.append((float(loss_d.detach()), float(loss_g.detach()), float(loss_c.detach())))
        if first is None:
            first = {"gen": grad_g, "disc": grad_d, "clf": grad_c}
    return {"losses": losses, "grads": first, "mu": {p: s["mu"] for p, s in opt_state.items()}, "params": P,
            "stats": GS}


# ---------------------------------------------------------------------------
# weights from the seed
# ---------------------------------------------------------------------------


def layout(sz: dict) -> Dict[str, Dict[str, Dict[str, Tuple[Tuple[int, ...], str]]]]:
    """Every parameter of the three players, as ``triplegan.layout``'s, C's
    from there; G's and D's inits: "unit" (N(0, 1)), "map" (N(0, 1) over
    the lr multiplier, the mapping layers'), "one", "zero", "noise" (the
    noise strengths' start)."""
    nc, ch, s = sz["num_classes"], sz["channels"], sz["image_size"]
    g, d = sz["gen"], sz["disc"]
    wd = g["w_dim"]
    out = {"gen": {}, "disc": {}, "clf": {l: a for l, a in base.layout(sz)["clf"].items()}}

    def dense(player, name, cin, cout, init="unit", bias="zero"):
        out[player][name] = {"w": ((cin, cout), init), "b": ((cout,), bias)}

    def modulated(name, cin, cout, k=3, noise=True):
        out["gen"][name] = {"w": ((cout, cin, k, k), "unit"), "b": ((cout,), "zero"),
                            "aw": ((wd, cin), "unit"), "ab": ((cin,), "one")}
        if noise:
            out["gen"][name]["r"] = ((), "noise")

    dense("gen", "embed", nc, wd)
    for i in range(g["map_layers"]):
        dense("gen", f"map{i}", sz["z_dim"] + wd if i == 0 else wd, wd, "map")
    out["gen"]["b4_const"] = {"w": ((4, 4, g["widths"][0]), "unit")}
    cin = g["widths"][0]
    for i, w in enumerate(g["widths"]):
        res = 4 * 2 ** i
        if res > 4:
            modulated(f"b{res}_conv0", cin, w)
        modulated(f"b{res}_conv1", w, w)
        modulated(f"b{res}_torgb", w, ch, k=1, noise=False)
        cin = w

    dw = d["widths"]
    out["disc"][f"b{s}_fromrgb"] = {"w": ((dw[0], ch, 1, 1), "unit"), "b": ((dw[0],), "zero")}
    res = s
    for i in range(len(dw) - 1):
        out["disc"][f"b{res}_conv0"] = {"w": ((dw[i], dw[i], 3, 3), "unit"), "b": ((dw[i],), "zero")}
        out["disc"][f"b{res}_conv1"] = {"w": ((dw[i + 1], dw[i], 3, 3), "unit"), "b": ((dw[i + 1],), "zero")}
        res //= 2
    c4 = dw[-1]
    out["disc"]["b4_conv"] = {"w": ((c4, c4 + d["mbstd_channels"], 3, 3), "unit"), "b": ((c4,), "zero")}
    dense("disc", "b4_fc", 16 * c4, c4)
    dense("disc", "b4_out", c4, d["cmap_dim"])
    dense("disc", "cmap_embed", nc, d["cmap_dim"])
    for i in range(d["map_layers"]):
        dense("disc", f"cmap{i}", d["cmap_dim"], d["cmap_dim"], "map")
    return out


NOISE_START = 0.1


def make_weights(sz: dict, seed: int, device) -> Tuple[Dict[str, Tree], Dict[str, Tree]]:
    """(params, statistics) of the three players from ``seed``, made on
    ``device`` in two draws: one normal draw for every kernel (G's and D's
    N(0, 1), the mapping layers' over their lr multiplier, C's std 0.05),
    one uniform draw for C's running statistics. G's statistics: w_avg 0
    and its EMA copy equal to its parameters; D has none."""
    lay = layout(sz)
    arrays = [(p, l, a, shape, init) for p, layers in lay.items() for l, arr in layers.items()
              for a, (shape, init) in arr.items()]
    normal = [r for r in arrays if r[4] in ("unit", "map", "normal")]
    running = [r for r in arrays if r[4] in ("run_mean", "run_var")]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat_n = torch.randn(sum(math.prod(r[3]) for r in normal), generator=gen, device=device)
    flat_r = torch.rand(sum(math.prod(r[3]) for r in running), generator=gen, device=device)
    params: Dict[str, Tree] = {p: {} for p in lay}
    stats: Dict[str, Tree] = {p: {} for p in lay}
    scale = {"unit": 1.0, "map": 1.0 / sz["gen"]["map_lr_mult"], "normal": 0.05}
    at = 0
    for p, l, a, shape, init in normal:
        n = math.prod(shape)
        if p == "disc" and init == "map":
            s = 1.0 / sz["disc"]["map_lr_mult"]
        else:
            s = scale[init]
        params[p].setdefault(l, {})[a] = (s * flat_n[at:at + n].reshape(shape)).clone()
        at += n
    at = 0
    for p, l, a, shape, init in running:
        n = math.prod(shape)
        u = flat_r[at:at + n].reshape(shape)
        stats[p].setdefault(l, {})[a] = (0.1 * (2.0 * u - 1.0) * math.sqrt(3.0) if init == "run_mean"
                                         else 0.5 + 1.5 * u).clone()
        at += n
    for p, l, a, shape, init in arrays:
        if init in ("one", "zero", "noise"):
            params[p].setdefault(l, {})[a] = torch.full(shape, {"one": 1.0, "zero": 0.0, "noise": NOISE_START}[init],
                                                        device=device)
    stats["gen"] = {l: {k + EMA: t.clone() for k, t in a.items()} for l, a in params["gen"].items()}
    stats["gen"][f"map{sz['gen']['map_layers'] - 1}"]["w_avg"] = torch.zeros(sz["gen"]["w_dim"], device=device)
    return params, stats
