"""Plain PyTorch reference of Triple-GAN (Li et al., Triple Generative
Adversarial Nets, NeurIPS 2017): the three networks, the three-player train
step with its Adam updates, and the ZCA fit.

Written from the paper and the configuration file's sizes, in float32 with
TF32 off, which it sets itself (``precision``), and float64 for the ZCA
fit, with ``F.conv2d`` and plain tensor arithmetic only. It imports nothing
of the program under test and takes nothing it made: the benchmark hands
both sides the same weights and images.

What the program derives from the seed inside a step (sub-batch indices,
latent codes, noise, dropout masks, shifts and flips, pseudo-label draws)
comes from PyTorch generators seeded by a fixed rule of (seed, step,
stream), drawn in the order the step's mathematics needs them. The
reference seeds its own generators by the same rule and draws in the same
order, so both sides see the same samples; everything else it works out
itself. Layouts: images and activations NHWC; conv kernels OIHW; dense
kernels (in, out); transposed-conv kernels (k, k, in, out).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

SAMPLER_STREAM = 0x5A5A
Tree = Dict[str, Dict[str, torch.Tensor]]


def stream_seed(seed: int, step: int, stream: int) -> int:
    """The seed of one step's generator of one stream."""
    return ((seed * 1_000_003 + step) * 0x9E3779B1 + stream) % (1 << 63)


def step_generator(device, seed: int, step: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, step, stream))


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Float32 matmuls and convs in full float32 (TF32 off in cuBLAS and
    cuDNN) while the block runs, whatever the process had set, and the
    process's setting back after it; ``tf32`` allows TF32 instead (the
    control)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _same(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride: int = 1, padding: str = "SAME"):
    """TF-style conv of NHWC ``x`` with the OIHW kernel ``w``."""
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        top, bottom = _same(x.shape[1], w.shape[2], stride)
        left, right = _same(x.shape[2], w.shape[3], stride)
        xc = F.pad(xc, (left, right, top, bottom))
    return F.conv2d(xc, w, stride=stride).permute(0, 2, 3, 1)


def deconv(x, w, stride: int = 2):
    """A fractionally strided conv with SAME padding (out = in · stride):
    the input dilated by ``stride``, padded, and correlated with ``w`` (k,
    k, in, out), as ``lax.conv_transpose(..., transpose_kernel=False)``."""
    k = w.shape[0]
    n, h, wd, c = x.shape
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    pad_b = pad_len - pad_a
    xd = x.new_zeros(n, c, (h - 1) * stride + 1, (wd - 1) * stride + 1)
    xd[:, :, ::stride, ::stride] = x.permute(0, 3, 1, 2)
    xd = F.pad(xd, (pad_a, pad_b, pad_a, pad_b))
    return F.conv2d(xd, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def weight_norm(v, g, axes):
    norm = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True) + 1e-12)
    return v * (g.reshape(norm.shape) / norm)


def batch_norm(x, p, eps: float = 1e-3):
    """Batch norm over all axes but channels, with the batch's moments
    (biased variance)."""
    mean = x.mean(dim=(0, 1, 2))
    var = x.var(dim=(0, 1, 2), unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def noise(g, x, sigma: float):
    return x + sigma * torch.randn(x.shape, generator=g, device=x.device, dtype=x.dtype)


def dropout(g, x, rate: float):
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=g, device=x.device) < keep
    return x * (mask.to(x.dtype) * (1.0 / keep))


def planes(x, y1h):
    n, h, w, _ = x.shape
    return torch.cat([x, y1h[:, None, None, :].expand(n, h, w, y1h.shape[-1])], dim=-1)


# ---------------------------------------------------------------------------
# the three networks
# ---------------------------------------------------------------------------


def generator_fwd(P: Tree, z, y, sz: dict):
    """Images in [-1, 1] from latent codes and labels (train-mode batch
    norm): dense → s0×s0×W0, BN+ReLU, stride-2 deconvs with BN+ReLU, a
    weight-normed output deconv, tanh."""
    widths = sz["gen"]["widths"]
    s0 = sz["image_size"] // 2 ** len(widths)
    h = torch.cat([z, F.one_hot(y, sz["num_classes"]).float()], dim=-1) @ P["dense"]["w"] + P["dense"]["b"]
    h = torch.relu(batch_norm(h.reshape(-1, s0, s0, widths[0]), P["bn0"]))
    for i in range(len(widths) - 1):
        h = deconv(h, P[f"deconv{i}"]["w"]) + P[f"deconv{i}"]["b"]
        h = torch.relu(batch_norm(h, P[f"bn{i + 1}"]))
    out = P["deconv_out"]
    return torch.tanh(deconv(h, weight_norm(out["v"], out["g"], (0, 1, 2))) + out["b"])


def discriminator_fwd(P: Tree, x, y, sz: dict, g):
    """The logit that (x, y) is a real pair: label planes, input noise and
    dropout, weight-normed convs with leaky ReLU 0.2, dropout (and label
    planes again) after each stride-2 conv, global mean ⊕ label, a
    weight-normed dense head."""
    d = sz["disc"]
    y1h = F.one_hot(y, sz["num_classes"]).float()
    h = planes(x, y1h)
    h = dropout(g, noise(g, h, d["input_noise"]), d["input_dropout"])
    strides = d["strides"]
    for i, s in enumerate(strides):
        p = P[f"conv{i}"]
        h = conv(h, weight_norm(p["v"], p["g"], (1, 2, 3)), stride=s) + p["b"]
        h = F.leaky_relu(h, 0.2)
        if s == 2:
            h = dropout(g, h, d["block_dropout"])
            if d["label_reconcat"] and i + 1 < len(strides):
                h = planes(h, y1h)
    h = torch.cat([h.mean(dim=(1, 2)), y1h], dim=-1)
    head = P["head"]
    return (h @ weight_norm(head["v"], head["g"], (0,)) + head["b"])[:, 0]


def classifier_fwd(P: Tree, x, sz: dict, g):
    """Logits (train mode): input noise, conv blocks with BN + leaky ReLU
    0.1, each block ending in a 2×2 max pool and dropout, a 3×3 VALID conv
    and 1×1 convs with BN + leaky ReLU, global mean, dense head."""
    c = sz["clf"]

    def block(name, h, padding):
        h = conv(h, P[name]["w"], padding=padding)
        return F.leaky_relu(batch_norm(h, P[f"{name}_bn"]), 0.1)

    h = noise(g, x, c["input_noise"])
    for bi, widths in enumerate(c["conv_blocks"]):
        for ci in range(len(widths)):
            h = block(f"b{bi}c{ci}", h, "SAME")
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2, ceil_mode=True).permute(0, 2, 3, 1)
        h = dropout(g, h, c["block_dropout"])
    for ti in range(len(c["tail"])):
        h = block(f"t{ti}", h, "VALID" if ti == 0 else "SAME")
    return h.mean(dim=(1, 2)) @ P["head"]["w"] + P["head"]["b"]


# ---------------------------------------------------------------------------
# input transform and ZCA
# ---------------------------------------------------------------------------


def fit_zca(x_u8: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, W) of ZCA whitening fit on uint8 images rescaled to [-1, 1],
    in float64 on their device, returned in float32."""
    flat = x_u8.reshape(x_u8.shape[0], -1).double() / 127.5 - 1.0
    mean = flat.mean(dim=0)
    centered = flat - mean
    cov = centered.T @ centered / flat.shape[0]
    del flat, centered
    evals, evecs = torch.linalg.eigh(cov)
    w = (evecs * torch.rsqrt(evals.clamp_min(0.0) + eps)) @ evecs.T
    return mean.float(), w.float()


def whiten(x, zca):
    if zca is None:
        return x
    mean, w = zca
    return ((x.reshape(x.shape[0], -1) - mean) @ w.T).reshape(x.shape)


def preprocess(x_u8, zca, sz: dict, g):
    """uint8 → [-1, 1] → ZCA → a random shift within a reflect-padded
    border, then a random horizontal flip."""
    if not sz["rescale"] or sz["aug_order"] != "zca_first" or sz["aug_pad_mode"] != "reflect":
        raise ValueError("the reference follows rescale, aug_order zca_first and reflect padding only")
    x = whiten(x_u8.float() / 127.5 - 1.0, zca)
    n, h, w, _ = x.shape
    r = sz["aug_translate"]
    if r > 0:
        dy = torch.randint(0, 2 * r + 1, (n,), generator=g, device=x.device)
        dx = torch.randint(0, 2 * r + 1, (n,), generator=g, device=x.device)
        xp = F.pad(x.permute(0, 3, 1, 2), (r, r, r, r), mode="reflect").permute(0, 2, 3, 1)
        rows = dy[:, None] + torch.arange(h, device=x.device)[None, :]
        cols = dx[:, None] + torch.arange(w, device=x.device)[None, :]
        x = xp[torch.arange(n, device=x.device)[:, None, None], rows[:, :, None], cols[:, None, :]]
    if sz["aug_flip"]:
        flip = torch.rand(n, generator=g, device=x.device) < 0.5
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
    return x


# ---------------------------------------------------------------------------
# the three-player step
# ---------------------------------------------------------------------------


def draw_batch(g, data, b: int, sz: dict):
    """One step's sub-batches: streams "d" and "c" (labeled and unlabeled
    images, latent codes and their labels), stream "g" (codes, labels)."""
    dev = data["x_u"].device

    def codes():
        return {"z": torch.randn((b, sz["z_dim"]), generator=g, device=dev),
                "y_g": torch.randint(0, sz["num_classes"], (b,), generator=g, device=dev)}

    def stream():
        il = torch.randint(0, data["x_l"].shape[0], (b,), generator=g, device=dev)
        iu = torch.randint(0, data["x_u"].shape[0], (b,), generator=g, device=dev)
        return {"x_l": data["x_l"][il], "y_l": data["y_l"][il], "x_u": data["x_u"][iu], **codes()}

    return {"d": stream(), "c": stream(), "g": codes()}


def log_sig(x):
    return F.logsigmoid(x)


def ce(logits, y):
    return -torch.mean(F.log_softmax(logits, dim=-1).gather(1, y[:, None])[:, 0])


def pseudo_labels(g, logits):
    u = torch.rand(logits.shape, generator=g, device=logits.device).clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.detach() - torch.log(-torch.log(u)), dim=-1)


def _leaves(tree: Tree) -> List[torch.Tensor]:
    return [t for arrays in tree.values() for t in arrays.values()]


def _grad(loss, tree: Tree) -> Tree:
    flat = torch.autograd.grad(loss, _leaves(tree))
    it = iter(flat)
    return {layer: {k: next(it) for k in arrays} for layer, arrays in tree.items()}


def _with_grad(tree: Tree) -> Tree:
    return {layer: {k: t.detach().clone().requires_grad_(True) for k, t in arrays.items()}
            for layer, arrays in tree.items()}


class Adam:
    """Adam with β1, β2, ε outside the square root, bias correction at the
    1-based count, the learning rate held where the schedule holds it
    (the step's count lies before the decay starts)."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: Tree):
        return {"count": 0, "mu": {l: {k: torch.zeros_like(t) for k, t in a.items()} for l, a in params.items()},
                "nu": {l: {k: torch.zeros_like(t) for k, t in a.items()} for l, a in params.items()}}

    def update(self, params: Tree, grads: Tree, st: dict):
        t = st["count"] + 1
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        mu, nu, new = {}, {}, {}
        with torch.no_grad():
            for layer, arrays in params.items():
                mu[layer], nu[layer], new[layer] = {}, {}, {}
                for k, p in arrays.items():
                    g = grads[layer][k]
                    m = (1.0 - self.b1) * g + self.b1 * st["mu"][layer][k]
                    v = (1.0 - self.b2) * g * g + self.b2 * st["nu"][layer][k]
                    mu[layer][k], nu[layer][k] = m, v
                    new[layer][k] = p.detach() - self.lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps))
        return new, {"count": t, "mu": mu, "nu": nu}


def alpha_p_at(step: int, sz: dict, steps_per_epoch: int) -> float:
    warm = sz["alpha_p_warmup_epochs"] * steps_per_epoch
    ramp = sz["alpha_p_ramp_epochs"] * steps_per_epoch
    if ramp <= 0:
        return sz["alpha_p"] if step >= warm else 0.0
    return sz["alpha_p"] * min(max((step - warm) / ramp, 0.0), 1.0)


def train_steps(P: Dict[str, Tree], data, zca, sz: dict, seed: int, start_step: int, n_steps: int,
                tf32: bool = False):
    """``n_steps`` three-player updates from ``P`` at step ``start_step``,
    in float32 with TF32 off (``tf32``: allowed, the control). Returns
    {"losses": [(loss_d, loss_g, loss_c) a step], "grads": the first
    step's gradients, "mu": each Adam's first moment after the steps,
    "params": the parameters after them}."""
    with precision(tf32):
        return _train_steps(P, data, zca, sz, seed, start_step, n_steps)


def _train_steps(P, data, zca, sz, seed, start_step, n_steps):
    b, alpha = sz["batch_size"], sz["alpha"]
    steps_per_epoch = max(data["x_u"].shape[0] // b, 1)
    opts = {p: Adam(sz[f"lr_{k}"], sz["adam_b1"], sz["adam_b2"], sz["adam_eps"])
            for p, k in (("gen", "g"), ("disc", "d"), ("clf", "c"))}
    total = sz["epochs"] * steps_per_epoch
    if start_step + n_steps > int(sz["lr_decay_start_frac"] * total) or sz["lr_c_anneal_factor"] != 1.0:
        raise ValueError("the reference holds each learning rate constant: the steps lie before the decay")
    opt_state = {p: opts[p].init(P[p]) for p in P}
    P = {p: {l: {k: t.detach() for k, t in a.items()} for l, a in tree.items()} for p, tree in P.items()}
    losses, first = [], None
    dev = data["x_u"].device
    for i in range(n_steps):
        step = start_step + i
        a_p = alpha_p_at(step, sz, steps_per_epoch)
        g = step_generator(dev, seed, step, 0)
        batch = draw_batch(step_generator(dev, seed, step, SAMPLER_STREAM), data, b, sz)

        # D's update, with G and C as they are
        bd = batch["d"]
        x_l, x_u = preprocess(bd["x_l"], zca, sz, g), preprocess(bd["x_u"], zca, sz, g)
        with torch.no_grad():
            x_g = whiten(generator_fwd(P["gen"], bd["z"], bd["y_g"], sz), zca)
            y_c = pseudo_labels(g, classifier_fwd(P["clf"], x_u, sz, g))
        pd = _with_grad(P["disc"])
        logits = discriminator_fwd(pd, torch.cat([x_l, x_u, x_g]), torch.cat([bd["y_l"], y_c, bd["y_g"]]), sz, g)
        l_real, l_cla, l_gen = logits[:b], logits[b:2 * b], logits[2 * b:]
        loss_d = -log_sig(l_real).mean() - alpha * log_sig(-l_cla).mean() - (1 - alpha) * log_sig(-l_gen).mean()
        grad_d = _grad(loss_d, pd)
        P["disc"], opt_state["disc"] = opts["disc"].update(P["disc"], grad_d, opt_state["disc"])

        # G's update, scored by the new D
        bg = batch["g"]
        pg = _with_grad(P["gen"])
        logit_g = discriminator_fwd(P["disc"], whiten(generator_fwd(pg, bg["z"], bg["y_g"], sz), zca),
                                    bg["y_g"], sz, g)
        loss_g = -(1 - alpha) * log_sig(logit_g).mean()
        grad_g = _grad(loss_g, pg)
        P["gen"], opt_state["gen"] = opts["gen"].update(P["gen"], grad_g, opt_state["gen"])

        # C's update, seeing the new D and G
        bc = batch["c"]
        x_l, x_u = preprocess(bc["x_l"], zca, sz, g), preprocess(bc["x_u"], zca, sz, g)
        with torch.no_grad():
            x_g = whiten(generator_fwd(P["gen"], bc["z"], bc["y_g"], sz), zca)
        pc = _with_grad(P["clf"])
        log_l = classifier_fwd(pc, x_l, sz, g)
        log_u = classifier_fwd(pc, x_u, sz, g)
        log_g = classifier_fwd(pc, x_g, sz, g)
        y_c = pseudo_labels(g, log_u)
        with torch.no_grad():
            w = log_sig(-discriminator_fwd(P["disc"], x_u, y_c, sz, g))
        logp_u = F.log_softmax(log_u, dim=-1).gather(1, y_c[:, None])[:, 0]
        loss_c = ce(log_l, bc["y_l"]) + alpha * torch.mean((w - w.mean()) * logp_u) + a_p * ce(log_g, bc["y_g"])
        grad_c = _grad(loss_c, pc)
        P["clf"], opt_state["clf"] = opts["clf"].update(P["clf"], grad_c, opt_state["clf"])

        losses.append((float(loss_d.detach()), float(loss_g.detach()), float(loss_c.detach())))
        if first is None:
            first = {"gen": grad_g, "disc": grad_d, "clf": grad_c}
    return {"losses": losses, "grads": first, "mu": {p: s["mu"] for p, s in opt_state.items()}, "params": P}


# ---------------------------------------------------------------------------
# weights from the seed
# ---------------------------------------------------------------------------


def layout(sz: dict) -> Dict[str, Dict[str, Dict[str, Tuple[Tuple[int, ...], str]]]]:
    """Every array of the three players: {player: {layer: {array: (shape,
    init)}}}, init one of "normal" (std 0.05), "one", "zero", and, for
    batch-norm running statistics, "run_mean", "run_var"."""
    nc, ch, s = sz["num_classes"], sz["channels"], sz["image_size"]
    out: Dict[str, Dict[str, Dict[str, Tuple[Tuple[int, ...], str]]]] = {"gen": {}, "disc": {}, "clf": {}}

    def bn(player, name, width):
        out[player][name] = {"scale": ((width,), "one"), "bias": ((width,), "zero"),
                             "mean": ((width,), "run_mean"), "var": ((width,), "run_var")}

    gw, k = sz["gen"]["widths"], sz["gen"]["kernel"]
    s0 = s // 2 ** len(gw)
    out["gen"]["dense"] = {"w": ((sz["z_dim"] + nc, s0 * s0 * gw[0]), "normal"), "b": ((s0 * s0 * gw[0],), "zero")}
    bn("gen", "bn0", gw[0])
    for i in range(len(gw) - 1):
        out["gen"][f"deconv{i}"] = {"w": ((k, k, gw[i], gw[i + 1]), "normal"), "b": ((gw[i + 1],), "zero")}
        bn("gen", f"bn{i + 1}", gw[i + 1])
    out["gen"]["deconv_out"] = {"v": ((k, k, gw[-1], ch), "normal"), "g": ((ch,), "one"), "b": ((ch,), "zero")}

    d = sz["disc"]
    cin = ch + nc
    for i, (w, st) in enumerate(zip(d["widths"], d["strides"])):
        out["disc"][f"conv{i}"] = {"v": ((w, cin, 3, 3), "normal"), "g": ((w,), "one"), "b": ((w,), "zero")}
        cin = w + (nc if st == 2 and d["label_reconcat"] and i + 1 < len(d["widths"]) else 0)
    out["disc"]["head"] = {"v": ((d["widths"][-1] + nc, 1), "normal"), "g": ((1,), "one"), "b": ((1,), "zero")}

    c = sz["clf"]
    cin = ch
    for bi, widths in enumerate(c["conv_blocks"]):
        for ci, w in enumerate(widths):
            out["clf"][f"b{bi}c{ci}"] = {"w": ((w, cin, 3, 3), "normal")}
            bn("clf", f"b{bi}c{ci}_bn", w)
            cin = w
    for ti, w in enumerate(c["tail"]):
        kk = 3 if ti == 0 else 1
        out["clf"][f"t{ti}"] = {"w": ((w, cin, kk, kk), "normal")}
        bn("clf", f"t{ti}_bn", w)
        cin = w
    out["clf"]["head"] = {"w": ((cin, nc), "normal"), "b": ((nc,), "zero")}
    return out


RUNNING = ("mean", "var")


def make_weights(sz: dict, seed: int, device) -> Tuple[Dict[str, Tree], Dict[str, Tree]]:
    """(params, running stats) of the three players from ``seed``, made on
    ``device`` in two draws: one normal draw for every kernel, one uniform
    draw for the running statistics."""
    lay = layout(sz)
    normal = [(p, l, a, shape) for p, layers in lay.items() for l, arrays in layers.items()
              for a, (shape, init) in arrays.items() if init == "normal"]
    running = [(p, l, a, shape) for p, layers in lay.items() for l, arrays in layers.items()
               for a, (shape, init) in arrays.items() if init in ("run_mean", "run_var")]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat_n = 0.05 * torch.randn(sum(math.prod(s) for *_, s in normal), generator=gen, device=device)
    flat_r = torch.rand(sum(math.prod(s) for *_, s in running), generator=gen, device=device)
    params: Dict[str, Tree] = {p: {} for p in lay}
    stats: Dict[str, Tree] = {p: {} for p in lay}
    at = 0
    for p, l, a, shape in normal:
        n = math.prod(shape)
        params[p].setdefault(l, {})[a] = flat_n[at:at + n].reshape(shape).clone()
        at += n
    at = 0
    for p, l, a, shape in running:
        n = math.prod(shape)
        u = flat_r[at:at + n].reshape(shape)
        stats[p].setdefault(l, {})[a] = (0.1 * (2.0 * u - 1.0) * math.sqrt(3.0) if a == "mean"
                                         else 0.5 + 1.5 * u).clone()
        at += n
    for p, layers in lay.items():
        for l, arrays in layers.items():
            for a, (shape, init) in arrays.items():
                if init in ("one", "zero"):
                    params[p].setdefault(l, {})[a] = (torch.ones if init == "one" else torch.zeros)(
                        shape, device=device)
    return params, stats
