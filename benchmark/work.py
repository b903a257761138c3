"""The work one Triple-GAN train step needs, counted from the configuration's
sizes: the yardstick behind every roofline share and ``mfu``.

A step is three updates. D's: G and C forwards without gradient, D's
forward over the 3B rows of (labeled, pseudo-labeled, generated) pairs and
its backward. G's: G's forward, D's forward on the new images, and the
backward through both (D's weights take no gradient). C's: G's forward
without gradient, three C forwards (labeled, unlabeled, generated) with
their backwards, and D's forward on the pseudo-labeled pairs. A layer's
backward computes the filter gradient where its own weights take one, and
the input gradient where some earlier layer's weights or the input itself
take one. Nothing is recomputed.

Operations are the model's: a conv 2·n·h_out·w_out·c_out·k²·c_in, a
transposed conv 2·n·h_in·w_in·c_in·c_out·k², a dense or ZCA product
2·n·in·out; each backward product as much as its forward. Bytes are each
input read once and each output written once.

The shipped path runs every 3×3 stride-1 conv (D's stride-1 convs, C's 3×3
convs, and G's stride-2 transposed convs, which it computes as 3×3 phase
convs) through the hand-written conv kernels, and every activation
epilogue act(x·k + b) through the hand-written epilogue kernels; the
``kernel`` field of a call names which.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


@dataclasses.dataclass(frozen=True)
class Layer:
    kind: str        # "conv", "deconv", "dense"
    name: str
    k: int
    stride: int
    h_in: int        # spatial size of the input (dense: 1)
    h_out: int
    c_in: int
    c_out: int
    conv3x3: bool    # run by the hand-written 3×3 conv kernels
    epilogue: bool   # followed by an epilogue kernel call on its output


@dataclasses.dataclass(frozen=True)
class Call:
    layer: Layer
    role: str        # "fwd", "dgrad", "wgrad"
    n: int

    def flops(self) -> float:
        l = self.layer
        if l.kind == "dense":
            return 2.0 * self.n * l.c_in * l.c_out
        if l.kind == "deconv":
            return 2.0 * self.n * l.h_in * l.h_in * l.c_in * l.c_out * l.k * l.k
        return 2.0 * self.n * l.h_out * l.h_out * l.c_out * l.k * l.k * l.c_in

    def bytes(self, act_bytes: int) -> float:
        l = self.layer
        x = self.n * l.h_in * l.h_in * l.c_in * act_bytes
        y = self.n * l.h_out * l.h_out * l.c_out * act_bytes
        w = l.k * l.k * l.c_in * l.c_out
        if self.role == "wgrad":
            return x + y + 4 * w            # reads x and the cotangent, writes a float32 filter gradient
        return x + y + w * act_bytes        # fwd: x, w → y; dgrad: cotangent, w → dx


def networks(sz: dict) -> Dict[str, List[Layer]]:
    """Each network's layers with weights, in order."""
    nc, ch, s = sz["num_classes"], sz["channels"], sz["image_size"]
    gw, gk = sz["gen"]["widths"], sz["gen"]["kernel"]
    s0 = s // 2 ** len(gw)
    gen = [Layer("dense", "dense", 1, 1, 1, 1, sz["z_dim"] + nc, s0 * s0 * gw[0], False, False)]
    h = s0
    for i in range(len(gw) - 1):
        gen.append(Layer("deconv", f"deconv{i}", gk, 2, h, 2 * h, gw[i], gw[i + 1], True, False))
        h *= 2
    gen.append(Layer("deconv", "deconv_out", gk, 2, h, 2 * h, gw[-1], ch, True, True))

    d = sz["disc"]
    disc, h, cin = [], s, ch + nc
    for i, (w, st) in enumerate(zip(d["widths"], d["strides"])):
        ho = -(-h // st)
        disc.append(Layer("conv", f"conv{i}", 3, st, h, ho, cin, w, st == 1, True))
        h, cin = ho, w + (nc if st == 2 and d["label_reconcat"] and i + 1 < len(d["widths"]) else 0)
    disc.append(Layer("dense", "head", 1, 1, 1, 1, d["widths"][-1] + nc, 1, False, False))

    c = sz["clf"]
    clf, h, cin = [], s, ch
    for bi, widths in enumerate(c["conv_blocks"]):
        for ci, w in enumerate(widths):
            clf.append(Layer("conv", f"b{bi}c{ci}", 3, 1, h, h, cin, w, True, True))
            cin = w
        h = -(-h // 2)
    for ti, w in enumerate(c["tail"]):
        k = 3 if ti == 0 else 1
        ho = h - 2 if ti == 0 else h
        clf.append(Layer("conv", f"t{ti}", k, 1, h, ho, cin, w, k == 3, True))
        h, cin = ho, w
    clf.append(Layer("dense", "head", 1, 1, 1, 1, cin, nc, False, False))
    return {"gen": gen, "disc": disc, "clf": clf}


def _gen_epilogue_sizes(sz: dict, n: int) -> List[int]:
    """Elements of each of G's epilogue calls: the dense's batch norm, each
    deconv's batch norm, the output deconv's weight-norm tanh."""
    gw, s = sz["gen"]["widths"], sz["image_size"]
    s0 = s // 2 ** len(gw)
    sizes, h = [n * s0 * s0 * gw[0]], s0
    for w in gw[1:]:
        h *= 2
        sizes.append(n * h * h * w)
    sizes.append(n * s * s * sz["channels"])
    return sizes


def passes(sz: dict) -> List[Tuple[str, int, bool, bool]]:
    """(network, rows, weights take a gradient, input takes a gradient),
    every forward pass of one step in order."""
    b = sz["batch_size"]
    if sz["share_pseudo_forward"] or sz["fused_clf_forward"]:
        raise ValueError("counted: the shipped step, without a shared or fused C pass")
    return [("gen", b, False, False), ("clf", b, False, False), ("disc", 3 * b, True, False),
            ("gen", b, True, False), ("disc", b, False, True),
            ("gen", b, False, False), ("clf", b, True, False), ("clf", b, True, False), ("clf", b, True, False),
            ("disc", b, False, False)]


def step_calls(sz: dict) -> List[Call]:
    """Every product of one step: each layer's forward, and its filter and
    input gradients where they are needed."""
    nets = networks(sz)
    calls: List[Call] = []
    for net, n, grad_w, grad_x in passes(sz):
        for i, layer in enumerate(nets[net]):
            calls.append(Call(layer, "fwd", n))
            if grad_w:
                calls.append(Call(layer, "wgrad", n))
            if grad_x or (grad_w and i > 0):
                calls.append(Call(layer, "dgrad", n))
    return calls


def zca_products(sz: dict) -> Tuple[int, int]:
    """(rows through the ZCA product forward, rows through its input
    gradient) in one step: four preprocessed image batches and three
    whitened generator batches, the G update's with its gradient."""
    if not sz["zca"]:
        return 0, 0
    b = sz["batch_size"]
    return 7 * b, b


def step_flops(sz: dict) -> float:
    d = sz["image_size"] ** 2 * sz["channels"]
    fwd, bwd = zca_products(sz)
    return sum(c.flops() for c in step_calls(sz)) + 2.0 * (fwd + bwd) * d * d


def epilogue_calls(sz: dict) -> Tuple[List[int], List[int]]:
    """(elements of each epilogue forward call, of each backward call) in
    one step. A pass that carries a gradient takes a backward through each
    of its epilogues."""
    nets = networks(sz)
    fwd, bwd = [], []
    for net, n, grad_w, grad_x in passes(sz):
        if net == "gen":
            sizes = _gen_epilogue_sizes(sz, n)
        else:
            sizes = [n * l.h_out * l.h_out * l.c_out for l in nets[net] if l.epilogue]
        fwd += sizes
        if grad_w or grad_x:
            bwd += sizes
    return fwd, bwd


def conv3x3_least_s(sz: dict, peaks: dict) -> float:
    """The least time of a step's 3×3 stride-1 conv work (forward, input
    gradient, filter gradient): each call's operations over the dtype's
    peak or its bytes over the memory's, whichever is larger, summed."""
    dt = sz["compute_dtype"]
    nb = DTYPE_BYTES[dt]
    return sum(max(c.flops() / peaks["flops_per_s"][dt], c.bytes(nb) / peaks["bytes_per_s"])
               for c in step_calls(sz) if c.layer.conv3x3)


def epilogue_least_s(sz: dict, peaks: dict) -> float:
    """The least time of a step's epilogue work: a forward reads x and
    writes y, a backward reads x and the cotangent and writes dx."""
    nb = DTYPE_BYTES[sz["compute_dtype"]]
    fwd, bwd = epilogue_calls(sz)
    return (2 * sum(fwd) + 3 * sum(bwd)) * nb / peaks["bytes_per_s"]


def launches(sz: dict) -> Dict[str, int]:
    """The hand-written kernels' calls a step: conv forwards (input
    gradients run on the forward kernel, so they count here), filter
    gradients, epilogue forwards and backwards."""
    calls = [c for c in step_calls(sz) if c.layer.conv3x3]
    fwd, bwd = epilogue_calls(sz)
    return {"conv_fwd": sum(c.role != "wgrad" for c in calls), "conv_wgrad": sum(c.role == "wgrad" for c in calls),
            "epilogue_fwd": len(fwd), "epilogue_bwd": len(bwd)}
