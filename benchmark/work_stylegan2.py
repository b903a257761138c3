"""The work one Triple-GAN train step with the StyleGAN2 pair as G and D
needs (configuration ``cifar10_stylegan2``), counted from the sizes: the
yardstick behind ``step_mfu.train_stylegan2``, ``conv_roofline.
train_stylegan2``, ``modulation_roofline.train_stylegan2`` and
``epilogue_roofline.train_stylegan2``.

The model as published, its products counted as ``work.Call`` counts them,
C's layers ``work.networks``'s. G: the class embedding and the mapping's
dense layers, every layer's affine (w → its style), each modulated 3×3
conv, each up-conv as the stride-2 transposed conv it is (its FIR filter,
like the demodulation, the modulation, the noise and every activation, is
elementwise work, which ``work.py`` does not count), each ToRGB 1×1 conv.
D: fromRGB, per block a 3×3 conv and the stride-2 3×3 conv, at 4×4 the
3×3 conv of the 513 channels and the two dense layers, and the label
mapping ``cmap``.

The passes are ``work.passes``'s at the batch of 64: a layer's backward
takes a filter gradient where its weights take one, an input gradient
where an earlier layer's weights or the input take one (G's learned
constant takes one, so all of G's convs do); in a pass where only D's
input takes a gradient D's label mapping takes none. A step whose number
is a multiple of ``r1_interval`` adds D's R1 update: D's forward over the
64 real pairs, the input gradient of every layer between the input and the
logit, and the penalty's gradient, which takes for each such layer a
product of the cotangent by its kernel and a filter gradient (forward
sized), and for the label mapping a backward; amortised over the interval.
Every 3×3 stride-1 conv runs on the hand-written conv kernels; the
transposed and the stride-2 convs on cuDNN.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import work

Layer, Call = work.Layer, work.Call


def networks(sz: dict) -> Dict[str, List[Layer]]:
    """G's and D's layers with weights, in order (D's label mapping last),
    and C's (``work.py``)."""
    nc, ch, s = sz["num_classes"], sz["channels"], sz["image_size"]
    g, d = sz["gen"], sz["disc"]
    wd = g["w_dim"]
    gen = [Layer("dense", "embed", 1, 1, 1, 1, nc, wd, False, False)]
    gen += [Layer("dense", f"map{i}", 1, 1, 1, 1, sz["z_dim"] + wd if i == 0 else wd, wd, False, False)
            for i in range(g["map_layers"])]
    cin = g["widths"][0]
    for i, w in enumerate(g["widths"]):
        res = 4 * 2 ** i
        if res > 4:
            gen += [Layer("dense", f"b{res}_conv0.affine", 1, 1, 1, 1, wd, cin, False, False),
                    Layer("deconv", f"b{res}_conv0", 3, 2, res // 2, res, cin, w, False, True)]
        gen += [Layer("dense", f"b{res}_conv1.affine", 1, 1, 1, 1, wd, w, False, False),
                Layer("conv", f"b{res}_conv1", 3, 1, res, res, w, w, True, True),
                Layer("dense", f"b{res}_torgb.affine", 1, 1, 1, 1, wd, w, False, False),
                Layer("conv", f"b{res}_torgb", 1, 1, res, res, w, ch, False, False)]
        cin = w

    dw = d["widths"]
    disc = [Layer("conv", f"b{s}_fromrgb", 1, 1, s, s, ch, dw[0], False, True)]
    res = s
    for i in range(len(dw) - 1):
        disc += [Layer("conv", f"b{res}_conv0", 3, 1, res, res, dw[i], dw[i], True, True),
                 Layer("conv", f"b{res}_conv1", 3, 2, res, res // 2, dw[i], dw[i + 1], False, True)]
        res //= 2
    c4 = dw[-1]
    disc += [Layer("conv", "b4_conv", 3, 1, 4, 4, c4 + d["mbstd_channels"], c4, True, True),
             Layer("dense", "b4_fc", 1, 1, 1, 1, 16 * c4, c4, False, False),
             Layer("dense", "b4_out", 1, 1, 1, 1, c4, d["cmap_dim"], False, False)]
    return {"gen": gen, "disc": disc, "cmap": cmap_layers(sz), "clf": work.networks(sz)["clf"]}


def cmap_layers(sz: dict) -> List[Layer]:
    d = sz["disc"]
    return ([Layer("dense", "cmap_embed", 1, 1, 1, 1, sz["num_classes"], d["cmap_dim"], False, False)]
            + [Layer("dense", f"cmap{i}", 1, 1, 1, 1, d["cmap_dim"], d["cmap_dim"], False, False)
               for i in range(d["map_layers"])])


# the layers that read their network's input (images, codes or labels)
INPUT_LAYERS = {"gen": {"embed"}, "cmap": {"cmap_embed"}, "clf": {"b0c0"}}  # D's: its fromRGB


def _backward(calls, layers, input_layers, n, grad_w, grad_x):
    for layer in layers:
        calls.append(Call(layer, "fwd", n))
        if grad_w:
            calls.append(Call(layer, "wgrad", n))
        if grad_x or (grad_w and layer.name not in input_layers):
            calls.append(Call(layer, "dgrad", n))


def step_calls(sz: dict) -> List[Call]:
    """Every product of a step without R1: each layer's forward, its filter
    gradient where its weights take one, its input gradient where an
    earlier layer's weights or the input take one."""
    nets = networks(sz)
    calls: List[Call] = []
    for net, n, grad_w, grad_x in work.passes(sz):
        inputs = {f"b{sz['image_size']}_fromrgb"} if net == "disc" else INPUT_LAYERS[net]
        _backward(calls, nets[net], inputs, n, grad_w, grad_x)
        if net == "disc":  # the label mapping: a backward where D's weights take gradients
            _backward(calls, nets["cmap"], INPUT_LAYERS["cmap"], n, grad_w, False)
    return calls


def r1_calls(sz: dict) -> List[Call]:
    """The products of one R1 update of D at the batch's rows: D's forward,
    the input gradient of each layer on the path from the image to the
    logit, then for each of those a product of the cotangent by its kernel
    ("fwd") and a filter gradient; the label mapping's forward and
    backward."""
    nets = networks(sz)
    n = sz["batch_size"]
    calls: List[Call] = []
    for layer in nets["disc"]:
        calls += [Call(layer, "fwd", n), Call(layer, "dgrad", n), Call(layer, "fwd", n), Call(layer, "wgrad", n)]
    _backward(calls, nets["cmap"], INPUT_LAYERS["cmap"], n, True, False)
    return calls


def step_flops(sz: dict) -> float:
    """Model FLOPs of a step, R1's amortised over its interval."""
    d = sz["image_size"] ** 2 * sz["channels"]
    fwd, bwd = work.zca_products(sz)
    r1 = sum(c.flops() for c in r1_calls(sz)) / sz["r1_interval"]
    return sum(c.flops() for c in step_calls(sz)) + r1 + 2.0 * (fwd + bwd) * d * d


def _least(c: Call, sz: dict, peaks: dict) -> float:
    dt = sz["compute_dtype"]
    return max(c.flops() / peaks["flops_per_s"][dt], c.bytes(work.DTYPE_BYTES[dt]) / peaks["bytes_per_s"])


def conv3x3_least_s(sz: dict, peaks: dict) -> float:
    """``work.conv3x3_least_s`` over a step's calls, R1's amortised."""
    plain = sum(_least(c, sz, peaks) for c in step_calls(sz) if c.layer.conv3x3)
    r1 = sum(_least(c, sz, peaks) for c in r1_calls(sz) if c.layer.conv3x3)
    return plain + r1 / sz["r1_interval"]


def modulation_calls(sz: dict) -> Tuple[List[int], List[int]]:
    """(elements of each forward of the modulation's kernels, of each
    backward) in one step. In each G pass: the epilogue of each modulated
    3×3 conv (each G block's conv1, and its up-conv conv0 above 4×4), and
    the input scale x ⊙ s of each modulated conv and of each ToRGB (x the
    layer's input: the up-conv's at half the block's size and the width
    below). A backward of each in the passes where G's weights take a
    gradient."""
    sizes, cin = [], sz["gen"]["widths"][0]
    for i, w in enumerate(sz["gen"]["widths"]):
        res = 4 * 2 ** i
        if res > 4:
            sizes += [res * res * w, (res // 2) ** 2 * cin]  # conv0's epilogue, its input scale
        sizes += [res * res * w] * 3  # conv1's epilogue, its input scale, ToRGB's input scale
        cin = w
    fwd, bwd = [], []
    for net, n, grad_w, _ in work.passes(sz):
        if net == "gen":
            fwd += [n * e for e in sizes]
            if grad_w:
                bwd += [n * e for e in sizes]
    return fwd, bwd


def modulation_least_s(sz: dict, peaks: dict) -> float:
    """The least time of a step's modulation kernels: a forward reads x
    and writes y, a backward reads x and the cotangent and writes dx (the
    scales, the bias and the noise term are a sample's C values or a
    plane, left out)."""
    nb = work.DTYPE_BYTES[sz["compute_dtype"]]
    fwd, bwd = modulation_calls(sz)
    return (2 * sum(fwd) + 3 * sum(bwd)) * nb / peaks["bytes_per_s"]


def _epilogue_sizes(sz: dict, net: str, n: int) -> List[int]:
    return [n * l.h_out * l.h_out * l.c_out for l in networks(sz)[net] if l.epilogue and l.kind == "conv"]


def epilogue_calls(sz: dict) -> Tuple[List[int], List[int]]:
    """(elements of each per-channel epilogue forward, of each backward)
    in one step without R1: D's conv layers' (fromRGB, each block's two
    convs, the 4×4 conv) and C's, in every pass through D or C; a backward
    in the passes that carry a gradient."""
    fwd, bwd = [], []
    for net, n, grad_w, grad_x in work.passes(sz):
        if net != "gen":
            sizes = _epilogue_sizes(sz, net, n)
            fwd += sizes
            if grad_w or grad_x:
                bwd += sizes
    return fwd, bwd


def r1_epilogue_calls(sz: dict) -> Tuple[List[int], List[int]]:
    """The same of one R1 update: D's forward at the batch's rows, and two
    backwards of each of its epilogues (the input gradient, recorded, and
    the penalty's gradient through the forward again)."""
    sizes = _epilogue_sizes(sz, "disc", sz["batch_size"])
    return sizes, sizes * 2


def epilogue_least_s(sz: dict, peaks: dict) -> float:
    """The least time of a step's per-channel epilogues, R1's amortised
    over its interval, counted as ``modulation_least_s`` counts."""
    nb = work.DTYPE_BYTES[sz["compute_dtype"]]
    fwd, bwd = epilogue_calls(sz)
    r1_fwd, r1_bwd = r1_epilogue_calls(sz)
    plain = 2 * sum(fwd) + 3 * sum(bwd)
    r1 = 2 * sum(r1_fwd) + 3 * sum(r1_bwd)
    return (plain + r1 / sz["r1_interval"]) * nb / peaks["bytes_per_s"]
