"""The work one Triple-GAN train step with the SN-ResNet pair as G and D
needs (configuration ``cifar10_snresnet``), counted from the sizes: the
yardstick behind ``step_mfu.train_snresnet``, ``conv_roofline.
train_snresnet`` and ``cbn_roofline.train_snresnet``.

The step's passes are ``work.passes``'s, its products counted as
``work.Call`` counts them, C's layers are ``work.networks``'s. G: the
dense ``l1``, then per up-block two 3×3 convs at the upsampled size and a
1×1 shortcut conv, then the 3×3 conv to RGB. D: per block two 3×3 convs
and, where the block pools or widens, a 1×1 shortcut conv (the first
block's on the pooled image, block 2's before its pool), then the dense
``l5``. The projection ⟨embed(y), h⟩, the poolings, the power iterations
and the batch norms are not counted, as ``work.py`` counts no
elementwise work. A layer that reads the network's input takes no input
gradient in a pass whose input takes none (in D both the first conv and
the first shortcut do).

Every 3×3 stride-1 conv runs on the hand-written conv kernels. The
class-conditional batch norms run on the per-sample epilogue kernel
(``cbn_*``): one forward per norm and pass, and a backward in G's own
update.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import work

Layer, Call = work.Layer, work.Call


def networks(sz: dict) -> Dict[str, List[Layer]]:
    """G's and D's layers with weights, in order, and C's (``work.py``)."""
    nc, ch, s = sz["num_classes"], sz["channels"], sz["image_size"]
    gw = sz["gen"]["widths"]
    s0 = s // 2 ** len(gw)
    gen = [Layer("dense", "l1", 1, 1, 1, 1, sz["z_dim"], s0 * s0 * gw[0], False, False)]
    h, cin = s0, gw[0]
    for i, w in enumerate(gw):
        blk = f"block{i + 2}"
        gen += [Layer("conv", f"{blk}_c1", 3, 1, 2 * h, 2 * h, cin, w, True, False),
                Layer("conv", f"{blk}_c2", 3, 1, 2 * h, 2 * h, w, w, True, False),
                Layer("conv", f"{blk}_c_sc", 1, 1, 2 * h, 2 * h, cin, w, False, False)]
        h, cin = 2 * h, w
    gen.append(Layer("conv", "c5", 3, 1, h, h, cin, ch, True, True))

    d = sz["disc"]
    disc, h, cin = [], s, ch
    for i, (w, st) in enumerate(zip(d["widths"], d["strides"])):
        blk = f"block{i + 1}"
        disc += [Layer("conv", f"{blk}_c1", 3, 1, h, h, cin, w, True, True),
                 Layer("conv", f"{blk}_c2", 3, 1, h, h, w, w, True, True)]
        if i == 0:
            disc.append(Layer("conv", f"{blk}_c_sc", 1, 1, h // st, h // st, cin, w, False, True))
        elif cin != w or st == 2:
            disc.append(Layer("conv", f"{blk}_c_sc", 1, 1, h, h, cin, w, False, True))
        h, cin = h // st, w
    disc.append(Layer("dense", "l5", 1, 1, 1, 1, cin, 1, False, False))
    return {"gen": gen, "disc": disc, "clf": work.networks(sz)["clf"]}


# the layers that read their network's input
INPUT_LAYERS = {"gen": {"l1"}, "disc": {"block1_c1", "block1_c_sc"}, "clf": {"b0c0"}}


def step_calls(sz: dict) -> List[Call]:
    """Every product of one step: each layer's forward, its filter gradient
    where its weights take one, its input gradient where an earlier layer's
    weights or the input take one."""
    nets = networks(sz)
    calls: List[Call] = []
    for net, n, grad_w, grad_x in work.passes(sz):
        for layer in nets[net]:
            calls.append(Call(layer, "fwd", n))
            if grad_w:
                calls.append(Call(layer, "wgrad", n))
            if grad_x or (grad_w and layer.name not in INPUT_LAYERS[net]):
                calls.append(Call(layer, "dgrad", n))
    return calls


def step_flops(sz: dict) -> float:
    d = sz["image_size"] ** 2 * sz["channels"]
    fwd, bwd = work.zca_products(sz)
    return sum(c.flops() for c in step_calls(sz)) + 2.0 * (fwd + bwd) * d * d


def conv3x3_least_s(sz: dict, peaks: dict) -> float:
    """``work.conv3x3_least_s`` over this step's calls."""
    dt = sz["compute_dtype"]
    nb = work.DTYPE_BYTES[dt]
    return sum(max(c.flops() / peaks["flops_per_s"][dt], c.bytes(nb) / peaks["bytes_per_s"])
               for c in step_calls(sz) if c.layer.conv3x3)


def cbn_calls(sz: dict) -> Tuple[List[int], List[int]]:
    """(elements of each per-sample epilogue forward, of each backward) in
    one step: G's two class-conditional norms a block (on the block's input,
    then on its first conv's upsampled output), in each G pass; a backward
    in the passes where G's weights take a gradient."""
    gw = sz["gen"]["widths"]
    h, cin, sizes = sz["image_size"] // 2 ** len(gw), gw[0], []
    for w in gw:
        sizes += [h * h * cin, 4 * h * h * w]
        h, cin = 2 * h, w
    fwd, bwd = [], []
    for net, n, grad_w, _ in work.passes(sz):
        if net == "gen":
            fwd += [n * e for e in sizes]
            if grad_w:
                bwd += [n * e for e in sizes]
    return fwd, bwd


def cbn_least_s(sz: dict, peaks: dict) -> float:
    """The least time of a step's per-sample epilogues: a forward reads x
    and writes y, a backward reads x and the cotangent and writes dx (k
    and b are a sample's row of C values, left out)."""
    nb = work.DTYPE_BYTES[sz["compute_dtype"]]
    fwd, bwd = cbn_calls(sz)
    return (2 * sum(fwd) + 3 * sum(bwd)) * nb / peaks["bytes_per_s"]
