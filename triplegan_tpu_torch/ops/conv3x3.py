"""3×3 stride-1 convolution of NHWC activations with hand-written Hopper
forward and filter-gradient kernels, and its autograd Function; and the
stride-2 transposed 3×3 convolution on a hand-written kernel of its own.

Two CUDA sources replace the TPU kernels of
``triplegan_tpu/ops/pallas_conv.py`` (``_fwd_kernel`` behind
``conv3x3_nopad``, which also computes the input gradient, and
``_wgrad_kernel`` behind ``conv3x3_wgrad``), one per dtype:

* float32: ``csrc/conv3x3.cu``, an implicit GEMM on the CUDA cores in
  full float32 (256-thread blocks of up to 128×128 with 8×8 accumulators
  a thread, fed by a ring of shared-memory tiles). The wrapper plans the forward
  (``f32_fwd_plan``: the block width, and a stream-K share-out of the
  output tiles that would fill only part of a last wave of the card) and
  the filter gradient's split over pixels (``f32_wgrad_plan``); both sum
  their partials in a fixed order. The kernels read any channel count and alignment
  (16-byte copies where they can, 4-byte ones elsewhere), so no operand is
  padded or copied. A forward (or input gradient) with at least 64 input
  and 32 output channels runs instead through Winograd F(2×2, 3×3)
  (``f32_wino_plan``): four kernels (the filter, input and output
  transforms and 16 products on the same product loop), 16 multiply-adds a
  2×2 output and channel pair where the direct conv does 36, into
  workspaces this wrapper allocates; its plain twin is
  ``ops/winograd.py::winograd_nopad``;
* bfloat16: ``csrc/conv3x3_sm90.cu``, an implicit GEMM on the tensor cores
  (``wgmma``, fed by a ring of ``cp.async`` and TMA copies). The wrapper
  packs the forward's weight into a K-major, zero-padded matrix
  (``pack_weight_sm90``), pads a channel count that is not a multiple of 8
  with zeros, and plans the filter gradient's split (``sm90_wgrad_plan``).

Both are bound by operations at the training step's shapes (M = N·H·W,
N = Cout, K = 9·Cin); design notes are in the sources.

Semantics, as in the JAX package:

* ``conv3x3_nopad(x, w, pad)``: a VALID 3×3 conv of x read with a zero halo
  of ``pad`` pixels (0 = x is already padded, JAX's ``conv3x3_nopad``);
  the sum over the nine taps accumulates in float32 and the result is in
  x's dtype. Deterministic on the card: the same shapes take the same
  plan, and a split's partial sums are added in a fixed order. The kernel reads the halo with bounds checks instead of
  materializing the padded copy. Through Winograd the float32 result
  differs from the exact value by at most (Cin + 32)·2⁻²⁴·M, M the conv
  computed on magnitudes through the transforms
  (``ops/winograd.py::winograd_magnitude``); the direct kernel's by at
  most 9·Cin·2⁻²⁴ times the plain conv on magnitudes.
* ``conv3x3_wgrad(x, g, pad)``: dW[dy,dx] = Σ x_halo[n,h+dy,w+dx,:]ᵀ ·
  g[n,h,w,:], float32 (3, 3, Cin, Cout). Deterministic on the card: the
  reduction over N·H·W is split over blocks into a float32 workspace and
  summed in a fixed order.
* ``conv3x3(x, w, padding)``: the differentiable op (``pallas_conv.py``
  ``conv3x3`` with its custom VJP). w is HWIO (3, 3, Cin, Cout), the
  layout the kernels take, cast to x's dtype for the forward; dx is the
  forward kernel on g with halo 2 − p against the flipped, in/out-swapped
  kernel; dw is ``conv3x3_wgrad`` cast to w's dtype. Gradients that autograd
  does not need (dx of a conv on data) are not computed. Where autograd
  records the backward (``create_graph``: R1's gradient penalty), dx and
  dw are the Functions ``_Conv3x3Nopad`` and ``_Conv3x3Wgrad``, whose own
  backwards are these convs again (the filter gradient is bilinear in x
  and g), so the gradient differentiates to any order on the same kernels
  (counted in ``second_order_launches``); a gradient the running backward
  will not use is not computed (``engine_needs``).
* ``tconv3x3_s2(x, w)``: the VALID stride-2 transposed 3×3 conv, (N, h,
  w, Cin) → (N, 2h + 1, 2w + 1, Cout), float32 only, on ``csrc/
  conv3x3.cu`` ``tconv2_kernel`` (the output's four parity phases as
  implicit GEMMs over their own taps, on the forward kernel's product
  loop; each output written once by one block, so results repeat
  bitwise). It replaces no TPU kernel: StyleGAN2's up-convs
  (``conv_transpose3x3_s2``) and the input gradients of its stride-2
  convs (``conv3x3_s2``, whose forward and filter gradient stay cuDNN's)
  run on it, twice differentiable (``_TConv3x3S2``, ``_Conv3x3S2``).

A tensor on the CPU takes the plain versions (``reference_*``: nine
shifted matmuls accumulated in float32, as the Pallas bodies do;
``F.conv_transpose2d`` for ``tconv3x3_s2``). A CUDA tensor launches the
kernel or raises; there is no fallback.

The forward is also a PyTorch operator, ``torch.ops.triplegan_torch.
conv3x3_fwd`` (``conv3x3_op``): ``conv3x3_nopad`` for CUDA tensors, the plain
version for CPU tensors, and a shape-only fake for tracing, so that
``torch.export`` records the operator and an exported program launches the
kernel (``export.py``). A ``conv3x3`` call that autograd does not record
goes to the operator; the ``autograd.Function``'s forward calls it too.
"""

from __future__ import annotations

import collections
import ctypes
import fractions
import functools
import math

import torch

from triplegan_tpu_torch.ops import build

_DTYPES = (torch.float32, torch.bfloat16)
_PAD = {"SAME": 1, "VALID": 0}

# Kernel launches since the counts were last cleared: the forward kernel
# (forward and input gradient) and the filter-gradient kernel, keyed by
# (role, N, H, W, Cin, Cout, halo, dtype) of the call, role "fwd", "dgrad"
# or "wgrad" and (N, H, W, Cin) the kernel's input.
fwd_launches: collections.Counter = collections.Counter()
wgrad_launches: collections.Counter = collections.Counter()
# Float32 forward kernel launches by block, keyed by ``f32_fwd_block``:
# (rows, columns, the im2col tile's layout).
fwd_block_launches: collections.Counter = collections.Counter()
# Float32 forwards and input gradients run through the Winograd pipeline
# (``f32_wino_plan``) instead of the forward kernel, keyed as
# ``fwd_launches``: each call is one launch of each of its four kernels.
wino_launches: collections.Counter = collections.Counter()

# The float32 kernels: 16 of K (forward) or pixels (wgrad) a stage; two
# blocks fit on each of the H100's 132 SMs, so a wave is 264.
_F32_BK = 16
_F32_WAVE = 2 * 132
_F32_MIN_CHUNK = 512
_F32_MIN_RUN = 8  # K tiles of a forward stream-K run
_F32_SK_SAVES = 16  # K tiles a run must save against a whole tile for stream-K to pay
# The float32 Winograd pipeline (``f32_wino_plan``) takes a forward with at
# least this many input channels, output channels and 2×2 output tiles:
# below each the direct kernel was as fast or faster on the card (PERF.md).
_WINO_MIN_CIN, _WINO_MIN_COUT, _WINO_MIN_TILES = 64, 32, 256
# The bfloat16 kernels: blocks of 128 rows, 64 of K (or of pixels) a
# stage; two blocks fit on each of the H100's 132 SMs, so a wave is 264.
_SM90_BM, _SM90_BK = 128, 64
_SM90_WAVE = 2 * 132
_SM90_MIN_CHUNK = 512


def _pad_hw(x: torch.Tensor, p: int) -> torch.Tensor:
    if p == 0:
        return x
    return torch.nn.functional.pad(x, (0, 0, p, p, p, p))


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' accumulation dtype: float32, float64 for a
    float64 tensor (which only the CPU takes)."""
    return torch.promote_types(t.dtype, torch.float32)


def _taps(x_pad: torch.Tensor, ho: int, wo: int):
    ct = _acc_dtype(x_pad)
    for dy in range(3):
        for dx in range(3):
            yield dy, dx, x_pad[:, dy:dy + ho, dx:dx + wo, :].reshape(-1, x_pad.shape[-1]).to(ct)


def reference_conv3x3_nopad(x_pad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``conv3x3_nopad``: (N, Ho+2, Wo+2, Cin) × (3, 3,
    Cin, Cout) → (N, Ho, Wo, Cout) in x's dtype, float32 accumulation."""
    n, hp, wp, _ = x_pad.shape
    ho, wo = hp - 2, wp - 2
    acc = torch.zeros((n * ho * wo, w.shape[-1]), dtype=_acc_dtype(x_pad), device=x_pad.device)
    for dy, dx, patch in _taps(x_pad, ho, wo):
        acc += patch @ w[dy, dx].to(acc.dtype)
    return acc.reshape(n, ho, wo, -1).to(x_pad.dtype)


def reference_conv3x3_wgrad(x_pad: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of ``conv3x3_wgrad``: float32 (3, 3, Cin, Cout)
    (float64 for float64 operands)."""
    _, ho, wo, cout = g.shape
    g2 = g.reshape(-1, cout).to(_acc_dtype(g))
    out = torch.empty((3, 3, x_pad.shape[-1], cout), dtype=g2.dtype, device=x_pad.device)
    for dy, dx, patch in _taps(x_pad, ho, wo):
        out[dy, dx] = patch.T @ g2
    return out


def reference_conv3x3(x: torch.Tensor, w: torch.Tensor, padding: str = "SAME") -> torch.Tensor:
    """Plain forward of ``conv3x3`` (SAME or VALID)."""
    return reference_conv3x3_nopad(_pad_hw(x, _PAD[padding]), w.to(x.dtype))


def _lib():
    lib = build.load("conv3x3")
    fwd, wgrad = lib.conv3x3_fwd_launch, lib.conv3x3_wgrad_launch
    if fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        fwd.restype = i
        wgrad.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_longlong, p]
        wgrad.restype = i
    return fwd, wgrad


def _lib_wino():
    wino = build.load("conv3x3").conv3x3_wino_launch
    if wino.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        wino.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        wino.restype = i
    return wino


def _lib_sm90():
    lib = build.load("conv3x3_sm90")
    fwd, wgrad = lib.conv3x3_fwd_sm90_launch, lib.conv3x3_wgrad_sm90_launch
    if fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fwd.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p]
        fwd.restype = i
        wgrad.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, i, ctypes.c_longlong, p]
        wgrad.restype = i
    return fwd, wgrad


def _ceil_to(v: int, m: int) -> int:
    return -(-v // m) * m


def pad_channels(t: torch.Tensor, c: int) -> torch.Tensor:
    """t with its last dimension zero-padded to c, in memory aligned to 16
    bytes as the bfloat16 kernels' copies need (t itself if it is so)."""
    if t.shape[-1] != c:
        return torch.nn.functional.pad(t, (0, c - t.shape[-1]))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fwd_block_n(cout: int) -> int:
    """Columns of Cout per block of either forward kernel: Cout rounded
    up to 16, 32 or 64, else tiles of 128."""
    for bn in (16, 32, 64):
        if cout <= bn:
            return bn
    return 128


def pack_weight_sm90(w: torch.Tensor, cin8: int, bn: int) -> torch.Tensor:
    """The bfloat16 forward kernel's B operand: HWIO w (3, 3, Cin, Cout) as
    a K-major (Np, Kp) matrix, row co holding w[dy, dx, ci, co] at column
    (dy·3 + dx)·cin8 + ci, with Cin padded to cin8 per tap, K = 9·cin8 to a
    multiple of 64 and Cout to a multiple of bn, zeros in the padding."""
    cin, cout = w.shape[2], w.shape[3]
    k8 = 9 * cin8
    wp = torch.zeros((_ceil_to(cout, bn), _ceil_to(k8, _SM90_BK)), dtype=w.dtype, device=w.device)
    wp[:cout, :k8].view(cout, 9, cin8)[:, :, :cin] = w.reshape(9, cin, cout).permute(2, 0, 1)
    return wp


def sm90_wgrad_plan(m: int, cin8: int, cout8: int):
    """(bn, splits, chunk) of the bfloat16 wgrad over m = N·Ho·Wo pixels:
    blocks of 128 rows of K = 9·cin8 by bn columns (64 or 128), and the
    reduction split so that the blocks come to at most one wave of the
    card, in chunks of at least 512 pixels and a multiple of 64. A function
    of the shapes alone, so results repeat."""
    bn = 64 if cout8 <= 64 else 128
    tiles = math.ceil(9 * cin8 / _SM90_BM) * math.ceil(cout8 / bn)
    splits = max(1, min(_SM90_WAVE // tiles, math.ceil(m / _SM90_MIN_CHUNK)))
    chunk = _ceil_to(math.ceil(m / splits), _SM90_BK)
    return bn, math.ceil(m / chunk), chunk


def _check_cuda(name: str, **tensors):
    x = next(iter(tensors.values()))
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes cpu or cuda tensors, got {x.device}")
    for arg, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {x.device}")
        if t.dtype not in _DTYPES or t.dtype != x.dtype:
            raise TypeError(f"{name} kernel takes float32 or bfloat16 tensors of one dtype; "
                            f"{arg} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous tensors; {arg} is not")
        if t.dim() != 4 or t.numel() == 0:
            raise ValueError(f"{name}: {arg} must be a non-empty 4-D tensor, got {tuple(t.shape)}")


def _out_hw(x: torch.Tensor, pad: int):
    if pad not in (0, 1, 2):
        raise ValueError(f"halo must be 0, 1 or 2 pixels, got {pad}")
    ho, wo = x.shape[1] + 2 * pad - 2, x.shape[2] + 2 * pad - 2
    if ho <= 0 or wo <= 0:
        raise ValueError(f"input {tuple(x.shape)} with halo {pad} is smaller than the 3x3 kernel")
    return ho, wo


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


def conv3x3_nopad(x: torch.Tensor, w: torch.Tensor, pad: int = 0, role: str = "fwd") -> torch.Tensor:
    """VALID 3×3 conv of NHWC x read with a zero halo of ``pad`` pixels;
    w is HWIO (3, 3, Cin, Cout). CPU tensors take the plain version, CUDA
    tensors the Hopper kernels (w must then be in x's dtype): at float32
    the Winograd pipeline where ``f32_wino_plan`` gives a plan, else the
    forward kernel. ``role`` only labels the launch count: "fwd", or
    "dgrad" where x is a cotangent."""
    return _forward(x, w, pad, role, winograd=True)


def conv3x3_direct(x: torch.Tensor, w: torch.Tensor, pad: int = 0, role: str = "fwd") -> torch.Tensor:
    """``conv3x3_nopad`` through the forward kernel at every shape: the
    direct conv that ``f32_wino_plan`` weighs the Winograd pipeline
    against, for the checks and timings on the card."""
    return _forward(x, w, pad, role, winograd=False)


def _forward(x, w, pad, role, winograd):
    ho, wo = _out_hw(x, pad)
    if x.device.type == "cpu":
        return reference_conv3x3_nopad(_pad_hw(x, pad), w)
    _check_cuda("conv3x3_nopad", x=x, w=w)
    n, hin, win, cin = x.shape
    if tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got {tuple(w.shape)}")
    cout = w.shape[3]
    y = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    wino = f32_wino_plan(n, ho, wo, cin, cout) if winograd and x.dtype == torch.float32 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.bfloat16:
            cin8 = _ceil_to(cin, 8)
            xk = pad_channels(x, cin8)
            bn = fwd_block_n(cout)
            wp = pack_weight_sm90(w, cin8, bn)
            fwd, _ = _lib_sm90()
            rc = fwd(xk.data_ptr(), wp.data_ptr(), y.data_ptr(), n, hin, win, cin8, cout, pad,
                     bn, wp.shape[0], wp.shape[1], stream)
        elif wino is not None:
            bn, _, ws_len = wino
            ws = torch.empty(ws_len, dtype=torch.float32, device=x.device)
            rc = _lib_wino()(x.data_ptr(), w.data_ptr(), ws.data_ptr(), y.data_ptr(), n, hin, win, cin, cout,
                             pad, bn, stream)
        else:
            bn, full, per, ws_len = f32_fwd_plan(n * ho * wo, cin, cout)
            block = f32_fwd_block(bn)
            ws = torch.empty(ws_len, dtype=torch.float32, device=x.device) if ws_len else None
            fwd, _ = _lib()
            rc = fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), None if ws is None else ws.data_ptr(), n,
                     hin, win, cin, cout, pad, bn, full, per, stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3 forward kernel launch failed: cudaError {rc}")
    key = role, n, hin, win, cin, cout, pad, _dtype_name(x)
    if wino is not None:
        wino_launches[key] += 1
    else:
        fwd_launches[key] += 1
        if x.dtype == torch.float32:
            fwd_block_launches[block] += 1
    return y


def _best_fill(tiles: int, most: int) -> int:
    """The split count s in 1..most whose tiles·s blocks fill their last
    wave of the card best; the smallest among equals."""
    def key(s):
        blocks = tiles * s
        return fractions.Fraction(blocks, math.ceil(blocks / _F32_WAVE) * _F32_WAVE), -s

    return max(range(1, max(1, most) + 1), key=key)


def _f32_fwd_rows(bn: int) -> int:
    """Rows of M per block of the float32 forward kernel of width bn."""
    return 256 if bn <= 32 else 128


def f32_fwd_block(bn: int):
    """(rows, columns, layout of the im2col tile) of the float32 forward
    kernel's block of width bn, as ``csrc/conv3x3.cu`` lays it out: the
    tile is "k-major" where a thread owns 8 rows of the output tile (blocks
    128 × 128, 128 × 64 and 256 × 32), so its product loop is the filter
    gradient's; "m-major" in the 256 × 16 block, whose threads own 4."""
    return _f32_fwd_rows(bn), bn, "m-major" if bn == 16 else "k-major"


@functools.lru_cache(maxsize=None)
def f32_fwd_plan(m: int, cin: int, cout: int):
    """(bn, full, per, ws) of the float32 forward over m = N·Ho·Wo output
    pixels: blocks of bn = ``fwd_block_n(cout)`` columns; the whole waves
    of output tiles run as they are, one block a tile (``full`` tiles), and
    the tiles left over, which would fill only part of a last wave, are
    shared out stream-K: their K tiles of 16, taken tile by tile, are cut
    into runs of ``per`` (at least 8), one block a run, at most one wave of
    blocks, whose partial tiles (``ws`` floats of workspace) are summed in
    a fixed order. per is 0 (and full every tile) where a run would save
    16 K tiles or fewer against a whole tile: the extra partial tiles and
    their sum cost about that much. A function of the shapes alone, so
    results repeat."""
    bn = fwd_block_n(cout)
    bm = _f32_fwd_rows(bn)
    tiles = math.ceil(m / bm) * math.ceil(cout / bn)
    ktiles = math.ceil(9 * cin / _F32_BK)
    full = tiles // _F32_WAVE * _F32_WAVE
    iters = (tiles - full) * ktiles
    blocks = min(_F32_WAVE, iters // _F32_MIN_RUN)
    per = math.ceil(iters / blocks) if blocks else ktiles
    if ktiles - per <= _F32_SK_SAVES:
        return bn, tiles, 0, 0
    segments = math.ceil(per / ktiles) + 1  # output tiles a run can touch
    return bn, full, per, math.ceil(iters / per) * segments * bm * bn


@functools.lru_cache(maxsize=None)
def f32_wino_plan(n: int, ho: int, wo: int, cin: int, cout: int):
    """(bn, tiles, ws) of the float32 forward of an (n, ho, wo, cout)
    output from cin channels through Winograd F(2×2, 3×3), or None where
    the direct kernel takes it: under ``_WINO_MIN_CIN`` input channels,
    ``_WINO_MIN_COUT`` output channels or ``_WINO_MIN_TILES`` 2×2 output
    tiles, where the transforms cost more than the products save. tiles =
    n·⌈ho/2⌉·⌈wo/2⌉; the products' blocks are bn columns wide (64, or 128
    above 64 channels); ws floats of workspace hold U (16 × cin × cp), V
    (16 × cin × tp) and M (16 × tiles × cp), cp and tp being cout and tiles
    rounded up to multiples of 4. A function of the shapes alone, so
    results repeat."""
    tiles = n * -(-ho // 2) * -(-wo // 2)
    if cin < _WINO_MIN_CIN or cout < _WINO_MIN_COUT or tiles < _WINO_MIN_TILES:
        return None
    cp, tp = _ceil_to(cout, 4), _ceil_to(tiles, 4)
    return (64 if cp <= 64 else 128), tiles, 16 * (cin * cp + cin * tp + tiles * cp)


@functools.lru_cache(maxsize=None)
def f32_wgrad_plan(m: int, cin: int, cout: int):
    """(bm, bn, splits, chunk) of the float32 wgrad over m = N·Ho·Wo
    pixels: blocks of bm rows of K = 9·cin (128, or 32 where K <= 32) by bn
    columns (32, 64 or 128; 128 for the 32-row block), and the reduction
    split into at most two waves of the card (four where the output tiles
    alone are more than a wave), the split count that fills its last wave
    best (the fewest splits among equals), in chunks of at least 512 pixels
    and a multiple of 16. A function of the shapes alone,
    so results repeat."""
    bm = 32 if 9 * cin <= 32 else 128
    bn = 128 if bm == 32 or cout > 64 else 64 if cout > 32 else 32
    tiles = math.ceil(9 * cin / bm) * math.ceil(cout / bn)
    waves = 2 if tiles <= _F32_WAVE else 4
    splits = _best_fill(tiles, min(waves * _F32_WAVE // tiles, m // _F32_MIN_CHUNK))
    chunk = _ceil_to(math.ceil(m / splits), _F32_BK)
    return bm, bn, math.ceil(m / chunk), chunk


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """Filter gradient of ``conv3x3_nopad(x, w, pad)`` for the output
    cotangent g: float32 (3, 3, Cin, Cout). CPU tensors take the plain
    version, CUDA tensors the Hopper kernel."""
    ho, wo = _out_hw(x, pad)
    if tuple(g.shape[:3]) != (x.shape[0], ho, wo):
        raise ValueError(f"g must be ({x.shape[0]}, {ho}, {wo}, Cout), got {tuple(g.shape)}")
    if x.device.type == "cpu":
        return reference_conv3x3_wgrad(_pad_hw(x, pad), g)
    _check_cuda("conv3x3_wgrad", x=x, g=g)
    n, hin, win, cin = x.shape
    cout = g.shape[3]
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        cin8, cout8 = _ceil_to(cin, 8), _ceil_to(cout, 8)
        bn, splits, chunk = sm90_wgrad_plan(n * ho * wo, cin8, cout8)
    else:
        bm, bn, splits, chunk = f32_wgrad_plan(n * ho * wo, cin, cout)
    out = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    ws = out if splits == 1 else torch.empty((splits, 9 * cin * cout), dtype=torch.float32,
                                             device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if bf16:
            xk, gk = pad_channels(x, cin8), pad_channels(g, cout8)
            _, wgrad = _lib_sm90()
            rc = wgrad(xk.data_ptr(), gk.data_ptr(), ws.data_ptr(), out.data_ptr(), n, hin, win,
                       cin8, cout8, cin, cout, pad, bn, splits, chunk, stream)
        else:
            _, wgrad = _lib()
            rc = wgrad(x.data_ptr(), g.data_ptr(), ws.data_ptr(), out.data_ptr(), n, hin, win,
                       cin, cout, pad, bm, bn, splits, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3 wgrad kernel launch failed: cudaError {rc}")
    wgrad_launches["wgrad", n, hin, win, cin, cout, pad, _dtype_name(x)] += 1
    return out


class _Conv3x3(torch.autograd.Function):
    """``pallas_conv.py::conv3x3`` and its custom VJP (``_conv3x3_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, padding):
        p = _PAD[padding]
        ctx.p = p
        ctx.save_for_backward(x, w)
        return conv3x3_op(x, w.to(x.dtype).contiguous(), p)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if torch.is_grad_enabled():  # a gradient to be differentiated again
            return (*_conv_grads(x, w, g, ctx.p, engine_needs(ctx, 2)), None)
        if ctx.needs_input_grad[0]:
            w_flip = w.flip((0, 1)).transpose(2, 3).to(g.dtype).contiguous()
            dx = conv3x3_nopad(g, w_flip, pad=2 - ctx.p, role="dgrad").to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(x, g, pad=ctx.p).to(w.dtype)
        return dx, dw, None


# The 3×3 convs of second order since the counts were last cleared: those
# of a backward that autograd records to differentiate again
# (``create_graph``; R1's gradient penalty), and those of that backward's
# own backward. Keyed as ``fwd_launches``, the role "dgrad2" (an input
# gradient), "wgrad2" (a filter gradient) or "fwd2" (a forward of an
# input by a filter cotangent); on the card each is a launch of the kernels
# the first-order call takes (``_forward``, ``conv3x3_wgrad``), on the CPU
# a call of the plain version.
second_order_launches: collections.Counter = collections.Counter()


def engine_needs(ctx, n: int):
    """``ctx.needs_input_grad`` of a Function's first ``n`` inputs, less
    those whose gradient the running backward will not use: an input that
    requires a gradient the call does not ask for (R1's gradient in the
    image alone, while the weights require theirs) is told apart by the
    engine's plan, for any input that is not a leaf (a leaf under
    ``autograd.grad`` the engine cannot tell of: taken as needed)."""
    out = []
    for i in range(n):
        node = ctx.next_functions[i][0] if ctx.needs_input_grad[i] else None
        try:
            out.append(node is not None and torch._C._will_engine_execute_node(node))
        except RuntimeError:
            out.append(True)
    return tuple(out)


def _flip_io(w: torch.Tensor) -> torch.Tensor:
    """The input gradient's kernel: HWIO w flipped in H and W, I and O
    swapped (differentiable in w)."""
    return w.flip((0, 1)).transpose(2, 3)


def _conv_grads(x, w, g, p, needs, recorded: bool = True):
    """(dx, dw) of ``conv3x3_nopad(x, w, p)`` for the cotangent g, None
    where ``needs`` does not ask: dx the conv of g, halo 2 − p, by the
    flipped kernel, dw the filter gradient; as the Functions below where
    autograd is to record them (``recorded``), else as plain calls."""
    dx = dw = None
    if needs[0]:
        dx = _conv2(g, _flip_io(w).to(g.dtype).contiguous(), 2 - p, "dgrad2", recorded).to(x.dtype)
    if needs[1]:
        if recorded:
            dw = _Conv3x3Wgrad.apply(x, g, p)
        else:
            second_order_launches[("wgrad2",) + _key_shape(x, g.shape[3], p)] += 1
            dw = conv3x3_wgrad(x, g, pad=p)
        dw = dw.to(w.dtype)
    return dx, dw


def _conv2(x, w, pad, role, recorded):
    """``conv3x3_nopad`` of second order, counted under ``role``: the
    Function where autograd is to record it, else the plain call."""
    if recorded:
        return _Conv3x3Nopad.apply(x, w, pad, role)
    second_order_launches[(role,) + _key_shape(x, w.shape[3], pad)] += 1
    return conv3x3_nopad(x, w, pad, role=role[:-1])


class _Conv3x3Nopad(torch.autograd.Function):
    """``conv3x3_nopad(x, w, pad)`` differentiable to any order: its
    backward is ``_conv_grads``, through these Functions again where
    autograd records it."""

    @staticmethod
    def forward(ctx, x, w, pad, role):
        ctx.p = pad
        ctx.save_for_backward(x, w)
        second_order_launches[(role,) + _key_shape(x, w.shape[3], pad)] += 1
        return conv3x3_nopad(x, w, pad, role=role[:-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        recorded = torch.is_grad_enabled()
        needs = engine_needs(ctx, 2) if recorded else ctx.needs_input_grad
        return (*_conv_grads(x, w, g.contiguous(), ctx.p, needs, recorded), None, None)


class _Conv3x3Wgrad(torch.autograd.Function):
    """``conv3x3_wgrad(x, g, pad)``, the filter gradient, differentiable:
    it is bilinear in x and g, so for its cotangent dW the gradient in x is
    the input gradient of g by dW (the conv of g, halo 2 − pad, by dW
    flipped) and the gradient in g the forward of x by dW."""

    @staticmethod
    def forward(ctx, x, g, pad):
        ctx.p = pad
        ctx.save_for_backward(x, g)
        second_order_launches[("wgrad2",) + _key_shape(x, g.shape[3], pad)] += 1
        return conv3x3_wgrad(x, g, pad)

    @staticmethod
    def backward(ctx, dw):
        x, g = ctx.saved_tensors
        dw = dw.to(x.dtype)
        recorded = torch.is_grad_enabled()
        needs = engine_needs(ctx, 2) if recorded else ctx.needs_input_grad
        gx = _conv2(g, _flip_io(dw).contiguous(), 2 - ctx.p, "dgrad2", recorded) if needs[0] else None
        gg = _conv2(x, dw.contiguous(), ctx.p, "fwd2", recorded) if needs[1] else None
        return gx, gg, None


def _key_shape(x, cout, pad):
    return tuple(x.shape) + (cout, pad, _dtype_name(x))


def conv3x3(x: torch.Tensor, w: torch.Tensor, padding: str = "SAME") -> torch.Tensor:
    """Differentiable 3×3 stride-1 conv (SAME or VALID) of contiguous NHWC
    x with an HWIO w, through the Hopper kernels on the card. Matches
    ``F.conv2d`` (and JAX's ``lax.conv_general_dilated``) in float32."""
    if padding not in _PAD:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3 takes cpu or cuda tensors, got {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv3x3.apply(x, w, padding)
    return conv3x3_op(x, w.to(x.dtype).contiguous(), _PAD[padding])


# ---------------------------------------------------------------------------
# The stride-2 transposed 3×3 conv (StyleGAN2's up-convs, and the input
# gradient of its stride-2 convs)
# ---------------------------------------------------------------------------

# Launches of ``tconv3x3_s2``'s kernel since the counts were last cleared,
# keyed (role, N, h, w, Cin, Cout, dtype) of its input: role "up" (an
# up-conv's forward) or "dgrad" (the input gradient of a stride-2 conv).
tconv_launches: collections.Counter = collections.Counter()
# Phase tiles of 128 rows by 128 columns take a call with at least this many
# of them (two waves of the card); a call with fewer takes 128 × 64 tiles,
# twice as many blocks of half the work.
_TCONV_MIN_WIDE_BLOCKS = 2 * _F32_WAVE


def reference_tconv3x3_s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``tconv3x3_s2``: ``F.conv_transpose2d`` at stride 2
    of NHWC x (N, h, w, Cin) by HWIO w (3, 3, Cin, Cout), → (N, 2h + 1,
    2w + 1, Cout) NHWC."""
    y = torch.nn.functional.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1).to(x.dtype), stride=2)
    return y.permute(0, 2, 3, 1).contiguous()


@functools.lru_cache(maxsize=None)
def tconv_plan(n: int, h: int, w: int, cin: int, cout: int) -> int:
    """The width bn of ``tconv3x3_s2``'s blocks (128 rows of a phase by bn
    columns of Cout): 128 where the four phases' 128 × 128 tiles come to
    ``_TCONV_MIN_WIDE_BLOCKS`` or more, else 64. A function of the shapes
    alone, so results repeat."""
    rows = sum(math.ceil(n * (h + 1 - py) * (w + 1 - px) / 128) for py in (0, 1) for px in (0, 1))
    return 128 if rows * math.ceil(cout / 128) >= _TCONV_MIN_WIDE_BLOCKS else 64


def _lib_tconv():
    tconv = build.load("conv3x3").tconv3x3_s2_launch
    if tconv.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        tconv.argtypes = [p, p, p, i, i, i, i, i, i, p]
        tconv.restype = i
    return tconv


def tconv3x3_s2(x: torch.Tensor, w: torch.Tensor, role: str = "up") -> torch.Tensor:
    """VALID stride-2 transposed 3×3 conv of NHWC x (N, h, w, Cin) by HWIO
    w (3, 3, Cin, Cout): y[n, 2i+a, 2j+b] += x[n, i, j] · w[a, b], → (N,
    2h + 1, 2w + 1, Cout). CPU tensors take the plain version; CUDA tensors
    the float32 kernel (``csrc/conv3x3.cu`` ``tconv2_kernel``: the output's
    four parity phases as implicit GEMMs over their taps alone, each
    output written once by one block, so results repeat bitwise), which
    takes Cin a multiple of 16 and Cout of 4, or raises. ``role`` only
    labels the launch count: "up", or "dgrad" where x is a cotangent."""
    if x.device.type == "cpu":
        return reference_tconv3x3_s2(x, w)
    _check_cuda("tconv3x3_s2", x=x, w=w)
    n, h, wd, cin = x.shape
    if tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got {tuple(w.shape)}")
    cout = w.shape[3]
    if x.dtype != torch.float32 or cin % 16 or cout % 4:
        raise ValueError(f"the tconv3x3_s2 kernel takes float32 with Cin a multiple of 16 and Cout of 4, "
                         f"got {x.dtype}, Cin {cin}, Cout {cout}")
    y = torch.empty((n, 2 * h + 1, 2 * wd + 1, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib_tconv()(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, cin, cout,
                          tconv_plan(n, h, wd, cin, cout), stream)
    if rc != 0:
        raise RuntimeError(f"tconv3x3_s2 kernel launch failed: cudaError {rc} (x and w must be 16-byte aligned)")
    tconv_launches[role, n, h, wd, cin, cout, _dtype_name(x)] += 1
    return y


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


class _TConv3x3S2(torch.autograd.Function):
    """``tconv3x3_s2(x, w)`` differentiable to any order: its input
    gradient is the stride-2 conv of the cotangent by w and its filter
    gradient cuDNN's weight gradient (``F.conv2d``, ``conv2d_weight``:
    PyTorch ops that autograd records where it is to)."""

    @staticmethod
    def forward(ctx, x, w, role):
        ctx.save_for_backward(x, w)
        return tconv3x3_s2(x, w, role)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        needs = engine_needs(ctx, 2) if torch.is_grad_enabled() else ctx.needs_input_grad
        gc = _nchw(g)
        dx = dw = None
        if needs[0]:
            dx = torch.nn.functional.conv2d(gc, w.permute(2, 3, 0, 1).to(g.dtype), stride=2)
            dx = dx.permute(0, 2, 3, 1).contiguous()
        if needs[1]:
            dw = torch.nn.grad.conv2d_weight(gc, (w.shape[2], w.shape[3], 3, 3), _nchw(x), stride=2)
            dw = dw.permute(2, 3, 0, 1).to(w.dtype)
        return dx, dw, None


class _Conv3x3S2(torch.autograd.Function):
    """The VALID stride-2 3×3 conv of NHWC x (N, 2h + 1, 2w + 1, Cin) by
    OIHW w (cuDNN's forward, ``F.conv2d``), whose input gradient is the
    transposed conv of the cotangent by w (``_TConv3x3S2`` where autograd
    records it, R1's gradient penalty, else ``tconv3x3_s2``), its filter
    gradient cuDNN's; a gradient the running backward will not use is not
    computed."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.nn.functional.conv2d(_nchw(x), w, stride=2).permute(0, 2, 3, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        recorded = torch.is_grad_enabled()
        needs = engine_needs(ctx, 2) if recorded else ctx.needs_input_grad
        g = g.contiguous()
        dx = dw = None
        if needs[0]:
            wk = w.permute(2, 3, 0, 1).contiguous()  # HWIO of the transposed conv: I the conv's Cout
            dx = _TConv3x3S2.apply(g, wk, "dgrad") if recorded else tconv3x3_s2(g, wk, "dgrad")
        if needs[1]:
            dw = torch.nn.grad.conv2d_weight(_nchw(x), w.shape, _nchw(g), stride=2)
        return dx, dw


def conv_transpose3x3_s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable ``tconv3x3_s2(x, w)`` of contiguous NHWC x and HWIO
    w (an up-conv: launches counted under "up")."""
    return _TConv3x3S2.apply(x, w, "up")


def conv3x3_s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable VALID stride-2 3×3 conv of contiguous NHWC x of odd
    height and width by OIHW w → NHWC, whose input gradient runs on
    ``tconv3x3_s2``."""
    return _Conv3x3S2.apply(x, w)


def _conv3x3_op(x, w, pad):
    return conv3x3_nopad(x, w, pad)


def _conv3x3_fake(x, w, pad):
    ho, wo = _out_hw(x, pad)
    return x.new_empty((x.shape[0], ho, wo, w.shape[3]))


# ``conv3x3_nopad(x, w, pad)`` as an operator: the plain version for CPU
# tensors, for CUDA tensors one launch of the forward kernel (counted in
# ``fwd_launches``) or an error, a shape-only fake for tracing; registered
# as ``scale_bias_act.py``'s operator is.
_LIB = torch.library.Library("triplegan_torch", "FRAGMENT")  # kept: registrations live with it
_LIB.define("conv3x3_fwd(Tensor x, Tensor w, int pad) -> Tensor")
for _key in ("CPU", "CUDA"):
    _LIB.impl("conv3x3_fwd", _conv3x3_op, _key)
torch.library.register_fake("triplegan_torch::conv3x3_fwd", _conv3x3_fake, lib=_LIB)
conv3x3_op = torch.ops.triplegan_torch.conv3x3_fwd.default
