"""Fused per-channel scale, bias and activation: ``act(x·k + b)``.

The hand-written Hopper kernel ``csrc/scale_bias_act.cu`` replaces the TPU
kernel ``triplegan_tpu/ops/pallas_fused.py::_kernel`` (launched by
``_pallas_rows``). It is bound by bytes: it reads x and writes y once, so
its least time is (bytes of x + bytes of y) / 3.35 TB/s on an H100. Design
(details in the source): one grid-stride loop, 16-byte vector loads where
the channel count allows, float32 math without FMA contraction so it rounds
exactly as the plain version does.

Semantics, as in the JAX package: ``k`` and ``b`` are (C,) per-channel
vectors over the last axis of x, first cast to x's dtype; the math is
float32 and the result is written in x's dtype (float32 or bfloat16).
``act`` is linear, relu, leaky_relu (``z >= 0`` keeps z, else slope·z) or
tanh.

A tensor on the CPU goes to ``reference_scale_bias_act``, the plain
version. A CUDA tensor launches the kernel or raises.

``scale_bias_act`` is differentiable: a ``torch.autograd.Function`` whose
backward is plain PyTorch, as the JAX package's custom VJP is jnp
(``pallas_fused.py::_bwd``). Like ``_bwd`` it recomputes z = x·k + b in
x's dtype (not in float32 as the forward does), and returns dk and db in
k's and b's dtypes; callers pass k and b already cast to x's dtype.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from triplegan_tpu_torch.ops import build

ACTS = {"linear": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the counts were last cleared, keyed by (x's shape,
# x's dtype, act, slope): the shapes each path runs the kernel at.
launches: collections.Counter = collections.Counter()


def apply_act(z: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    if act == "linear":
        return z
    if act == "relu":
        return torch.clamp_min(z, 0.0)
    if act == "leaky_relu":
        return torch.where(z >= 0, z, z * slope)
    if act == "tanh":
        return torch.tanh(z)
    raise ValueError(f"unknown act {act!r}")


def act_grad(z: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    """d act / dz, as ``pallas_fused.py::_act_grad`` (relu and leaky_relu
    take the z >= 0 branch at 0)."""
    if act == "linear":
        return torch.ones_like(z)
    if act == "relu":
        return (z >= 0).to(z.dtype)
    if act == "leaky_relu":
        return torch.where(z >= 0, torch.ones_like(z), torch.full_like(z, slope))
    if act == "tanh":
        t = torch.tanh(z)
        return 1.0 - t * t
    raise ValueError(f"unknown act {act!r}")


def reference_scale_bias_act(x, k, b, act="leaky_relu", slope=0.1):
    """The plain PyTorch version: the same function with the same casts."""
    kc, bc = k.to(x.dtype), b.to(x.dtype)
    z = x.float() * kc.float() + bc.float()
    return apply_act(z, act, slope).to(x.dtype)


def _lib():
    lib = build.load("scale_bias_act")
    fn = lib.scale_bias_act_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def scale_bias_act(x, k, b, act="leaky_relu", slope=0.1):
    """``act(x·k + b)`` per channel (last axis), differentiable in x, k and
    b. CPU tensors take the plain version; CUDA tensors take the Hopper
    kernel."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}; expected one of {sorted(ACTS)}")
    return _ScaleBiasAct.apply(x, k, b, act, float(slope))


class _ScaleBiasAct(torch.autograd.Function):
    """``pallas_fused.py::scale_bias_act`` with its custom VJP."""

    @staticmethod
    def forward(ctx, x, k, b, act, slope):
        ctx.save_for_backward(x, k, b)
        ctx.act, ctx.slope = act, slope
        return _forward(x, k, b, act, slope)

    @staticmethod
    def backward(ctx, g):
        x, k, b = ctx.saved_tensors
        kc, bc = k.to(x.dtype), b.to(x.dtype)
        t = g * act_grad(x * kc + bc, ctx.act, ctx.slope)
        axes = tuple(range(x.dim() - 1))
        dx = (t * kc).to(x.dtype) if ctx.needs_input_grad[0] else None
        dk = torch.sum(t * x, dim=axes).to(k.dtype) if ctx.needs_input_grad[1] else None
        db = torch.sum(t, dim=axes).to(b.dtype) if ctx.needs_input_grad[2] else None
        return dx, dk, db, None, None


def _forward(x, k, b, act, slope):
    """The forward alone: the plain version for a CPU tensor, else one
    launch of the kernel."""
    if x.device.type == "cpu":
        return reference_scale_bias_act(x, k, b, act, slope)
    if x.device.type != "cuda":
        raise ValueError(f"scale_bias_act takes cpu or cuda tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"scale_bias_act kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"scale_bias_act needs a non-empty tensor, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("scale_bias_act kernel needs a contiguous x (rows of C channels)")
    c = x.shape[-1]
    for name, v in (("k", k), ("b", b)):
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if tuple(v.shape) != (c,):
            raise ValueError(f"{name} must have shape ({c},), got {tuple(v.shape)}")
    kc = k.to(x.dtype).contiguous()
    bc = b.to(x.dtype).contiguous()
    y = torch.empty_like(x)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), kc.data_ptr(), bc.data_ptr(), y.data_ptr(),
            x.numel() // c, c, _DTYPES[x.dtype], ACTS[act], float(slope), stream,
        )
    if rc != 0:
        raise RuntimeError(f"scale_bias_act kernel launch failed: cudaError {rc}")
    launches[tuple(x.shape), str(x.dtype).split(".")[-1], act, float(slope)] += 1
    return y
