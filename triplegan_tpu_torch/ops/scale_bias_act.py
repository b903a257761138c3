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
version. A CUDA tensor launches the kernel or raises. Forward only: the
training slice adds the autograd Function.
"""

from __future__ import annotations

import ctypes

import torch

from triplegan_tpu_torch.ops import build

ACTS = {"linear": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches by scale_bias_act since the count was last set to 0.
launches = 0


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
    """``act(x·k + b)`` per channel (last axis). CPU tensors take the plain
    version; CUDA tensors take the Hopper kernel."""
    global launches
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}; expected one of {sorted(ACTS)}")
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
    launches += 1
    return y
