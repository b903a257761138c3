"""Fused per-channel scale, bias and activation: ``act(x·k + b)``, and its
gradient.

The hand-written Hopper kernels of ``csrc/scale_bias_act.cu`` replace the
TPU kernel ``triplegan_tpu/ops/pallas_fused.py::_kernel`` (launched by
``_pallas_rows``) and its custom VJP ``_bwd``: a forward kernel, and a
backward kernel that computes dx, dk and db in one pass over x and the
cotangent g (plus a small fixed-order reduce of its per-block sums). Both
are bound by bytes: the forward reads x and writes y once, the backward
reads x and g and writes dx once, so their least times are those bytes /
3.35 TB/s on an H100. Design notes are in the source.

Semantics, as in the JAX package: ``k`` and ``b`` are (C,) per-channel
vectors over the last axis of x, first cast to x's dtype; the forward's
math is float32 and its result is written in x's dtype (float32 or
bfloat16). ``act`` is linear, relu, leaky_relu (``z >= 0`` keeps z, else
slope·z) or tanh.

``scale_bias_act`` is differentiable: a ``torch.autograd.Function`` whose
backward is ``pallas_fused.py::_bwd``. Like ``_bwd`` it recomputes
z = x·k + b in x's dtype (not in float32 as the forward does), and returns
dk and db in k's and b's dtypes; callers pass k and b already cast to x's
dtype. Only the gradients autograd asks for are computed.

A tensor on the CPU takes the plain versions (``reference_scale_bias_act``,
``reference_scale_bias_act_bwd``). A CUDA tensor launches the kernel or
raises, in the forward and in the backward.

``scale_bias_act_cond`` is the per-sample variant, the class-conditional
batch norm's epilogue: k and b of (N, C), one row a sample, act(x·k_n +
b_n) over each sample's rows, its backward summing dk and db over each
sample's rows alone; its kernels (``cbn_*``) carry their own names and
launch counters (``cond_launches``, ``cond_bwd_launches``). It is not an
operator: no exported program holds it.

The forward is also a PyTorch operator, ``torch.ops.triplegan_torch.
scale_bias_act`` (``scale_bias_act_op``): the kernel for CUDA tensors, the
plain version for CPU tensors, and a shape-only fake for tracing (the
registration is at the end of this module), so that
``torch.export`` records the operator and an exported program launches the
kernel (``export.py``). A call that autograd does not record (no input
needs a gradient, or grad mode is off) goes to the operator; the
``autograd.Function``'s forward calls it too.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from triplegan_tpu_torch.ops import build

ACTS = {"linear": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_NEEDS = "xkb"  # dx, dk, db: bit 1, 2, 4 of the backward kernel's flags

# Launches since the counts were last cleared. The forward kernel's are
# keyed by (x's shape, x's dtype, act, slope): the shapes each path runs it
# at. The backward kernel's are keyed the same way plus the gradients it
# computed, a string of "x", "k", "b" (dx, dk, db).
launches: collections.Counter = collections.Counter()
bwd_launches: collections.Counter = collections.Counter()


def apply_act(z: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    """``act(z)`` in z's dtype. The leaky slope is rounded to z's dtype
    first, as JAX rounds a Python constant to a bfloat16 operand's dtype
    (0.1 becomes 0.10009765625), so that ``slope·z`` and its gradient match
    the JAX package's plain path bit for bit at bfloat16."""
    if act == "linear":
        return z
    if act == "relu":
        return torch.relu(z)
    if act == "leaky_relu":
        return torch.where(z >= 0, z, z * _rounded(slope, z.dtype))
    if act == "tanh":
        return torch.tanh(z)
    raise ValueError(f"unknown act {act!r}")


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


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
    """The plain PyTorch version: the same function with the same casts
    (float32 math for float32 and bfloat16 x; float64 x, which only the CPU
    takes, keeps float64)."""
    kc, bc = k.to(x.dtype), b.to(x.dtype)
    ct = torch.promote_types(x.dtype, torch.float32)
    z = x.to(ct) * kc.to(ct) + bc.to(ct)
    return apply_act(z, act, slope).to(x.dtype)


def reference_bwd_t(x, k, b, g, act="leaky_relu", slope=0.1):
    """t = g·act'(x·k + b) in x's dtype, as the plain backward computes it:
    dx = t·k, dk = Σ t·x, db = Σ t."""
    return g * act_grad(x * k.to(x.dtype) + b.to(x.dtype), act, slope)


def reference_scale_bias_act_bwd(x, k, b, g, act="leaky_relu", slope=0.1, needs=(True, True, True)):
    """The plain backward, ``pallas_fused.py::_bwd`` in x's dtype: (dx, dk,
    db) for the output cotangent g, each None where ``needs`` (dx, dk, db)
    does not ask for it."""
    t = reference_bwd_t(x, k, b, g, act, slope)
    axes = tuple(range(x.dim() - 1))
    dx = (t * k.to(x.dtype)).to(x.dtype) if needs[0] else None
    dk = torch.sum(t * x, dim=axes).to(k.dtype) if needs[1] else None
    db = torch.sum(t, dim=axes).to(b.dtype) if needs[2] else None
    return dx, dk, db


_bound = None  # (forward, backward, backward's plan) entry points, bound once
_plans: dict = {}


def _lib():
    """The bound C entry points (forward, backward, backward's plan), built
    and bound at the first call."""
    global _bound
    if _bound is None:
        lib = build.load("scale_bias_act")
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        fwd, bwd, plan = lib.scale_bias_act_launch, lib.scale_bias_act_bwd_launch, lib.scale_bias_act_bwd_plan
        fwd.argtypes = [p, p, p, p, ll, i, i, i, f, p]
        bwd.argtypes = [p, p, p, p, p, p, p, p, i, ll, i, i, i, f, i, p]
        plan.argtypes = [ll, i, i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(ll)]
        fwd.restype = bwd.restype = plan.restype = i
        _bound = (fwd, bwd, plan)
    return _bound


def bwd_plan(m, c, dtype, act, flags, aligned, lib=None):
    """The backward kernel's grid for m rows of c channels (what the C side
    chooses): (blocks, the workspace rows of 2·c floats that dk and db
    need; depth, the most float32 additions any term goes through on its
    way into dk or db). ``flags`` as the kernel's (dx 1, dk 2, db 4);
    ``aligned`` whether x, g and dx are all 16-byte aligned."""
    fn = (lib or _lib())[2]
    key = (m, c, dtype, act, flags, aligned, id(fn))
    plan = _plans.get(key)
    if plan is None:
        blocks, depth = ctypes.c_int(), ctypes.c_longlong()
        rc = fn(m, c, _DTYPES[dtype], ACTS[act], flags, int(aligned), ctypes.byref(blocks), ctypes.byref(depth))
        if rc != 0:
            raise RuntimeError(f"scale_bias_act backward plan failed: cudaError {rc}")
        plan = _plans[key] = (blocks.value, depth.value)
    return plan


def scale_bias_act(x, k, b, act="leaky_relu", slope=0.1):
    """``act(x·k + b)`` per channel (last axis), differentiable in x, k and
    b. CPU tensors take the plain versions; CUDA tensors take the Hopper
    kernels."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}; expected one of {sorted(ACTS)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scale_bias_act takes cpu or cuda tensors, got {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or k.requires_grad or b.requires_grad):
        return _ScaleBiasAct.apply(x, k, b, act, float(slope))
    return scale_bias_act_op(x, k, b, act, float(slope))


def _forward_op(x, k, b, act, slope):
    return _forward(x, k, b, act, slope)


def _forward_fake(x, k, b, act, slope):
    return x.new_empty(x.shape)


# The forward as an operator: ``_forward`` for CPU tensors (the plain version)
# and CUDA tensors (one launch of the kernel, counted in ``launches``, or an
# error), a shape-only fake for tracing. Registered through the
# ``torch.library.Library`` API, which dispatches straight to ``_forward``;
# ``torch.library.custom_op`` would wrap each call in autograd and dynamo
# guards and import torch._dynamo at a process's first call.
_LIB = torch.library.Library("triplegan_torch", "FRAGMENT")  # kept: registrations live with it
_LIB.define("scale_bias_act(Tensor x, Tensor k, Tensor b, str act, float slope) -> Tensor")
for _key in ("CPU", "CUDA"):
    _LIB.impl("scale_bias_act", _forward_op, _key)
torch.library.register_fake("triplegan_torch::scale_bias_act", _forward_fake, lib=_LIB)
scale_bias_act_op = torch.ops.triplegan_torch.scale_bias_act.default


class _ScaleBiasAct(torch.autograd.Function):
    """``pallas_fused.py::scale_bias_act`` with its custom VJP."""

    @staticmethod
    def forward(ctx, x, k, b, act, slope):
        ctx.save_for_backward(x, k, b)
        ctx.act, ctx.slope = act, slope
        return scale_bias_act_op(x, k, b, act, slope)

    @staticmethod
    def backward(ctx, g):
        x, k, b = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad[:3])
        if x.device.type == "cpu":
            dx, dk, db = reference_scale_bias_act_bwd(x, k, b, g, ctx.act, ctx.slope, needs)
        else:
            dx, dk, db = _backward(x, k, b, g, ctx.act, ctx.slope, needs)
        return dx, dk, db, None, None


def _check_cuda(x, k, b):
    """What both kernels take: a non-empty contiguous float32 or bfloat16 x
    on a CUDA device and (C,) k and b on the same device."""
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
        if v.shape != (c,):
            raise ValueError(f"{name} must have shape ({c},), got {tuple(v.shape)}")
    return c


def _launch(fn, dev: torch.device, *args) -> int:
    """Call a C entry point with ``dev``'s current stream as its last
    argument, on ``dev`` (a device switch only where ``dev`` is not the
    current device)."""
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)


def _forward(x, k, b, act, slope, lib=None):
    """The forward alone: the plain version for a CPU tensor, else one
    launch of the kernel (of ``lib``'s entry points where given, as
    ``_lib()`` returns them)."""
    if x.device.type == "cpu":
        return reference_scale_bias_act(x, k, b, act, slope)
    c = _check_cuda(x, k, b)
    kc = k.to(x.dtype).contiguous()
    bc = b.to(x.dtype).contiguous()
    y = torch.empty_like(x)
    rc = _launch((lib or _lib())[0], x.device, x.data_ptr(), kc.data_ptr(), bc.data_ptr(), y.data_ptr(),
                 x.numel() // c, c, _DTYPES[x.dtype], ACTS[act], slope)
    if rc != 0:
        raise RuntimeError(f"scale_bias_act kernel launch failed: cudaError {rc}")
    launches[tuple(x.shape), _DTYPE_NAMES[x.dtype], act, slope] += 1
    return y


def _backward(x, k, b, g, act, slope, needs, lib=None):
    """(dx, dk, db) of a CUDA x for the cotangent g, by one launch of the
    backward kernel (with its reduce where dk or db is asked for); None
    where ``needs`` does not ask. ``lib`` as for ``_forward``."""
    c = _check_cuda(x, k, b)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must match x ({tuple(x.shape)} {x.dtype}), got {tuple(g.shape)} {g.dtype}")
    flags = sum(1 << i for i, n in enumerate(needs) if n)
    if not flags:
        return None, None, None
    lib = lib or _lib()
    m = x.numel() // c
    g = g.contiguous()
    kc = k.to(x.dtype).contiguous()
    bc = b.to(x.dtype).contiguous()
    dx = torch.empty_like(x) if needs[0] else None
    kb = ws = None
    ws_blocks = 0
    if needs[1] or needs[2]:
        aligned = (x.data_ptr() | g.data_ptr() | (0 if dx is None else dx.data_ptr())) % 16 == 0
        ws_blocks = bwd_plan(m, c, x.dtype, act, flags, aligned, lib)[0]
        kb = torch.empty((2, c), dtype=x.dtype, device=x.device)
        ws = torch.empty((ws_blocks, 2 * c), dtype=torch.float32, device=x.device)
    kb_ptr = None if kb is None else kb.data_ptr()
    rc = _launch(lib[1], x.device, x.data_ptr(), kc.data_ptr(), bc.data_ptr(), g.data_ptr(),
                 None if dx is None else dx.data_ptr(), kb_ptr,
                 None if kb is None else kb_ptr + c * x.element_size(),
                 None if ws is None else ws.data_ptr(), ws_blocks, m, c,
                 _DTYPES[x.dtype], ACTS[act], slope, flags)
    if rc != 0:
        raise RuntimeError(f"scale_bias_act backward kernel launch failed: cudaError {rc}")
    bwd_launches[tuple(x.shape), _DTYPE_NAMES[x.dtype], act, slope,
                 "".join(n for n, want in zip(_NEEDS, needs) if want)] += 1
    dk = kb[0].to(k.dtype) if needs[1] else None
    db = kb[1].to(b.dtype) if needs[2] else None
    return dx, dk, db


# ---------------------------------------------------------------------------
# Per-sample scale and bias: the class-conditional batch norm's epilogue
# ---------------------------------------------------------------------------

# Launches of the per-sample kernels since the counts were last cleared,
# keyed as ``launches`` and ``bwd_launches`` are.
cond_launches: collections.Counter = collections.Counter()
cond_bwd_launches: collections.Counter = collections.Counter()


def _per_sample(v, x):
    """(N, C) ``v`` in x's dtype, shaped to broadcast over x's middle axes."""
    return v.to(x.dtype).reshape((x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],))


def reference_scale_bias_act_cond(x, k, b, act="relu", slope=0.1):
    """The plain version of ``scale_bias_act_cond``: x (N, ..., C), k and b
    (N, C), ``reference_scale_bias_act``'s casts and float32 math."""
    ct = torch.promote_types(x.dtype, torch.float32)
    z = x.to(ct) * _per_sample(k, x).to(ct) + _per_sample(b, x).to(ct)
    return apply_act(z, act, slope).to(x.dtype)


def reference_scale_bias_act_cond_bwd(x, k, b, g, act="relu", slope=0.1, needs=(True, True, True)):
    """The plain backward, in x's dtype as ``reference_scale_bias_act_bwd``:
    t = g·act'(x·k_n + b_n), dx = t·k_n, dk and db summed over each sample's
    middle axes, (N, C); None where ``needs`` does not ask."""
    kn = _per_sample(k, x)
    t = g * act_grad(x * kn + _per_sample(b, x), act, slope)
    axes = tuple(range(1, x.dim() - 1))
    dx = (t * kn).to(x.dtype) if needs[0] else None
    dk = torch.sum(t * x, dim=axes).to(k.dtype) if needs[1] else None
    db = torch.sum(t, dim=axes).to(b.dtype) if needs[2] else None
    return dx, dk, db


def scale_bias_act_cond(x, k, b, act="relu", slope=0.1):
    """``act(x·k_n + b_n)`` with k and b given per sample, (N, C) for x of
    (N, ..., C): differentiable in x, k and b, k and b cast to x's dtype
    as ``scale_bias_act``'s. CPU tensors take the plain versions, CUDA
    tensors the per-sample kernels (``cbn_*`` in ``csrc/scale_bias_act.cu``)."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}; expected one of {sorted(ACTS)}")
    if torch.is_grad_enabled() and (x.requires_grad or k.requires_grad or b.requires_grad):
        return _ScaleBiasActCond.apply(x, k, b, act, float(slope))
    return _cond_forward(x, k, b, act, float(slope))


class _ScaleBiasActCond(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, b, act, slope):
        ctx.save_for_backward(x, k, b)
        ctx.act, ctx.slope = act, slope
        return _cond_forward(x, k, b, act, slope)

    @staticmethod
    def backward(ctx, g):
        x, k, b = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad[:3])
        if x.device.type == "cpu":
            dx, dk, db = reference_scale_bias_act_cond_bwd(x, k, b, g, ctx.act, ctx.slope, needs)
        else:
            dx, dk, db = _cond_backward(x, k, b, g, ctx.act, ctx.slope, needs)
        return dx, dk, db, None, None


_cond_bound = None  # the per-sample (forward, backward, backward's plan), bound once


def _cond_lib():
    global _cond_bound
    if _cond_bound is None:
        lib = build.load("scale_bias_act")
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        fwd, bwd = lib.scale_bias_act_cond_launch, lib.scale_bias_act_cond_bwd_launch
        plan = lib.scale_bias_act_cond_bwd_plan
        fwd.argtypes = [p, p, p, p, ll, ll, i, i, i, f, p]
        bwd.argtypes = [p, p, p, p, p, p, p, p, ll, ll, ll, i, i, i, f, i, p]
        plan.argtypes = [ll, ll, i, i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(ll)]
        fwd.restype = bwd.restype = plan.restype = i
        _cond_bound = (fwd, bwd, plan)
    return _cond_bound


def cond_bwd_plan(n, hw, c, dtype, act, flags, aligned):
    """The per-sample backward's grid, as ``bwd_plan``'s: (a sample's
    blocks, so n times as many workspace rows of 2·c floats; the depth of
    its sums)."""
    key = ("cond", n, hw, c, dtype, act, flags, aligned)
    plan = _plans.get(key)
    if plan is None:
        blocks, depth = ctypes.c_int(), ctypes.c_longlong()
        rc = _cond_lib()[2](n, hw, c, _DTYPES[dtype], ACTS[act], flags, int(aligned), ctypes.byref(blocks),
                            ctypes.byref(depth))
        if rc != 0:
            raise RuntimeError(f"scale_bias_act_cond backward plan failed: cudaError {rc}")
        plan = _plans[key] = (blocks.value, depth.value)
    return plan


def _check_cond_cuda(x, k, b):
    """What the per-sample kernels take: ``_check_cuda``'s x, at least 2-D,
    and (N, C) k and b on its device: (N, rows a sample, C)."""
    if x.device.type != "cuda":
        raise ValueError(f"scale_bias_act_cond takes cpu or cuda tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"scale_bias_act_cond kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"scale_bias_act_cond needs a non-empty (N, ..., C) tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("scale_bias_act_cond kernel needs a contiguous x")
    n, c = x.shape[0], x.shape[-1]
    for name, v in (("k", k), ("b", b)):
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if v.shape != (n, c):
            raise ValueError(f"{name} must have shape ({n}, {c}), got {tuple(v.shape)}")
    return n, x.numel() // (n * c), c


def _cond_forward(x, k, b, act, slope):
    if x.device.type == "cpu":
        return reference_scale_bias_act_cond(x, k, b, act, slope)
    n, hw, c = _check_cond_cuda(x, k, b)
    kc, bc = k.to(x.dtype).contiguous(), b.to(x.dtype).contiguous()
    y = torch.empty_like(x)
    rc = _launch(_cond_lib()[0], x.device, x.data_ptr(), kc.data_ptr(), bc.data_ptr(), y.data_ptr(), n, hw, c,
                 _DTYPES[x.dtype], ACTS[act], slope)
    if rc != 0:
        raise RuntimeError(f"scale_bias_act_cond kernel launch failed: cudaError {rc}")
    cond_launches[tuple(x.shape), _DTYPE_NAMES[x.dtype], act, slope] += 1
    return y


def _cond_backward(x, k, b, g, act, slope, needs):
    n, hw, c = _check_cond_cuda(x, k, b)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must match x ({tuple(x.shape)} {x.dtype}), got {tuple(g.shape)} {g.dtype}")
    flags = sum(1 << i for i, want in enumerate(needs) if want)
    if not flags:
        return None, None, None
    g = g.contiguous()
    kc, bc = k.to(x.dtype).contiguous(), b.to(x.dtype).contiguous()
    dx = torch.empty_like(x) if needs[0] else None
    kb = ws = None
    ws_blocks = 0
    if needs[1] or needs[2]:
        aligned = (x.data_ptr() | g.data_ptr() | (0 if dx is None else dx.data_ptr())) % 16 == 0
        ws_blocks = n * cond_bwd_plan(n, hw, c, x.dtype, act, flags, aligned)[0]
        kb = torch.empty((2, n, c), dtype=x.dtype, device=x.device)
        ws = torch.empty((ws_blocks, 2 * c), dtype=torch.float32, device=x.device)
    rc = _launch(_cond_lib()[1], x.device, x.data_ptr(), kc.data_ptr(), bc.data_ptr(), g.data_ptr(),
                 None if dx is None else dx.data_ptr(), None if kb is None else kb[0].data_ptr(),
                 None if kb is None else kb[1].data_ptr(), None if ws is None else ws.data_ptr(), ws_blocks,
                 n, hw, c, _DTYPES[x.dtype], ACTS[act], slope, flags)
    if rc != 0:
        raise RuntimeError(f"scale_bias_act_cond backward kernel launch failed: cudaError {rc}")
    cond_bwd_launches[tuple(x.shape), _DTYPE_NAMES[x.dtype], act, slope,
                      "".join(name for name, want in zip(_NEEDS, needs) if want)] += 1
    dk = kb[0].to(k.dtype) if needs[1] else None
    db = kb[1].to(b.dtype) if needs[2] else None
    return dx, dk, db
