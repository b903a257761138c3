"""Device selection for the port, and the matmul precision it pins.

The port runs on the card unless the caller asks for the CPU. There is no
silent fallback: asking for CUDA (the default) on a machine without a CUDA
device raises.
"""

from __future__ import annotations

import os

import torch


def pin_precision() -> None:
    """Pin the matmuls' precision to what XLA computes. cuBLAS and cuDNN
    would otherwise be free to run float32 matmuls and convs in TF32, which
    keeps about three decimal digits, and cuBLAS to reduce a bfloat16
    matmul's partial sums in bfloat16; XLA sums both in float32, so the
    bfloat16 dense layers (``nn/layers.py::dense_apply``) would round
    differently from the JAX package's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` → the card of this process: ``cuda:LOCAL_RANK``
    under torchrun (one process a card), else the current CUDA device;
    ``RuntimeError`` when there is none, or when ``LOCAL_RANK`` names a card
    past the count. An explicit ``"cuda:N"`` is taken as it is; ``"cpu"``
    only when asked for. Every entry point passes here, so this is where
    ``pin_precision`` runs."""
    pin_precision()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (CLI: "
                "--device cpu) to run on the CPU explicitly"
            )
        if dev.index is None and "LOCAL_RANK" in os.environ:
            local, count = int(os.environ["LOCAL_RANK"]), torch.cuda.device_count()
            if local >= count:
                raise RuntimeError(
                    f"LOCAL_RANK={local} but this machine has {count} CUDA device(s): launch at most "
                    f"{count} processes a machine (torchrun --nproc-per-node {count}), or pass an "
                    f"explicit device (--device cuda:N)")
            dev = torch.device("cuda", local)
        elif dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
