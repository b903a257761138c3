"""Device selection for the port.

The port runs on the card unless the caller asks for the CPU. There is no
silent fallback: asking for CUDA (the default) on a machine without a CUDA
device raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` → the current CUDA device, raising
    ``RuntimeError`` when there is none; ``"cpu"`` only when asked for.

    This is also the one place that pins float32 to full float32: cuBLAS
    and cuDNN would otherwise be free to run float32 matmuls and convs in
    TF32, which keeps about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (CLI: "
                "--device cpu) to run on the CPU explicitly"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
