"""Explicit device resolution and the float32 precision pins.

Every entry point of the port resolves its device through
:func:`resolve_device`: ``cuda`` (the default of the CLIs) raises when no
card is visible, and the CPU is used only when asked for by name. The same
call pins TF32 off, because the reference's f32 contractions run at full
precision (tfkaldi_tpu/ops/fused_mlp.py:48-53).
"""

from __future__ import annotations

import torch


def pin_precision() -> None:
    """Full-precision f32 matmuls and convolutions (no TF32), and f32
    reductions inside cuBLAS's bf16 GEMMs (``layers.product``'s tensor-core
    route)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` → a ``torch.device``; raises if
    a CUDA device is asked for and none is available."""
    pin_precision()
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() is False; "
                "pass --device cpu to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (want cuda, cuda:N or cpu)")
    return device
