"""Device selection for the port's entry points.

Every entry point takes ``device=None`` and resolves it here: ``None`` means
the CUDA card, and a machine without one raises instead of quietly running
on the CPU. The CPU runs only when the caller asks for it (the tests do).
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` by default; raise if it is absent. ``"cpu"`` only on request.

    On the card, float32 matmuls and convolutions run in full float32 (no
    TF32) and bf16 matmuls reduce in float32, because the JAX reference
    accumulates in float32 (``preferred_element_type=float32``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev

