"""The depthwise causal convolution shared by the xLSTM and Mamba blocks.

Counterpart of the first part of ``repro.models.xlstm`` (``_conv_init`` and
``_causal_conv``), which ``repro_torch.models.mamba`` imports from here as the
reference's mamba module does. The mLSTM and sLSTM blocks and their decode
states are not ported yet: they come with the xlstm slice (ROADMAP.md A.3).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.models.layers import truncated_normal

__all__ = ["CONV"]

CONV = 4  # causal conv width


def _conv_init(
    gen: torch.Generator, width: int, channels: int, dtype: torch.dtype, device,
    lead: Sequence[int] = (),
) -> torch.Tensor:
    """``(*lead, width, channels)`` taps with std ``1/sqrt(width)``."""
    return truncated_normal(gen, (*lead, width, channels), 1.0 / math.sqrt(width), dtype, device)


def _causal_conv(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, T, C), w (W, C).

    The taps are summed in ``x``'s dtype from zero in tap order ``i = 0..W-1``,
    as the reference does, so bf16 rounds at the same places.
    """
    W, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i : i + T, :] * w[W - 1 - i][None, None, :]
    return out
