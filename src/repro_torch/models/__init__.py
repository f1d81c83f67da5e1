"""Model substrate of the port (counterpart of ``repro.models``).

* :mod:`repro_torch.models.config`      — ArchConfig (a copy of the reference's)
* :mod:`repro_torch.models.layers`      — norms, rope, MLPs, embeddings
* :mod:`repro_torch.models.attention`   — GQA full/sliding-window attention, decode,
  cross-attention
* :mod:`repro_torch.models.mamba`       — Mamba selective-SSM mixer, decode state
* :mod:`repro_torch.models.moe`         — top-k MoE with sorted capacity dispatch
* :mod:`repro_torch.models.xlstm`       — mLSTM and sLSTM blocks, and the causal conv the mamba mixer shares
* :mod:`repro_torch.models.transformer` — the block-pattern model builder
* :mod:`repro_torch.models.convert`     — the reference's parameters for the port
"""

from repro_torch.models.config import ArchConfig, EncoderConfig, MambaConfig, MoEConfig
from repro_torch.models.transformer import (
    abstract_params,
    decode_step,
    encode,
    forward,
    init_cache,
    init_params,
    loss_fn,
)

__all__ = [
    "ArchConfig",
    "MoEConfig",
    "MambaConfig",
    "EncoderConfig",
    "init_params",
    "forward",
    "loss_fn",
    "init_cache",
    "decode_step",
    "encode",
    "abstract_params",
]
