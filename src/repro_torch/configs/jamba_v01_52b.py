"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
Mamba+attention 1:7 interleave, MoE 16 experts top-2 every other layer.

[arXiv:2403.19887; hf:ai21labs/Jamba-v0.1] — copied literally from
``repro.configs.jamba_v01_52b``. One pattern unit is 8 layers (mamba x4, attn,
mamba x3; MoE at odd positions). The full 32 layers (~103 GB in bf16) do not
fit one card, so the port serves it cut in depth to whole units
(``serve(..., n_layers=8)``).
"""
import dataclasses

from repro_torch.models.config import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    activation="swiglu",
    norm="rmsnorm",
    block_pattern="jamba",
    attn_every_k=8,  # 1:7 attention:mamba
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336, every_k_layers=2),
    max_seq_len=524_288,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128, every_k_layers=2),
    max_seq_len=512,
)
