"""mixtral-8x7b [moe]: 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2 every layer, sliding-window attention (4096).

[arXiv:2401.04088; hf] — copied literally from ``repro.configs.mixtral_8x7b``.
The pattern unit is one layer (windowed attention, then the MoE). The full
32 layers (~46.7 B parameters, 93.4 GB in bf16) do not fit one card, so the
port serves it cut in depth to whole units (``serve(..., n_layers=16)``,
46.9 GB: one stage of a two-stage pipeline).
"""
import dataclasses

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,  # every MLP is MoE (d_ff_expert below)
    vocab_size=32000,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336, every_k_layers=1),
    max_seq_len=524_288,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=256,
    sliding_window=64,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128, every_k_layers=1),
    max_seq_len=512,
)
