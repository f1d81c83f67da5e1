"""stablelm-3b [dense]: 32L d=2560 32H (MHA kv=32) d_ff=6912 vocab=50304.

[hf:stabilityai/stablelm-2-1_6b family; unverified] — copied literally from
``repro.configs.stablelm_3b``: LayerNorm + SwiGLU, full causal attention at
head dim 80 (carried in flash attention's D 128 tile). ~2.8 B parameters,
5.6 GB in bf16: served whole on one card.
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    activation="swiglu",
    norm="layernorm",
    rope_theta=10_000.0,
    max_seq_len=32_768,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_ff=384,
    vocab_size=256, max_seq_len=512,
)
