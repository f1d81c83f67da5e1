"""gemma3-12b [dense]: 48L d=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.

[hf:google/gemma-3-1b-pt family; unverified] — copied literally from
``repro.configs.gemma3_12b``: 5:1 local:global attention, sliding window
1024, qk-norm, tied embeddings. 48 layers are 8 repeats of the 6-layer
(5 local + 1 global) unit. ~11.8 B parameters, 23.5 GB in bf16: served whole
on one card.
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    sliding_window=1024,
    local_global_ratio=(5, 1),
    max_seq_len=524_288,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=6, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
    d_ff=256, vocab_size=256, sliding_window=64, max_seq_len=512,
)
