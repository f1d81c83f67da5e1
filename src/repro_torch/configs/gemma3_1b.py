"""gemma3-1b [dense]: 26L d=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.

[hf:google/gemma-3-1b-pt; unverified] — 5:1 local:global, window 512,
qk-norm, tied embeddings. Copied literally from ``repro.configs.gemma3_1b``.
26 is not a multiple of the 6-layer (5 local + 1 global) pattern, so
``pattern_unit`` yields all 26 layers as one unit with one repeat; the global
layers sit at indices 5, 11, 17 and 23.
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    sliding_window=512,
    local_global_ratio=(5, 1),
    max_seq_len=524_288,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=13, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
    d_ff=256, vocab_size=256, sliding_window=64, max_seq_len=512,
)
