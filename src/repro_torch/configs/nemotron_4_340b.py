"""nemotron-4-340b [dense]: 96L d=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.

[arXiv:2402.16819; unverified] — copied literally from
``repro.configs.nemotron_4_340b``: LayerNorm, a squared-ReLU MLP (no gate),
GQA 96/8 at head dim 192 (carried in flash attention's bf16 D 256 tile) and
untied embeddings. ~341 B parameters, 682 GB in bf16: one layer is 6.9 GB and
the embedding and unembedding 18.9 GB together, so the port serves it cut in
depth to whole one-layer units (``serve(..., n_layers=6)``, 60.3 GB).
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    activation="sq_relu",
    norm="layernorm",
    rope_theta=10_000.0,
    max_seq_len=32_768,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, d_ff=512,
    vocab_size=256, max_seq_len=512,
)
