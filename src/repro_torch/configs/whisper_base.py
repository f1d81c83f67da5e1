"""whisper-base [audio]: enc-dec, 6L each, d=512 8H d_ff=2048 vocab=51865.

[arXiv:2212.04356; unverified] — copied literally from
``repro.configs.whisper_base``. The conv frontend is a stub: the batch carries
precomputed (B, 1500, 512) frame embeddings (``enc_frames``), which a 6-layer
bidirectional encoder turns into the keys and values of each decoder layer's
cross-attention. ~0.10 B parameters, 0.2 GB in bf16: served whole on one card.
"""
import dataclasses

from repro_torch.models.config import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    encoder=EncoderConfig(n_layers=6, n_frames=1500),
    max_seq_len=32_768,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
    vocab_size=256, encoder=EncoderConfig(n_layers=2, n_frames=32),
    max_seq_len=512,
)
