"""phi-3-vision-4.2b [vlm]: 32L d=3072 32H (MHA kv=32) d_ff=8192 vocab=32064,
phi3-mini backbone + CLIP frontend (stub: precomputed patch embeddings).

[hf:microsoft/Phi-3-vision-128k-instruct; hf] — copied literally from
``repro.configs.phi3_vision_4_2b``. The modality frontend is a stub: the batch
carries (B, 576, 3072) patch embeddings (``img_embeds``), prepended to the
text before the blocks and cut off after the final norm. Head dim 96 (carried
in flash attention's D 128 tile). ~3.8 B parameters, 7.6 GB in bf16: served
whole on one card.
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    vision_tokens=576,
    max_seq_len=131_072,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, vision_tokens=16, max_seq_len=512,
)
