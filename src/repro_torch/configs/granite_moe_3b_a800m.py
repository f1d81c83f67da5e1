"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) d_ff_expert=512
vocab=49155, MoE 40 experts top-8, every layer.

[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf] — SwiGLU experts,
copied literally from ``repro.configs.granite_moe_3b_a800m``. Every layer is
attention followed by an MoE sub-layer, with a tied embedding: ~3.3 B
parameters, ~6.6 GB in bf16, so the port serves it on one card at full width
and full depth, with no cut.
"""
import dataclasses

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=0,  # every MLP is MoE
    vocab_size=49155,
    activation="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512, every_k_layers=1),
    tie_embeddings=True,
    max_seq_len=32_768,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=256,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64, every_k_layers=1),
    max_seq_len=512,
)
