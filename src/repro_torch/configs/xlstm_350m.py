"""xlstm-350m [ssm]: 24L d=1024 4H, sLSTM + mLSTM blocks (xLSTM[7:1]).

[arXiv:2405.04517; unverified] — copied literally from
``repro.configs.xlstm_350m``. d_ff=0 (blocks are self-contained), vocab
50304. One pattern unit is 8 layers (mLSTM x7, sLSTM); three repeats. About
524 M parameters (1.05 GB in bf16): it fits one card at full width and full
depth.
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern="xlstm",
    xlstm_slstm_every=8,  # xLSTM[7:1]
    norm="rmsnorm",
    tie_embeddings=False,
    max_seq_len=524_288,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=2, vocab_size=256, max_seq_len=512
)
