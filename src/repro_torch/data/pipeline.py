"""Synthetic-but-deterministic LM data pipeline (counterpart of ``repro.data.pipeline``).

There is no corpus, so the pipeline synthesizes a Zipf-distributed, seeded
token stream that is:

* deterministic in (seed, step, global position) — restart-safe: resuming
  from a checkpoint at step k regenerates exactly the batches k, k+1, ...,
* host-sharded — each process materializes only its slice of the batch,
* shaped by the arch config (modality stubs included: whisper frame
  embeddings, VLM patch embeddings).

The batches are numpy, made exactly as the reference makes them, so both
packages train on the same arrays bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.models.config import ArchConfig

__all__ = ["SyntheticLM", "make_batch_specs"]


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf-ish token draw (realistic softmax/embedding access patterns)."""
    u = rng.random(size=shape)
    ranks = np.floor(np.exp(u * np.log(vocab))).astype(np.int64)
    return (ranks % vocab).astype(np.int32)


@dataclasses.dataclass
class SyntheticLM:
    cfg: ArchConfig
    global_batch: int
    seq_len: int
    seed: int = 0

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        """Full global batch (one host). Deterministic in step."""
        return self.shard_for_step(step, 0, 1)

    def shard_for_step(
        self, step: int, host_index: int, host_count: int
    ) -> Dict[str, np.ndarray]:
        assert self.global_batch % host_count == 0
        b = self.global_batch // host_count
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + host_index
        )
        cfg = self.cfg
        text_len = self.seq_len - (cfg.vision_tokens if cfg.vision_tokens else 0)
        tokens = _zipf_tokens(rng, (b, text_len + 1), cfg.vocab_size)
        out: Dict[str, np.ndarray] = {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:],
        }
        if cfg.encoder is not None:
            out["enc_frames"] = rng.standard_normal(
                (b, cfg.encoder.n_frames, cfg.d_model), dtype=np.float32
            )
        if cfg.vision_tokens:
            out["img_embeds"] = rng.standard_normal(
                (b, cfg.vision_tokens, cfg.d_model), dtype=np.float32
            )
        return out


def make_batch_specs(
    cfg: ArchConfig, global_batch: int, seq_len: int, for_training: bool = True
) -> Dict[str, torch.Tensor]:
    """Meta tensors standing in for every model input: shapes and dtypes, no data."""
    text_len = seq_len - (cfg.vision_tokens if cfg.vision_tokens else 0)

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs: Dict[str, torch.Tensor] = {"tokens": spec((global_batch, text_len), torch.int32)}
    if for_training:
        specs["labels"] = spec((global_batch, text_len), torch.int32)
    if cfg.encoder is not None:
        frames = (global_batch, cfg.encoder.n_frames, cfg.d_model)
        specs["enc_frames"] = spec(frames, torch.bfloat16)
    if cfg.vision_tokens:
        specs["img_embeds"] = spec((global_batch, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
    return specs
