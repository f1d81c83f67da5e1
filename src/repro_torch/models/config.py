"""Architecture configuration covering every assigned arch family.

One frozen dataclass drives the whole substrate: dense transformers
(nemotron/gemma/stablelm/phi-backbone), MoE (granite/mixtral/jamba), SSM
(xlstm), hybrid (jamba), encoder-decoder (whisper) and VLM stubs.

A literal copy of ``repro.models.config`` (pure dataclasses): the port keeps
its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

__all__ = ["ArchConfig", "MoEConfig", "MambaConfig", "EncoderConfig", "LayerKind"]


# layer kinds used by block patterns
class LayerKind:
    ATTN = "attn"            # full (global) attention + MLP
    LOCAL_ATTN = "local"     # sliding-window attention + MLP
    MAMBA = "mamba"          # mamba mixer + MLP
    MLSTM = "mlstm"          # xLSTM matrix-memory block (self-contained)
    SLSTM = "slstm"          # xLSTM scalar-memory block (self-contained)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    every_k_layers: int = 1  # MoE MLP every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder for enc-dec (whisper): full bidirectional attention."""

    n_layers: int
    n_frames: int  # precomputed frame embeddings (conv frontend is a stub)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    activation: str = "swiglu"  # swiglu | geglu | gelu | sq_relu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    qk_norm: bool = False

    # attention pattern
    sliding_window: Optional[int] = None
    local_global_ratio: Optional[Tuple[int, int]] = None  # (local, global)

    # substrate options
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    block_pattern: Optional[str] = None  # None | "jamba" | "xlstm"
    attn_every_k: int = 8  # jamba: attention layer every k layers
    xlstm_slstm_every: int = 8  # xLSTM[7:1]: one sLSTM block per 8

    # encoder-decoder / multimodal stubs
    encoder: Optional[EncoderConfig] = None
    vision_tokens: int = 0  # VLM: precomputed patch embeddings prepended

    # numerics / compile strategy
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: str = "block"  # none | block
    use_pallas: bool = False  # TPU target; CPU uses the jnp reference path
    max_seq_len: int = 131_072

    # ----------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0
        return self.n_heads // max(self.n_kv_heads, 1)

    def layer_kinds(self) -> Sequence[str]:
        """The per-layer kind sequence implied by the block pattern."""
        kinds = []
        if self.block_pattern == "xlstm":
            for i in range(self.n_layers):
                if (i + 1) % self.xlstm_slstm_every == 0:
                    kinds.append(LayerKind.SLSTM)
                else:
                    kinds.append(LayerKind.MLSTM)
        elif self.block_pattern == "jamba":
            for i in range(self.n_layers):
                # one attention layer per attn_every_k, placed mid-unit
                if i % self.attn_every_k == self.attn_every_k // 2:
                    kinds.append(LayerKind.ATTN)
                else:
                    kinds.append(LayerKind.MAMBA)
        elif self.local_global_ratio is not None:
            loc, glob = self.local_global_ratio
            unit = [LayerKind.LOCAL_ATTN] * loc + [LayerKind.ATTN] * glob
            for i in range(self.n_layers):
                kinds.append(unit[i % len(unit)])
        else:
            kinds = [LayerKind.ATTN] * self.n_layers
        return tuple(kinds)

    def layer_is_moe(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        k = self.moe.every_k_layers
        return (layer_idx % k) == (k - 1)

    def pattern_unit(self) -> Tuple[Tuple[str, bool], ...]:
        """The repeating (kind, is_moe) unit used for layer-stack scanning."""
        if self.n_layers == 0:  # cost-mode "mini0": embed + head only
            return ()
        kinds = self.layer_kinds()
        moes = [self.layer_is_moe(i) for i in range(self.n_layers)]
        pairs = tuple(zip(kinds, moes, strict=True))
        # find the smallest repeating unit
        for size in range(1, self.n_layers + 1):
            if self.n_layers % size:
                continue
            unit = pairs[:size]
            if all(
                pairs[i] == unit[i % size] for i in range(self.n_layers)
            ):
                return unit
        return pairs  # no repetition; treated as a single unit

    @property
    def num_pattern_repeats(self) -> int:
        unit = self.pattern_unit()
        return self.n_layers // len(unit) if unit else 0

    # parameter counting (used for MODEL_FLOPS = 6*N*D) -----------------
    def param_count(self, active_only: bool = False) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        total = v * d  # embeddings
        if not self.tie_embeddings:
            total += v * d
        kinds = self.layer_kinds()
        for i, kind in enumerate(kinds):
            if kind in ("attn", "local"):
                total += d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
            elif kind == "mamba":
                mc = self.mamba or MambaConfig()
                di = mc.expand * d
                dtr = mc.dt_rank or max(d // 16, 1)
                total += d * 2 * di  # in-proj
                total += di * mc.d_conv  # conv
                total += di * (dtr + 2 * mc.d_state)  # x -> dt, B, C
                total += dtr * di + di * mc.d_state  # dt proj + A
                total += di * d  # out-proj
            elif kind == "mlstm":
                di = 2 * d
                total += d * 2 * di + di * 4  # up-proj (x,z) + conv
                total += 3 * di * di // max(self.n_heads, 1) * self.n_heads  # qkv
                total += 3 * di  # gates (i,f,o) per-channel proj approx
                total += di * d  # down-proj
            elif kind == "slstm":
                total += 4 * d * d + int(d * 4 / 3 * d) * 2
            # MLP (attention/mamba layers carry an MLP; xlstm blocks do not)
            if kind in ("attn", "local", "mamba"):
                if self.layer_is_moe(i):
                    fe = self.moe.d_ff_expert  # type: ignore[union-attr]
                    n_mats = 3 if self.activation in ("swiglu", "geglu") else 2
                    per_expert = n_mats * d * fe
                    cnt = self.moe.top_k if active_only else self.moe.num_experts  # type: ignore[union-attr]
                    total += cnt * per_expert + d * self.moe.num_experts  # type: ignore[union-attr]
                elif f > 0:
                    n_mats = 3 if self.activation in ("swiglu", "geglu") else 2
                    total += n_mats * d * f
            # norms
            total += 2 * d
        if self.encoder is not None:
            enc = self.encoder
            # encoder layers: attn + mlp, plus cross-attention in decoder
            total += enc.n_layers * (4 * d * hd * nq // max(nq, 1) * 1)
            total += enc.n_layers * (2 * d * f if self.activation not in ("swiglu", "geglu") else 3 * d * f)
            total += enc.n_layers * (4 * d * d)
            total += self.n_layers * (4 * d * d)  # decoder cross-attn
        return int(total)
