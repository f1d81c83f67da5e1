"""The shape of a configuration, read from its file under ``perfbench/configs``.

Everything here comes from the file's published keys (``hidden_size``,
``num_attention_heads``, ``attn_layer_period`` ...), never from the program:
the work arithmetic, the plain references and the check of the program's own
config all start from it. Pure Python.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Shape", "shape_of", "lookup"]


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes of one configuration and the kind of each layer."""

    n_layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    window: Optional[int]
    rope_theta: Optional[float]
    eps: float
    experts: int
    top_k: int
    expert_ff: int
    dense_ff: int
    capacity_factor: float
    renormalize: bool  # top-k router weights divided by their sum
    mamba_inner: int
    mamba_state: int
    mamba_conv: int
    mamba_dt_rank: int
    embed_scale: float
    layers: Tuple[Tuple[str, bool], ...]  # (kind "attention" | "mamba", is_moe) per layer

    @property
    def attention_layers(self) -> int:
        return sum(k == "attention" for k, _ in self.layers)

    @property
    def mamba_layers(self) -> int:
        return sum(k == "mamba" for k, _ in self.layers)

    @property
    def moe_layers(self) -> int:
        return sum(m for _, m in self.layers)


def lookup(conf: Dict[str, Any], path: str) -> Any:
    """``conf["a"]["b"]`` for the path ``"a.b"``."""
    node: Any = conf
    for part in path.split("."):
        node = node[part]
    return node


def _layers(conf: Dict[str, Any], n: int, experts: int) -> List[Tuple[str, bool]]:
    """Attention at ``i % attn_layer_period == attn_layer_offset`` (jamba's
    keys), otherwise everywhere; experts at ``i % expert_layer_period ==
    expert_layer_offset``, otherwise on every layer when the model has more
    than one."""
    out = []
    for i in range(n):
        if "attn_layer_period" in conf:
            attn = i % conf["attn_layer_period"] == conf["attn_layer_offset"]
        else:
            attn = True
        if "expert_layer_period" in conf:
            moe = experts > 1 and i % conf["expert_layer_period"] == conf["expert_layer_offset"]
        else:
            moe = experts > 1
        out.append(("attention" if attn else "mamba", moe))
    return out


def shape_of(conf: Dict[str, Any]) -> Shape:
    d = conf["hidden_size"]
    heads = conf["num_attention_heads"]
    experts = conf.get("num_local_experts", conf.get("num_experts", 1))
    n = conf["num_hidden_layers"]
    assumed = conf.get("assumed", {})
    expand = conf.get("mamba_expand", 0)
    return Shape(
        n_layers=n,
        d=d,
        heads=heads,
        kv_heads=conf["num_key_value_heads"],
        head_dim=conf.get("head_dim") or d // heads,
        vocab=conf["vocab_size"],
        window=conf.get("sliding_window"),
        rope_theta=conf.get("rope_theta"),
        eps=conf["rms_norm_eps"],
        experts=experts,
        top_k=conf.get("num_experts_per_tok", 1),
        expert_ff=conf["intermediate_size"] if experts > 1 else 0,
        # a model whose every MLP is an expert layer has no dense width
        dense_ff=(0 if experts > 1 and "expert_layer_period" not in conf
                  else conf["intermediate_size"]),
        capacity_factor=assumed.get("capacity_factor", 1.0),
        renormalize=assumed.get("renormalize_top_k", True),
        mamba_inner=expand * d,
        mamba_state=conf.get("mamba_d_state", 0),
        mamba_conv=conf.get("mamba_d_conv", 0),
        mamba_dt_rank=conf.get("mamba_dt_rank") or (math.ceil(d / 16) if expand else 0),
        embed_scale=math.sqrt(d) if assumed.get("embedding_scale") == "sqrt(hidden_size)" else 1.0,
        layers=tuple(_layers(conf, n, experts)),
    )
