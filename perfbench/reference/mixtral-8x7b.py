"""Plain reference of mixtral-8x7b as ``configs/mixtral-8x7b.json`` runs it.

fp32, plain PyTorch (:mod:`yardstick.plain`), nothing of the program. Per
layer: RMSNorm, GQA attention (32 query heads over 8 key/value heads of 128,
rotary embeddings at theta 1e6, causal over the whole prompt or the file's
window where it sets one), residual; RMSNorm,
the top-2 of 8 router with its capacity, SwiGLU experts of width 14,336,
residual. Then the final RMSNorm; the logits are the judge's
(:mod:`yardstick.judge`). The departures from the published model are the
file's ``departures``.
"""

from yardstick import plain
from yardstick.weights import layer_view


def final_hidden(shape, weights, tokens, *, groups, lowp=False):
    """The final normed hidden state (B, S, d) fp32 of ``tokens`` (B, S).
    ``groups``: the MoE's dispatch groups (plain.moe_block)."""
    x = plain.embed(weights["embed"], tokens, shape.embed_scale)
    for i, (kind, moe) in enumerate(shape.layers):
        if (kind, moe) != ("attention", True):
            raise ValueError(f"mixtral layer {i} is {kind}, moe={moe}")
        w = layer_view(weights, i)
        x = x + plain.by_rows(plain.attention_block, x, w["norm1"]["scale"], w["attn"], shape, lowp)
        x = x + plain.moe_block(x, w["norm2"]["scale"], w["moe"], shape, groups, lowp)
    return plain.rmsnorm(x, weights["final_norm"]["scale"], shape.eps)
