"""Plain reference of jamba-v0.1-52b as ``configs/jamba-v0.1-52b.json`` runs it.

fp32, plain PyTorch (:mod:`yardstick.plain`), nothing of the program. Per
layer, by the file's periods (attention at layer 4 of every 8, experts on
odd layers): either the mamba mixer with its own RMSNorm and residual
(expand 2, conv 4, state 16, dt rank 256), or RMSNorm, GQA attention (32
query heads over 8 key/value heads of 128, rotary embeddings at theta
10,000, causal, no window) and residual; then RMSNorm and either the top-2 of
16 router with its capacity and SwiGLU experts of width 14,336, or a dense
SwiGLU MLP of width 14,336, and the residual. Then the final RMSNorm; the
logits are the judge's (:mod:`yardstick.judge`). The departures from the
published model are the file's ``departures``.
"""

from yardstick import plain
from yardstick.weights import layer_view


def final_hidden(shape, weights, tokens, *, groups, lowp=False):
    """The final normed hidden state (B, S, d) fp32 of ``tokens`` (B, S).
    ``groups``: the MoE's dispatch groups (plain.moe_block)."""
    x = plain.embed(weights["embed"], tokens, shape.embed_scale)
    for i, (kind, moe) in enumerate(shape.layers):
        w = layer_view(weights, i)
        if kind == "attention":
            x = x + plain.by_rows(plain.attention_block, x, w["norm1"]["scale"], w["attn"], shape,
                                  lowp)
        else:
            x = plain.by_rows(plain.mamba_block, x, w["mixer"], shape, lowp)
        if moe:
            x = x + plain.moe_block(x, w["norm2"]["scale"], w["moe"], shape, groups, lowp)
        else:
            x = x + plain.by_rows(plain.mlp_block, x, w["norm2"]["scale"], w["mlp"], shape, lowp)
    return plain.rmsnorm(x, weights["final_norm"]["scale"], shape.eps)
