"""decode_attention_roofline.decode: K5 (csrc/decode_attention.cu) in the
traced decode steps: the least time of every attention layer's single-token
attention over the cache's filled slots, over K5's device time (its split and
combine kernels), in %. The work is the harness's own, whatever implements the
layer: each step's attended keys (never more than the cache holds), capped
at the window, with q, K, V and the output moved once in bf16."""

from yardstick import shares, work

KERNELS = ("decode_attn_split_kernel", "decode_attn_combine_kernel")
NAME = "decode_attention_roofline.decode"


def _pieces(ctx):
    s = ctx.shape
    for keys in ctx.traced:  # the slots a step attends: its position + 1, at most the cache's
        fill = keys if s.window is None else min(keys, s.window)
        for _ in range(s.attention_layers):
            flops, nbytes = work.attention_work(ctx.batch, 1, fill, s.heads, s.kv_heads, s.head_dim,
                                                False, None)
            yield flops, nbytes, work.PEAK_BF16


def read(ctx):
    if ctx.kind != "decode":
        return None
    return shares.roofline(ctx, NAME, KERNELS, _pieces)
