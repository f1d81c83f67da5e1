"""moe_idle_share.prefill: the idle gaps of the traced prompts whose middle
lies inside a ``rt.moe`` span of the program (the MoE sub-layer with its norm),
over the slice's wall time, in %."""

from yardstick import spans


def read(ctx):
    return spans.idle_share(ctx, ("rt.moe",)) if ctx.kind == "prefill" else None
