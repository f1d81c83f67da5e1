"""mfu.prefill: the prefill window's model FLOPs (2 N_active a token plus the
attention pairs the mask keeps) at the bf16 peak over the window's time, in %."""

from yardstick import shares


def read(ctx):
    return shares.mfu(ctx) if ctx.kind == "prefill" else None
