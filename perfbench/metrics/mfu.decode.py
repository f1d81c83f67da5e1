"""mfu.decode: the decode window's model FLOPs (2 N_active a token plus each
token's attended keys) at the bf16 peak over the window's time, in %."""

from yardstick import shares


def read(ctx):
    return shares.mfu(ctx) if ctx.kind == "decode" else None
