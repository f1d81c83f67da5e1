"""attention_idle_share.decode: the idle gaps of the traced decode steps whose
middle lies inside a ``rt.attention`` span of the program (the decode attention
with its norm), over the slice's wall time, in %."""

from yardstick import spans


def read(ctx):
    return spans.idle_share(ctx, ("rt.attention",)) if ctx.kind == "decode" else None
