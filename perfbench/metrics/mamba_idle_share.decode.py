"""mamba_idle_share.decode: the idle gaps of the traced decode steps whose
middle lies inside a ``rt.mamba`` span of the program (the one-token mamba
mixer), over the slice's wall time, in %."""

from yardstick import spans


def read(ctx):
    return spans.idle_share(ctx, ("rt.mamba",)) if ctx.kind == "decode" else None
