"""driver_idle_share.decode: the idle time of the traced decode steps that no
``rt.decode_step`` span of the program holds (the serve driver's own time
between calls, and the slice's edges before its first device operation and
after its last), over the slice's wall time, in %. With the shares of the
layers whose spans tile the call, it adds up to idle_share.decode."""

from yardstick import spans


def read(ctx):
    return spans.idle_share_outside(ctx, ("rt.decode_step",)) if ctx.kind == "decode" else None
