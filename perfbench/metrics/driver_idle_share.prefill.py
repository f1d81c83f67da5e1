"""driver_idle_share.prefill: the idle time of the traced prompts that no
``rt.forward`` span of the program holds (the serve driver's own time between
calls, and the slice's edges before its first device operation and after its
last), over the slice's wall time, in %. With the shares of the layers whose
spans tile the call, it adds up to idle_share.prefill."""

from yardstick import spans


def read(ctx):
    return spans.idle_share_outside(ctx, ("rt.forward",)) if ctx.kind == "prefill" else None
