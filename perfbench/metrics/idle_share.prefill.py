"""idle_share.prefill: the share of the traced prompts' wall time in which no
operation ran on the device, in %."""


def read(ctx):
    if ctx.kind != "prefill" or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
