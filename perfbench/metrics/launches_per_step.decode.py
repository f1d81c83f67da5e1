"""launches_per_step.decode: device operations (kernels, copies, fills) in the
trace per traced decode step."""


def read(ctx):
    if ctx.kind != "decode" or not ctx.traced:
        return None
    return len(ctx.trace.ops) / len(ctx.traced)
