"""gmm_roofline.decode: K4 (csrc/gmm.cu) in the traced decode steps: the least
time of the expert products over the rows the capacity keeps (of streams x
top-k a step), over K4's device time, in %."""

from yardstick import shares

KERNELS = ("gmm_wgmma_kernel", "gmm_bf16_kernel", "gmm_f32_kernel")


def read(ctx):
    if ctx.kind != "decode" or ctx.routed is None:
        return None
    return shares.roofline(ctx, "gmm_roofline.decode", KERNELS, shares.gmm_work)
