"""gmm_roofline.prefill: K4 (csrc/gmm.cu) in the traced prompts: the least time
of the expert products over the rows the capacity keeps, over K4's device
time, in %."""

from yardstick import shares

KERNELS = ("gmm_wgmma_kernel", "gmm_bf16_kernel", "gmm_f32_kernel")


def read(ctx):
    if ctx.kind != "prefill" or ctx.routed is None:
        return None
    return shares.roofline(ctx, "gmm_roofline.prefill", KERNELS, shares.gmm_work)
