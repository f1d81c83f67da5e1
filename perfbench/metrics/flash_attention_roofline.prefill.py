"""flash_attention_roofline.prefill: K1 (csrc/flash_attention.cu) in the traced
prompts: the least time of the attention the mask and window keep, over K1's
device time, in %."""

from yardstick import shares

KERNELS = ("fa_fwd_wgmma_kernel", "fa_fwd_kernel")


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return shares.roofline(ctx, "flash_attention_roofline.prefill", KERNELS, shares.attention_work)
