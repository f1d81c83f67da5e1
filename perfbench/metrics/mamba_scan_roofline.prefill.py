"""mamba_scan_roofline.prefill: K2 (csrc/mamba_scan.cu) in the traced prompts:
the least time of the selective scans, over K2's device time, in %."""

from yardstick import shares

KERNELS = ("mamba_scan_kernel",)


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return shares.roofline(ctx, "mamba_scan_roofline.prefill", KERNELS, shares.scan_work)
