"""gmm_roofline_program.decode: K4 (csrc/gmm.cu) in the traced decode steps:
the least time of the expert products over the rows the program's own capacity
kept, over K4's device time, in %. As gmm_roofline.decode, but the kept rows
are the program's: its counter ``rt.moe.copies`` (``repro_torch.obs``), one
sample a MoE layer call, read in the process that served the slice. This file
and its twin for the other kind are the only files of the benchmark besides
yardstick/program.py that import the program; a program without the counter
reads None."""

from types import SimpleNamespace

from yardstick import shares, spans

KERNELS = ("gmm_wgmma_kernel", "gmm_bf16_kernel", "gmm_f32_kernel")
NAME = "gmm_roofline_program.decode"


def read(ctx):
    if ctx.kind != "decode":
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    routed = spans.kept_rows(ctx, obs.samples("rt.moe.copies"), NAME)
    if routed is None:
        return None
    return shares.roofline(SimpleNamespace(**{**vars(ctx), "routed": routed}), NAME, KERNELS,
                           shares.gmm_work)
