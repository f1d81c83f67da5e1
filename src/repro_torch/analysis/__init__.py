"""Roofline analysis of the port: the H100's constants and the terms derived
from the dry-run records (counterpart of ``repro.analysis``)."""

from repro_torch.analysis.constants import CHIP_FLOPS_BF16, HBM_BW, HBM_BYTES, LINK_BW
from repro_torch.analysis.roofline import model_flops, roofline_row, roofline_terms

__all__ = [
    "CHIP_FLOPS_BF16",
    "HBM_BW",
    "LINK_BW",
    "HBM_BYTES",
    "roofline_terms",
    "model_flops",
    "roofline_row",
]
