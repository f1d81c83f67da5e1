"""The simulated TPU v5e pod's per-chip rates: modelled inputs, not measurements.

The cluster layer (:mod:`repro_torch.cluster`) schedules jobs on a
*simulated* 256-chip TPU v5e pod, as the reference does; its roofline
elasticities (:mod:`repro_torch.cluster.elasticity`) divide each job's
FLOPs, bytes and collective bytes by these rates.  They are the reference's
assignment-brief numbers (``repro.analysis.constants``), kept here as inputs
of the simulated device, like :data:`repro_torch.core.power.TPU_V5E_POD`'s
power curve.  They describe no card the port runs on: no H100 number is read
from this module, and the H100's constants belong elsewhere.
"""

from __future__ import annotations

__all__ = ["CHIP_FLOPS_BF16", "HBM_BW", "LINK_BW"]

CHIP_FLOPS_BF16 = 197e12  # 197 TFLOP/s bf16 per simulated chip
HBM_BW = 819e9  # 819 GB/s HBM bandwidth per simulated chip
LINK_BW = 50e9  # ~50 GB/s per simulated ICI link
