"""NVIDIA H100 SXM5 80GB constants: the card the port runs on.

Each figure with its source. The reference's ``repro.analysis.constants``
describes a TPU v5e chip and does not carry over; the simulated pod of
:mod:`repro_torch.cluster.pod` keeps its own modelled rates, and neither
module reads the other.
"""

# dense bf16 tensor-core peak, no sparsity: 989.4 TFLOP/s (NVIDIA H100 Tensor
# Core GPU datasheet, SXM5 column: "BF16 Tensor Core 1,979 teraFLOPS" with
# sparsity, half of it dense)
CHIP_FLOPS_BF16 = 989e12
# fp32 on the CUDA cores: 67 TFLOP/s (same datasheet, "FP32 67 teraFLOPS")
CHIP_FLOPS_FP32 = 67e12
# HBM3 bandwidth: 3.35 TB/s (same datasheet, "GPU memory bandwidth 3.35TB/s")
HBM_BW = 3.35e12
# HBM3 capacity: 80 GB (same datasheet, "GPU memory 80GB")
HBM_BYTES = 80e9
# Per-GPU bandwidth of a mesh axis 16 wide, which crosses 8-GPU nodes: one
# NDR InfiniBand port of 400 Gb/s per GPU (ConnectX-7 on a DGX H100) =
# 50 GB/s. Inside a node each GPU has 900 GB/s of NVLink 4 (same datasheet,
# "NVLink: 900GB/s"); an axis that stays within 8 GPUs would see that.
LINK_BW = 50e9

# peak rate by the operands' type, for the kernels' bounds
PEAK_FLOPS = {"bfloat16": CHIP_FLOPS_BF16, "float32": CHIP_FLOPS_FP32}
