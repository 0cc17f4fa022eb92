"""The benchmark's own counts of work: operations and bytes behind each
roofline share and each ``mfu`` figure, and the H100's published peaks."""

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
