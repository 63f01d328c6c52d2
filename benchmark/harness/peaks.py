"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, at the full 700 W power limit), against which every roofline share
is stated."""

FP32_FLOPS = 67e12  # FP32 outside the tensor cores; an FMA counts as two
HBM_BYTES_PER_S = 3.35e12
