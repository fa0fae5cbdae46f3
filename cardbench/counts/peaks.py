"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W)."""

PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_TF32_FLOPS = 494.7e12  # TF32 on the tensor cores
PEAK_HBM_BYTES = 3.35e12
TF32_PASSES = 3  # the kernels run every product as 3xTF32: hi*hi + hi*lo + lo*hi
# the card's fastest fp32-accurate rate: 3xTF32 on the tensor cores, the denominator of step_mfu.*
PEAK_FP32_ACCURATE_FLOPS = PEAK_TF32_FLOPS / TF32_PASSES
