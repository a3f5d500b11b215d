"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit), frozen."""

BF16_PEAK_FLOPS = 989e12  # bfloat16 / float16 on the tensor cores
TF32_PEAK_FLOPS = 495e12  # TF32 on the tensor cores: the highest rate of float32-input products
TF32X3_PEAK_FLOPS = TF32_PEAK_FLOPS / 3  # 3xTF32 takes three products
F32_PEAK_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3
