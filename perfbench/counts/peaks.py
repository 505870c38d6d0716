"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). Every roofline
and utilization share of the benchmark is taken against these."""

HBM_BPS = 3.35e12          # HBM3 bytes/s
BF16_FLOPS = 989e12        # dense bf16 / fp16 on the tensor cores
TF32_FLOPS = 494.7e12      # dense TF32 on the tensor cores
F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
              "float32": F32_FLOPS}


def least_s(flops, nbytes, peak_flops=BF16_FLOPS):
    """The least time the chip could take for work of `flops` operations
    that reads and writes `nbytes`: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / HBM_BPS)
