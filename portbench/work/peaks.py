"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit)."""

BF16_FLOPS = 989e12     # bf16 / fp16 on tensor cores
F32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BYTES = 3.35e12     # bytes/s


def flops_peak(dtype: str) -> float:
    return F32_FLOPS if dtype == "float32" else BF16_FLOPS


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / flops_peak(dtype), nbytes / HBM_BYTES)
