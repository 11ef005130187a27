"""Published peaks of one NVIDIA H100 SXM 80GB (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, flops: float = BF16_FLOPS) -> float:
    """The least time for `ops` operations and `nbytes` of device-memory
    traffic: the larger of the two over their peaks."""
    return max(ops / flops, nbytes / HBM_BYTES_PER_S)
