"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  The port runs float32 with TF32
off (its matmuls and the benchmark's reference alike), so the compute
peak is float32's outside the tensor cores."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory bandwidth and the operations over the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
