"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): HBM3 bandwidth and float32 outside the tensor cores (the
program runs float32 with TF32 off)."""
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for ``flops`` and ``nbytes``."""
    return max(flops / PEAK_F32_S, nbytes / PEAK_BYTES_S)
