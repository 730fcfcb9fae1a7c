"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit): float32 outside the tensor cores and
HBM3 bandwidth.  Frozen from ``chip_smoke.py:281``
(``HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12``)."""

F32_OPS_S = 67e12
HBM_BYTES_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the float32 peak and the bytes over the memory bandwidth."""
    return max(ops / F32_OPS_S, nbytes / HBM_BYTES_S)
