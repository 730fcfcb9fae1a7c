"""Operations and bytes of one launch of the fused window (K1) from its
shapes: C chains, W window steps, N particles, a model body with D state
dimensions, Z normals a step, P parameters and H statistics.

Operations: every particle-step runs the frame and the body, and with
in-kernel normals draws Z normals (``k1_frame.RNG_OPS`` each); frozen
from ``chip_smoke.py:391-398`` (``k1_ops`` with every chain-step active).

Bytes: each input read once and each output written once, as
``chip_smoke.py:4055-4058`` (``k1_bytes``) counts them: parameters [C, P],
initial state [C, D, N], the proposal normals [C, W, Z, N] (host normals)
or the seeds [C] int64 (in-kernel normals), observations, step weights
and resampling offsets [C, W] each, all float32 but the seeds, and the
output [C, H + 1]."""
from . import k1_frame, peaks


def ops(C, W, N, body_ops, Z=1, kernel_rng=False):
    per = k1_frame.FRAME_OPS + body_ops + (Z * k1_frame.RNG_OPS
                                           if kernel_rng else 0)
    return C * W * N * per


def nbytes(C, W, N, D, Z, P, H, kernel_rng=False):
    normals = 8 * C if kernel_rng else 4 * C * W * Z * N
    return 4 * (C * P + C * D * N + 3 * C * W + C * (H + 1)) + normals


def bound_s(C, W, N, body_ops, D, Z, P, H, kernel_rng=False):
    return peaks.bound_s(ops(C, W, N, body_ops, Z, kernel_rng),
                         nbytes(C, W, N, D, Z, P, H, kernel_rng))
