"""The frozen counts against hand sums at small shapes."""
import pytest

from benchmark.counts import (garch_optimal_body, k1, k1_frame, peaks,
                              resample_apply, step, svm_body)


def test_frozen_constants():
    # chip_smoke.py: K1_OPS = 60 for the SVM, of which the body is 35
    assert k1_frame.FRAME_OPS + svm_body.BODY_OPS == 60
    assert garch_optimal_body.BODY_OPS == 61
    assert k1_frame.RNG_OPS == 63
    assert (peaks.F32_OPS_S, peaks.HBM_BYTES_S) == (67e12, 3.35e12)


def test_k1_counts_by_hand():
    C, W, N = 2, 3, 4
    # SVM, in-kernel normals: (25 + 35 + 63) per particle-step
    assert k1.ops(C, W, N, 35, 1, True) == 2 * 3 * 4 * 123
    assert k1.ops(C, W, N, 35, 1, False) == 2 * 3 * 4 * 60
    # bytes: pvec 2x3, x0 2x1x4, ys / weights / xi 2x3 each, out 2x4
    # float32, and seeds 2 int64 or normals 2x3x1x4 float32
    hand_f32 = 2 * 3 + 2 * 1 * 4 + 3 * (2 * 3) + 2 * (3 + 1)
    assert k1.nbytes(C, W, N, 1, 1, 3, 3, True) == 4 * hand_f32 + 8 * 2
    assert k1.nbytes(C, W, N, 1, 1, 3, 3, False) == 4 * (hand_f32 + 24)


def test_k1_bound_takes_the_larger_side():
    # at the cell's shape the SVM in-kernel launch is bound by operations
    C, W, N = 8192, 60, 1000
    ops = k1.ops(C, W, N, 35, 1, True)
    nbytes = k1.nbytes(C, W, N, 1, 1, 3, 3, True)
    assert ops / peaks.F32_OPS_S > nbytes / peaks.HBM_BYTES_S
    assert k1.bound_s(C, W, N, 35, 1, 1, 3, 3, True) == pytest.approx(
        ops / 67e12)
    # chip_smoke.py's 0.924 ms at N=1024
    assert k1.bound_s(C, W, 1024, 35, 1, 1, 3, 3, True) * 1e3 == \
        pytest.approx(0.924, abs=5e-4)


def test_resample_apply_bytes_by_hand():
    # C=1, n=N=2, K=3: positions 2, CDF 2, rows read 6 and written 6
    assert resample_apply.nbytes(1, 2, 2, 3) == 4 * (2 + 2 + 12)
    # chip_smoke.py: 0.1369 ms at C=8192, N=1000, K=6, bound by bytes
    assert resample_apply.bound_s(8192, 1000, 1000, 6) * 1e3 == \
        pytest.approx(0.1369, abs=2e-4)


def test_step_count():
    assert step.ops_per_particle_step(35) == 123
    assert step.ops_per_particle_step(61) == 149
    assert step.ops(5, 6, 7, 35) == 5 * 6 * 7 * 123
