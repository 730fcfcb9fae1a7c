"""The frozen counts against hand sums at small shapes."""
import pytest

from benchmark.counts import (garch_optimal_body, k1, k1_frame, paris,
                              peaks, resample_apply, smoother_step, step,
                              svm_body)


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


def test_smoother_step_bytes_by_hand():
    # C=1, N=2, D=1, Z=1, H=3: a particle reads its row of 4 and writes it,
    # reads a normal, writes a log-weight and a CDF entry
    assert smoother_step.nbytes(1, 2, 1, 1, 3) == 4 * 2 * (2 * 4 + 1 + 2)
    # the GARCH optimal launch at C=8192, N=1000: 0.49 GB, 0.1467 ms
    assert smoother_step.nbytes(8192, 1000, 2, 1, 4) == 491_520_000
    assert smoother_step.bound_s(8192, 1000, 2, 1, 4, 61) * 1e3 == \
        pytest.approx(0.1467, abs=1e-4)


def test_paris_count_by_hand():
    # the SVM at N=100, n_tilde=2: forward 25 + 35 - 18 + 63; 100 pairs of
    # 7 + 7; two draws of a search (7 + 1), a statistic (18) and 2 x 3;
    # the mean 3
    per = (25 + 35 - 18 + 63) + 100 * (7 + 7) + 2 * (8 + 18 + 6) + 3
    assert paris.ops_per_particle_step(svm_body, 100, 1, 2, 3) == per
    assert paris.ops(5, 6, 100, svm_body, 1, 2, 3) == 5 * 6 * 100 * per
