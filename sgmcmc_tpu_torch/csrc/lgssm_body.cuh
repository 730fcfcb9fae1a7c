// Scalar LGSSM bodies of the fused window kernel:
//   x_t = a x_{t-1} + N(0, 1/lqinv^2),   y_t = c x_t + N(0, 1/lrinv^2).
// Device twins of _fused_propose_* / _fused_reweight_* / _fused_stat in
// sgmcmc_tpu_torch/models/lgssm.py (the JAX package's lgssm._fused_*), with
// the same operation order, so that (built without FMA contraction) both
// give the same float32 results.  Parameters pv = [a, c, lqinv, lrinv].
#pragma once

// The statistic shared by both bodies: the scalar complete-data score,
// order [grad_LRinv, grad_LQinv, grad_C, grad_A].
struct LgssmStat {
  static constexpr int D = 1;
  static constexpr int Z = 1;
  static constexpr int H = 4;
  static constexpr int P = 4;

  __device__ static void stat(const float* pv, const float* x,
                              const float* xn, float y, float* h) {
    const float a = pv[0], c = pv[1], lqinv = pv[2], lrinv = pv[3];
    const float diff = xn[0] - a * x[0];
    const float grad_a = (lqinv * lqinv) * diff * x[0];
    const float grad_lqinv = 1.0f / lqinv - diff * diff * lqinv;
    const float diff_y = y - c * xn[0];
    const float grad_c = (lrinv * lrinv) * diff_y * xn[0];
    const float grad_lrinv = 1.0f / lrinv - diff_y * diff_y * lrinv;
    h[0] = grad_lrinv;
    h[1] = grad_lqinv;
    h[2] = grad_c;
    h[3] = grad_a;
  }
};

// Locally optimal proposal x' ~ p(x' | x, y), weight log p(y | x).
struct LgssmOptimalBody : LgssmStat {
  __device__ static void propose(const float* pv, const float* z,
                                 const float* x, float y, float* xn) {
    const float a = pv[0], c = pv[1], lqinv = pv[2], lrinv = pv[3];
    const float qinv = lqinv * lqinv;
    const float rinv = lrinv * lrinv;
    const float sigma = 1.0f / (qinv + c * c * rinv);
    const float mean = sigma * (a * x[0] * qinv + y * c * rinv);
    xn[0] = mean + sqrtf(sigma) * z[0];
  }

  // log N(y; c a x, c^2 / lqinv^2 + 1 / lrinv^2)
  __device__ static float reweight(const float* pv, const float* x,
                                   const float* xn, float y) {
    const float a = pv[0], c = pv[1], lqinv = pv[2], lrinv = pv[3];
    const float y_var = c * c / (lqinv * lqinv) + 1.0f / (lrinv * lrinv);
    const float diff = y - c * a * x[0];
    return -0.91893853320467274f - 0.5f * logf(y_var)
           - 0.5f * diff * diff / y_var;
  }
};

// Bootstrap (prior) proposal x' = a x + z / lqinv, weight log N(y; c x', R).
struct LgssmPriorBody : LgssmStat {
  __device__ static void propose(const float* pv, const float* z,
                                 const float* x, float y, float* xn) {
    xn[0] = pv[0] * x[0] + z[0] / pv[2];
  }

  __device__ static float reweight(const float* pv, const float* x,
                                   const float* xn, float y) {
    const float c = pv[1], lrinv = pv[3];
    const float diff = (y - c * xn[0]) * lrinv;
    return -0.91893853320467274f + logf(fabsf(lrinv)) - 0.5f * diff * diff;
  }
};
