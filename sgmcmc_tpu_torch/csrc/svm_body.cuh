// SVM body of the fused window kernel: x_t = a x_{t-1} + N(0, 1/lqinv^2),
// y_t ~ N(0, exp(x_t) / lrinv^2).  Device twin of _fused_propose /
// _fused_reweight / _fused_stat in sgmcmc_tpu_torch/models/svm.py, with the
// same operation order, so that (built without FMA contraction) both give
// the same float32 results.
//
// A body is a struct with the sizes D (state), Z (normals per step),
// H (statistic) and P (parameters), and three device functions.  The
// parameter vector is pv = [a, lqinv, lrinv].
#pragma once

struct SvmBody {
  static constexpr int D = 1;
  static constexpr int Z = 1;
  static constexpr int H = 3;
  static constexpr int P = 3;

  __device__ static void propose(const float* pv, const float* z,
                                 const float* x, float y, float* xn) {
    xn[0] = pv[0] * x[0] + z[0] / pv[1];
  }

  // log N(y; 0, exp(xn) / lrinv^2), exponent clipped to +-60
  __device__ static float reweight(const float* pv, const float* x,
                                   const float* xn, float y) {
    const float lrinv = pv[2];
    const float e = expf(fminf(fmaxf(-xn[0], -60.0f), 60.0f));
    return -0.91893853320467274f - 0.5f * (y * y) * e * (lrinv * lrinv)
           + logf(fabsf(lrinv)) - 0.5f * xn[0];
  }

  // Fisher-identity statistic, order [grad_LRinv, grad_LQinv, grad_A]
  __device__ static void stat(const float* pv, const float* x,
                              const float* xn, float y, float* h) {
    const float a = pv[0], lqinv = pv[1], lrinv = pv[2];
    const float diff_x = xn[0] - a * x[0];
    const float grad_a = (lqinv * lqinv) * diff_x * x[0];
    const float grad_lqinv = 1.0f / lqinv - diff_x * diff_x * lqinv;
    const float diff_y2 = (y * y) * expf(fminf(fmaxf(-xn[0], -60.0f), 60.0f));
    const float grad_lrinv = 1.0f / lrinv - diff_y2 * lrinv;
    h[0] = grad_lrinv;
    h[1] = grad_lqinv;
    h[2] = grad_a;
  }
};
