// Stochastic-volatility jump model body of the fused window kernel:
//   x_t = a x_{t-1} + N(0, Q) + J_t N(0, QJ),   J_t ~ Bernoulli(pJ),
//   y_t ~ N(0, exp(x_t) / lrinv^2),   Q = 1/lqinv^2,   QJ = 1/lqjinv^2.
// One carried state dimension (D = 1) from Z = 2 normals a step: the
// second is compared with ndtri(pJ), packed on the host, to draw the jump
// (z < ndtri(pJ) has probability pJ).  Device twin of _fused_* in
// sgmcmc_tpu_torch/models/svjm.py (the JAX package's svjm._fused_*,
// sgmcmc_tpu/models/svjm.py:442-492), with the same operation order, so
// that (built without FMA contraction) both give the same float32 results.
// Parameters pv = [a, lqinv, lrinv, lqjinv, logit_pJ, ndtri(pJ)].
#pragma once

#include "svm_body.cuh"

struct SvjmBody {
  static constexpr int D = 1;
  static constexpr int Z = 2;
  static constexpr int H = 5;
  static constexpr int P = 6;

  // bootstrap proposal from the jump-diffusion mixture
  __device__ static void propose(const float* pv, const float* z,
                                 const float* x, float y, float* xn) {
    const float a = pv[0], lqinv = pv[1], lqjinv = pv[3], ndtri_pj = pv[5];
    const float jump = z[1] < ndtri_pj ? 1.0f : 0.0f;
    const float var = 1.0f / (lqinv * lqinv) + jump / (lqjinv * lqjinv);
    xn[0] = a * x[0] + sqrtf(var) * z[0];
  }

  // the SVM emission: pv[2] is lrinv in both parameter vectors
  __device__ static float reweight(const float* pv, const float* x,
                                   const float* xn, float y) {
    return SvmBody::reweight(pv, x, xn, y);
  }

  // Fisher-identity statistic: the transition score is the
  // responsibility-weighted mixture of the two branch scores, with the
  // jump responsibility r1 a sigmoid clipped to +-60.  Order [grad_LRinv,
  // grad_LQinv, grad_A, grad_logit_pJ, grad_LQJinv].
  __device__ static void stat(const float* pv, const float* x,
                              const float* xn, float y, float* h) {
    const float a = pv[0], lqinv = pv[1], lrinv = pv[2], lqjinv = pv[3];
    const float logit_pj = pv[4];
    const float x0 = x[0], x1 = xn[0];
    const float d = x1 - a * x0;
    const float v0 = 1.0f / (lqinv * lqinv);
    const float vj = 1.0f / (lqjinv * lqjinv);
    const float v1 = v0 + vj;
    const float dlog = -0.5f * d * d / v1 - 0.5f * logf(v1)
                       + 0.5f * d * d / v0 + 0.5f * logf(v0);
    const float r1 = 1.0f / (1.0f + expf(fminf(fmaxf(-(logit_pj + dlog),
                                                      -60.0f), 60.0f)));
    const float r0 = 1.0f - r1;
    const float pj = 1.0f / (1.0f + expf(fminf(fmaxf(-logit_pj, -60.0f),
                                                60.0f)));
    const float grad_a = d * x0 * (r0 / v0 + r1 / v1);
    const float dlogn0_dv = 0.5f * d * d / (v0 * v0) - 0.5f / v0;
    const float dlogn1_dv = 0.5f * d * d / (v1 * v1) - 0.5f / v1;
    const float grad_lqinv =
        (-2.0f * v0 / lqinv) * (r0 * dlogn0_dv + r1 * dlogn1_dv);
    const float grad_lqjinv = (-2.0f * vj / lqjinv) * r1 * dlogn1_dv;
    const float diff_y2 = (y * y) * expf(fminf(fmaxf(-x1, -60.0f), 60.0f));
    h[0] = 1.0f / lrinv - diff_y2 * lrinv;
    h[1] = grad_lqinv;
    h[2] = grad_a;
    h[3] = r1 - pj;
    h[4] = grad_lqjinv;
  }
};
