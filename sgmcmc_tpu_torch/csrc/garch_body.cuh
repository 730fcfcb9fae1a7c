// GARCH(1,1) bodies of the fused window kernel:
//   sigma2_t = alpha + beta x_{t-1}^2 + gamma sigma2_{t-1},
//   x_t ~ N(0, sigma2_t),   y_t = x_t + N(0, 1/lrinv^2),
// with alpha = mu (1 - phi), beta = phi lam, gamma = phi (1 - lam).  The
// state is (x, sigma2): D = 2 carried dimensions from Z = 1 normal a step
// (sigma2 is deterministic).  Device twins of _fused_* in
// sgmcmc_tpu_torch/models/garch.py (the JAX package's garch._fused_*,
// sgmcmc_tpu/models/garch.py:280-332), with the same operation order, so
// that (built without FMA contraction) both give the same float32 results.
// Parameters pv = [mu, phi, lam, lrinv].
#pragma once

// The statistic shared by both bodies: the chain-rule score in the
// unconstrained coordinates, order [grad_LRinv, grad_log_mu,
// grad_logit_phi, grad_logit_lambduh].
struct GarchStat {
  static constexpr int D = 2;
  static constexpr int Z = 1;
  static constexpr int H = 4;
  static constexpr int P = 4;

  // sigma2' = alpha + beta x^2 + gamma sigma2
  __device__ static float sigma2_next(const float* pv, const float* x) {
    const float mu = pv[0], phi = pv[1], lam = pv[2];
    const float alpha = mu * (1.0f - phi);
    const float beta = phi * lam;
    const float gamma = phi * (1.0f - lam);
    return alpha + beta * (x[0] * x[0]) + gamma * x[1];
  }

  __device__ static void stat(const float* pv, const float* x,
                              const float* xn, float y, float* h) {
    const float mu = pv[0], phi = pv[1], lam = pv[2], lrinv = pv[3];
    const float v = xn[1];
    const float grad_v = -0.5f * (v - xn[0] * xn[0]) / (v * v);
    const float grad_log_mu = grad_v * (1.0f - phi) * mu;
    const float grad_logit_phi =
        grad_v * (-mu + lam * (x[0] * x[0]) + (1.0f - lam) * x[1])
        * (1.0f - phi) * phi;
    const float grad_logit_lambduh =
        grad_v * phi * (x[0] * x[0] - x[1]) * (1.0f - lam) * lam;
    const float diff_y = y - xn[0];
    h[0] = 1.0f / lrinv - diff_y * diff_y * lrinv;
    h[1] = grad_log_mu;
    h[2] = grad_logit_phi;
    h[3] = grad_logit_lambduh;
  }
};

// Locally optimal proposal x' ~ p(x' | x, y), weight log N(y; 0, s2' + R).
struct GarchOptimalBody : GarchStat {
  __device__ static void propose(const float* pv, const float* z,
                                 const float* x, float y, float* xn) {
    const float lrinv = pv[3];
    const float s2 = sigma2_next(pv, x);
    const float rinv = lrinv * lrinv;
    const float var = 1.0f / (rinv + 1.0f / s2);
    const float mean = var * (y * rinv);
    xn[0] = mean + sqrtf(var) * z[0];
    xn[1] = s2;
  }

  __device__ static float reweight(const float* pv, const float* x,
                                   const float* xn, float y) {
    const float lrinv = pv[3];
    const float var = xn[1] + 1.0f / (lrinv * lrinv);
    return -0.91893853320467274f - 0.5f * (y * y) / var - 0.5f * logf(var);
  }
};

// Bootstrap (prior) proposal x' = sqrt(s2') z, weight log N(y; x', R).
struct GarchPriorBody : GarchStat {
  __device__ static void propose(const float* pv, const float* z,
                                 const float* x, float y, float* xn) {
    const float s2 = sigma2_next(pv, x);
    xn[0] = sqrtf(s2) * z[0];
    xn[1] = s2;
  }

  __device__ static float reweight(const float* pv, const float* x,
                                   const float* xn, float y) {
    const float lrinv = pv[3];
    const float diff = y - xn[0];
    return -0.91893853320467274f - 0.5f * diff * diff * (lrinv * lrinv)
           + logf(fabsf(lrinv));
  }
};
