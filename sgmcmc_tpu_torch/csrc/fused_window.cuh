// Fused buffered particle-smoother window for Hopper (sm_90a): the kernel
// template, its launcher and the entry-point macro.  Each model body is
// instantiated in a translation unit of its own (fused_window_<body>.cu),
// so that the build compiles the bodies in parallel.
//
// Replaces the TPU kernel _fused_window_kernel of
// sgmcmc_tpu/ops/pallas/fused_pf.py (launched by fused_window_batched).
// It computes what that kernel computes, not the way Mosaic computed it:
// no folded [s, B] layout, no bf16 hi/lo split, no one-hot MXU gather.
//
// One block per chain, 256 threads; thread k owns the contiguous particles
// [k*c, (k+1)*c), c = ceil(N / 256).  The carries (state and statistics,
// double-buffered, the log-weights and the CDF) live in shared memory for
// all W steps.  Per step t:
//   1. block max m of log w, w = exp(log w - m);
//   2. block prefix sum of w, accumulated in float64, CDF = csum / tot
//      rounded to float32 (uniform (j+1)/N when tot is not positive and
//      finite), and the deferred log-likelihood increment of step t-1:
//      ll += w_{t-1} * (m + log tot - log N), -inf when degenerate;
//   3. (lambda < 1) the weight-averaged statistic S_bar;
//   4. for each owned output particle i: ancestor a = #{j : cdf_j <= pos_i}
//      at pos_i = (i + xi_t) / N, clipped to N-1 (upper_bound in the
//      shared CDF), gather state and statistics of a, propose, reweight,
//      and update s' = lambda s + (1 - lambda) S_bar + w_t h.
// The epilogue adds the last step's increment and writes the
// weight-averaged statistic and the log-likelihood: out[c] = [stat | ll].
//
// Options, each a template parameter, so that each variant compiles
// without the others' code and registers (the launcher picks the variant
// from its arguments):
//   - in-kernel normals (seeds != nullptr): the proposal normals come from
//     the Philox generator of philox.cuh, keyed by the chain's seed, at
//     counter (i >> 1, t, q, 0), instead of the normals array (the JAX
//     package's rng="kernel", _box_muller);
//   - the ESS gate (ess_thr >= 0): with ESS = tot^2 / sum w^2 of the
//     max-shifted weights, a chain resamples only when ESS < ess_thr * N or
//     its weights are degenerate; otherwise every particle keeps its own
//     state (ancestor i) and its new log-weight gains
//     log w_i - m - log tot + log N (fused_pf.py's ESS gate);
//   - the valid gate (vs != nullptr; fused_pf.py's valid_gate): a step with
//     vs[c, t] <= 0 skips part 4, so the chain keeps its carries and
//     log-weights.  Parts 1-2 still run: the first invalid step adds the
//     deferred increment of the last valid one (its weight w_{t-1} is not
//     zero), and later invalid steps add w_{t-1} = 0 times theirs.  As a
//     runtime branch (vs == nullptr: all valid) it cost the ungated SVM
//     kernel 7% at the benchmark shape, so it is a template parameter too.
//
// What bounds it on the card: with host normals, the normals stream from
// device memory, W*Z*N*4 bytes per chain (240 KB at W=60, N=1024; 2 GB per
// call at 8192 chains), against a serial chain of W steps of about eight
// block barriers each.  The design reads the normals once, coalesced (a
// thread's c particles are adjacent), keeps every carry in shared memory
// (about (2K+2)*N*4 bytes, K = D+H), and relies on several resident blocks
// per SM to hide one block's barriers behind another's loads.  With
// in-kernel normals the stream is gone and operations bound it: one
// Philox call per pair of particles, computed once by the thread that owns
// both (a thread's particles are contiguous), and a Box-Muller transform
// per particle, all in registers.
//
// The prefix sum runs in float64 so that the float32 CDF does not depend
// on the summation order: the plain PyTorch version (torch.cumsum in
// float64) then selects the same ancestors.  The file is compiled with
// --fmad=false for the same reason: the model body rounds after every
// operation, as PyTorch's elementwise operators do.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Shared-memory layout: [double dred[kRed] | float red[kRed] | float data...]
constexpr int kRed = 34;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Block-wide max, broadcast to every thread.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < kWarps ? red[lane] : -INFINITY;
    r = warp_max(r);
    if (lane == 0) red[kWarps] = r;
  }
  __syncthreads();
  const float out = red[kWarps];
  __syncthreads();
  return out;
}

// Block-wide float64 sum, broadcast to every thread.
__device__ double block_sum(double v, double* dred) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) dred[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double r = lane < kWarps ? dred[lane] : 0.0;
    r = warp_sum(r);
    if (lane == 0) dred[kWarps] = r;
  }
  __syncthreads();
  const double out = dred[kWarps];
  __syncthreads();
  return out;
}

// Block-wide exclusive float64 scan in thread order; *total gets the sum.
__device__ double block_exclusive_scan(double v, double* dred,
                                       double* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) dred[warp] = x;
  __syncthreads();
  if (warp == 0) {
    double r = lane < kWarps ? dred[lane] : 0.0;
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(kFull, r, o);
      if (lane >= o) r += y;
    }
    if (lane < kWarps) dred[lane] = r;  // inclusive warp totals
  }
  __syncthreads();
  const double warp_excl = warp > 0 ? dred[warp - 1] : 0.0;
  *total = dred[kWarps - 1];
  __syncthreads();
  return warp_excl + (x - v);
}

template <class Body, bool kRng, bool kGate, bool kValid>
__global__ void __launch_bounds__(kThreads)
fused_window_kernel(const float* __restrict__ pvec,     // [C, P]
                    const float* __restrict__ x0,       // [C, D, N]
                    const float* __restrict__ normals,  // [C, W, Z, N] or
                                                        // null with seeds
                    const long long* __restrict__ seeds,  // [C] or null
                    const float* __restrict__ ys,       // [C, W]
                    const float* __restrict__ weights,  // [C, W]
                    const float* __restrict__ xi,       // [C, W]
                    const float* __restrict__ vs,       // [C, W] or null
                    float lam, double ess_thr, int W, int N,
                    float* __restrict__ out) {          // [C, H + 1]
  constexpr int D = Body::D, Z = Body::Z, H = Body::H, P = Body::P;
  constexpr int K = D + H;
  extern __shared__ __align__(16) unsigned char smem[];
  double* dred = reinterpret_cast<double*>(smem);
  float* red = reinterpret_cast<float*>(dred + kRed);
  float* aux = red + kRed;     // [3W or 4W]: ys | weights | xi (| valid)
  float* cdf = aux + (kValid ? 4 : 3) * W;    // [N]
  float* logw = cdf + N;       // [N]
  float* Vc = logw + N;        // [K, N] carries of the current step
  float* Vn = Vc + K * N;      // [K, N] carries of the next step

  const int c = blockIdx.x;
  const int chunk = (N + kThreads - 1) / kThreads;
  const int i0 = min(static_cast<int>(threadIdx.x) * chunk, N);
  const int i1 = min(i0 + chunk, N);
  const float fN = static_cast<float>(N);
  const float logN = logf(fN);
  const float om = 1.0f - lam;
  uint32_t key0 = 0, key1 = 0;
  if (kRng) {
    const unsigned long long sd = static_cast<unsigned long long>(seeds[c]);
    key0 = static_cast<uint32_t>(sd);
    key1 = static_cast<uint32_t>(sd >> 32);
  }

  float pv[P];
#pragma unroll
  for (int p = 0; p < P; ++p) pv[p] = pvec[static_cast<size_t>(c) * P + p];
  for (int k = threadIdx.x; k < W; k += kThreads) {
    const size_t o = static_cast<size_t>(c) * W + k;
    aux[k] = ys[o];
    aux[W + k] = weights[o];
    aux[2 * W + k] = xi[o];
    if (kValid) aux[3 * W + k] = vs[o];
  }
  for (int i = i0; i < i1; ++i) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      Vc[d * N + i] = x0[(static_cast<size_t>(c) * D + d) * N + i];
#pragma unroll
    for (int h = 0; h < H; ++h) Vc[(D + h) * N + i] = 0.0f;
    logw[i] = 0.0f;
  }
  __syncthreads();

  float ll = 0.0f;
  for (int t = 0; t < W; ++t) {
    // 1. max shift
    float m = -INFINITY;
    for (int i = i0; i < i1; ++i) m = fmaxf(m, logw[i]);
    m = block_max(m, red);
    const float mf = isfinite(m) ? m : 0.0f;

    // 2. weights, float64 prefix sum, CDF, deferred loglik increment
    double part = 0.0, part2 = 0.0;
    for (int i = i0; i < i1; ++i) {
      const float w = expf(logw[i] - mf);
      cdf[i] = w;
      part += static_cast<double>(w);
      part2 += static_cast<double>(w) * static_cast<double>(w);
    }
    double tot;
    double run = block_exclusive_scan(part, dred, &tot);
    const bool ok = isfinite(tot) && tot > 0.0;
    const float totf = static_cast<float>(tot);
    if (t > 0)
      ll = ll + aux[W + t - 1] * (ok ? mf + logf(totf) - logN : -INFINITY);
    // ESS gate: one more float64 block reduction, for sum w^2
    bool do_res = true;
    if (kGate) {
      const double sumsq = block_sum(part2, dred);
      const double ess = tot * tot / (sumsq > 0.0 ? sumsq : 1.0);
      do_res = !ok || ess < ess_thr * static_cast<double>(N);
    }
    for (int i = i0; i < i1; ++i) {
      run += static_cast<double>(cdf[i]);
      cdf[i] = ok ? static_cast<float>(run / tot)
                  : static_cast<float>(i + 1) / fN;
    }

    // 3. weight-averaged statistic for the shrinkage term
    float sbar[H] = {};
    if (lam != 1.0f) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        double acc = 0.0;
        for (int i = i0; i < i1; ++i) {
          const float p = ok ? expf(logw[i] - mf) / totf : 1.0f / fN;
          acc += static_cast<double>(Vc[(D + h) * N + i] * p);
        }
        sbar[h] = static_cast<float>(block_sum(acc, dred));
      }
    }
    __syncthreads();  // the CDF is complete

    // 4. resample, propose, reweight, statistic (valid steps only: the
    // branch is uniform over the block)
    if (kValid && !(aux[3 * W + t] > 0.0f)) continue;
    const float y = aux[t], wt = aux[W + t], xit = aux[2 * W + t];
    const float* nz = kRng ? nullptr
        : normals + (static_cast<size_t>(c) * W + t) * Z * N;
    const float ltot = logf(totf);
    uint4 r[Z];   // Philox words of the pair (i & ~1, i | 1), per noise dim
    for (int i = i0; i < i1; ++i) {
      int a = i;
      if (do_res) {
        const float pos = (static_cast<float>(i) + xit) / fN;
        int lo = 0, hi = N;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cdf[mid] <= pos) lo = mid + 1; else hi = mid;
        }
        a = min(lo, N - 1);
      }
      float x[D], s[H], z[Z], xn[D], hv[H];
#pragma unroll
      for (int d = 0; d < D; ++d) x[d] = Vc[d * N + a];
#pragma unroll
      for (int h = 0; h < H; ++h) s[h] = Vc[(D + h) * N + a];
      if (kRng) {
        if (i == i0 || (i & 1) == 0) {
#pragma unroll
          for (int q = 0; q < Z; ++q)
            r[q] = philox_pair(key0, key1, i >> 1, t, q, 0);
        }
#pragma unroll
        for (int q = 0; q < Z; ++q)
          z[q] = (i & 1) ? box_muller(r[q].z, r[q].w)
                         : box_muller(r[q].x, r[q].y);
      } else {
#pragma unroll
        for (int q = 0; q < Z; ++q) z[q] = nz[q * N + i];
      }
      // the gate's carried weight reads this particle's old log-weight
      const float carried = do_res ? 0.0f : logw[i] - mf - ltot + logN;
      Body::propose(pv, z, x, y, xn);
      const float lw = Body::reweight(pv, x, xn, y);
      logw[i] = do_res ? lw : lw + carried;
      Body::stat(pv, x, xn, y, hv);
#pragma unroll
      for (int d = 0; d < D; ++d) Vn[d * N + i] = xn[d];
#pragma unroll
      for (int h = 0; h < H; ++h)
        Vn[(D + h) * N + i] = lam == 1.0f
            ? s[h] + wt * hv[h]
            : lam * s[h] + om * sbar[h] + wt * hv[h];
    }
    float* tmp = Vc; Vc = Vn; Vn = tmp;
    // The next step's first block barrier (in block_max) orders these
    // writes before any thread rewrites the CDF or reads the carries.
  }

  // Epilogue: last deferred increment and the weight-averaged statistic.
  float m = -INFINITY;
  for (int i = i0; i < i1; ++i) m = fmaxf(m, logw[i]);
  m = block_max(m, red);
  const float mf = isfinite(m) ? m : 0.0f;
  double part = 0.0;
  for (int i = i0; i < i1; ++i) part += static_cast<double>(expf(logw[i] - mf));
  const double tot = block_sum(part, dred);
  const bool ok = isfinite(tot) && tot > 0.0;
  const float totf = static_cast<float>(tot);
  ll = ll + aux[2 * W - 1] * (ok ? mf + logf(totf) - logN : -INFINITY);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    double acc = 0.0;
    for (int i = i0; i < i1; ++i) {
      const float p = ok ? expf(logw[i] - mf) / totf : 1.0f / fN;
      acc += static_cast<double>(Vc[(D + h) * N + i] * p);
    }
    const double sh = block_sum(acc, dred);
    if (threadIdx.x == 0) out[static_cast<size_t>(c) * (H + 1) + h] =
        static_cast<float>(sh);
  }
  if (threadIdx.x == 0) out[static_cast<size_t>(c) * (H + 1) + H] = ll;
}

// Dynamic shared memory of one block: the reduction scratch, the
// per-step scalars, the CDF, the log-weights and two [K, N] carry buffers.
template <class Body>
size_t smem_bytes(int W, int N, bool valid) {
  constexpr int K = Body::D + Body::H;
  return kRed * sizeof(double) + kRed * sizeof(float)
      + sizeof(float) * ((valid ? 4 : 3) * static_cast<size_t>(W)
                         + 2 * static_cast<size_t>(N)
                         + 2 * static_cast<size_t>(K) * N);
}

template <class Body, bool kRng, bool kGate, bool kValid>
int launch_variant(const float* pvec, const float* x0, const float* normals,
                   const long long* seeds, const float* ys,
                   const float* weights, const float* xi, const float* vs,
                   float* out, int C, int W, int N, float lam, double ess_thr,
                   void* stream) {
  const size_t smem = smem_bytes<Body>(W, N, kValid);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_window_kernel<Body, kRng, kGate, kValid>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_window_kernel<Body, kRng, kGate, kValid><<<
      C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pvec, x0, normals, seeds, ys, weights, xi, vs, lam, ess_thr, W, N,
      out);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int(const float*, const float*, const float*,
                    const long long*, const float*, const float*,
                    const float*, const float*, float*, int, int, int, float,
                    double, void*);

template <class Body, bool kRng, bool kGate>
LaunchFn* pick_valid(bool valid) {
  return valid ? &launch_variant<Body, kRng, kGate, true>
               : &launch_variant<Body, kRng, kGate, false>;
}

template <class Body, bool kRng>
LaunchFn* pick_gate(bool gate, bool valid) {
  return gate ? pick_valid<Body, kRng, true>(valid)
              : pick_valid<Body, kRng, false>(valid);
}

template <class Body>
int launch(const float* pvec, const float* x0, const float* normals,
           const long long* seeds, const float* ys, const float* weights,
           const float* xi, const float* vs, float* out, int C, int W, int N,
           float lam, double ess_thr, void* stream) {
  if ((normals == nullptr) == (seeds == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool gate = ess_thr >= 0.0, valid = vs != nullptr;
  LaunchFn* variant = seeds != nullptr ? pick_gate<Body, true>(gate, valid)
                                       : pick_gate<Body, false>(gate, valid);
  return variant(pvec, x0, normals, seeds, ys, weights, xi, vs, out, C, W, N,
                 lam, ess_thr, stream);
}

}  // namespace

// One pair of entry points per body: the bytes of dynamic shared memory a
// block needs (with or without the valid gate's row), and the launch on
// `stream` of the calling thread's current device (the caller selects it),
// which returns cudaGetLastError().  Exactly one of `normals` (host
// normals) and `seeds` (in-kernel normals) is non-null; a negative
// `ess_thr` turns the ESS gate off, a null `vs` the valid gate.
#define SGMCMC_FUSED_WINDOW_ENTRY(NAME, BODY)                                \
  extern "C" size_t sgmcmc_fused_window_##NAME##_smem(int W, int N,          \
                                                      int valid) {           \
    return smem_bytes<BODY>(W, N, valid != 0);                               \
  }                                                                          \
  extern "C" int sgmcmc_fused_window_##NAME(                                 \
      const float* pvec, const float* x0, const float* normals,              \
      const long long* seeds, const float* ys, const float* weights,         \
      const float* xi, const float* vs, float* out, int C, int W, int N,    \
      float lam, double ess_thr, void* stream) {                             \
    return launch<BODY>(pvec, x0, normals, seeds, ys, weights, xi, vs, out,  \
                        C, W, N, lam, ess_thr, stream);                      \
  }
