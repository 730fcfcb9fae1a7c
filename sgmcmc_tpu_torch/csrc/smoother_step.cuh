// One window step of the unfused Poyiadjis O(N) smoother for Hopper
// (sm_90a): the whole step but the resampling, on the rows that the
// resample-apply kernel (resample_apply.cu) drew.  The kernel template, its
// launcher and the entry-point macro; smoother_step.cu instantiates it on
// the fused window's model bodies (<model>_body.cuh).
//
// The carry is one buffer [C, N, K], K = D + H: each particle's state, then
// its running statistic.  Resample-apply draws its rows Vr [C, N, K]; this
// kernel reads them and writes, for each chain c:
//   - the next carry: x' = propose(x, z, y), s' = s + (w_t in_t) h(x, x', y);
//   - the new log-weights log w' = reweight(x, x', y)  [C, N];
//   - the next step's CDF of w' by the fused window's rule: block max m
//     (0 where not finite), exp(log w' - m), a float64 prefix sum, rounded
//     once to float32 after its division by the total; the uniform
//     (j+1)/N where the total is not positive and finite  [C, N];
//   - the running log-likelihood: ll += (w_t in_t) (log tot + m - log N),
//     the unfused smoother's logsumexp(log w') - log N at the step itself.
// The step's normals z[c, q, n], y[c], w_t[c] and in_t[c] are read in
// place through their strides.
//
// Bits.  Built with --fmad=false and IEEE division and square root, the
// bodies round as PyTorch's elementwise operators do (see
// fused_window.cuh), and the unfused step's operators of the SVM and
// GARCH kernels run the same operations in the same order, so the carry,
// the log-weights and the CDF equal the PyTorch step's bit for bit.  The
// CDF's float64 prefix sum of float32 weights in (0, 1] is exact whatever
// its order while every weight is at least 2^-19 (at N <= 1024, whose
// partial sums keep 2^-42 as their last bit); rounded once to float32, it
// then selects as the PyTorch step's torch.cumsum does.  Only the
// log-likelihood's sum takes another order than torch.logsumexp's float32
// sum: the total in float64, rounded once.
//
// One block per chain, kThreads threads; warp w owns the particles of a
// segment [w * seg, (w + 1) * seg) of whole tiles of 32 (seg = 128 at
// N = 1000):
//   1. a chunk of up to kChunk tiles at a time, the warp copies the rows of
//      Vr, contiguous in device memory, and the normals into its staging
//      rows in shared memory (coalesced loads, all in flight before it
//      computes), each lane runs the particles of its column of the
//      chunk, and the warp copies the new rows out the same way; the
//      log-weights go out directly (coalesced) and stay in the staging
//      rows;
//   2. B1 (the warps' maxima of log w');
//   3. each warp sums exp(log w' - m) over its segment in float64, keeping
//      each w in its row; B2 (the segments' sums);
//   4. each warp scans its segment tile by tile (a warp scan plus the sum
//      of the earlier tiles and segments) and writes the CDF; thread 0 adds
//      the increment.
// Two barriers a step.  Past N = 1024 (more than one chunk a segment) the
// sum and the scan read the log-weights back from device memory.  Shared
// memory holds only the staging rows (kWarps x 128 x ((K + Z) | 1)
// floats) and the partials, so N is not limited by it.
//
// What bounds it: device memory.  Per particle it reads a row of Vr (4K B)
// and Z normals (4Z B) and writes a row (4K B), a log-weight and a CDF
// entry (8 B).  At C=8192, N=1000 on GARCH (K=6, Z=1) that is 0.49 GB,
// 0.147 ms at 3.35 TB/s; the kernel takes 0.214 ms on an H100 80GB HBM3.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sgmcmc_step {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Tiles of 32 particles a warp stages at once: its loads are all in flight
// before it computes.  A warp's segment of at most kChunk tiles (N <= 1024)
// keeps its log-weights in the staging rows through the prefix sum.
constexpr int kChunk = 4;
// Resident blocks an SM that __launch_bounds__ asks registers for (at most
// 51 a thread).  On an H100 80GB HBM3 at C=8192, N=1000 (GARCH optimal)
// 5 took 0.217 ms a step, against 0.230 at 6 and 0.234-0.273 with the
// compiler's own 59-65 registers (4 blocks); 128-thread blocks 0.234-0.260.
constexpr int kMinBlocks = 5;

// @region reduce
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Inclusive scan over the lanes of a warp.
__device__ __forceinline__ double warp_scan(double x) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// @region kernel
template <class Body>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
smoother_step_kernel(const float* __restrict__ vr,    // [C, N, K]
                     const float* __restrict__ pvec,  // [C, P]
                     const float* __restrict__ z,     // z[c, q, n] by strides
                     long long z_c, long long z_q, long long z_n,
                     const float* __restrict__ y, long long y_c,
                     const float* __restrict__ wt, long long w_c,
                     const float* __restrict__ inw, long long i_c,
                     float log_n, int N,
                     float* __restrict__ vn,          // [C, N, K]
                     float* __restrict__ lw,          // [C, N]
                     float* __restrict__ cdf,         // [C, N]
                     float* __restrict__ ll) {        // [C], updated
  constexpr int D = Body::D, Z = Body::Z, H = Body::H, P = Body::P;
  constexpr int K = D + H;
  // a staging row: the particle's K carries, then its Z normals (whose
  // first slot takes its log-weight, then its weight, once they are read);
  // an odd stride, so that 32 lanes reading their own rows hit 32 banks
  constexpr int KP = (K + Z) | 1;
  constexpr int kRows = kChunk * 32;
  __shared__ float stage[kWarps][kRows * KP];
  __shared__ float smax[kWarps];
  __shared__ double ssum[kWarps];

  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float pv[P];
#pragma unroll
  for (int p = 0; p < P; ++p) pv[p] = pvec[static_cast<size_t>(c) * P + p];
  const float yc = y[c * y_c];
  const float scale = wt[c * w_c] * inw[c * i_c];
  const size_t base = static_cast<size_t>(c) * N;
  const float* vr_c = vr + base * K;
  float* vn_c = vn + base * K;
  float* lw_c = lw + base;
  float* cdf_c = cdf + base;
  const float* zc = z + c * z_c;
  float* st = stage[warp];

  // the warp's segment: particles [j0, j1), whole tiles of 32 but the last
  const int tiles = (N + 31) / 32;
  const int seg = (tiles + kWarps - 1) / kWarps * 32;
  const int j0 = min(warp * seg, N), j1 = min(j0 + seg, N);
  // one chunk holds the segment: its log-weights stay in the staging rows
  const bool held = seg <= kRows;

  // 1. propose, reweight, statistic, a chunk of the segment at a time
  float mloc = -INFINITY;
#pragma unroll 1
  for (int p0 = j0; p0 < j1; p0 += kRows) {
    const int np = min(kRows, j1 - p0);
    const size_t off = static_cast<size_t>(p0) * K;
    for (int j = lane; j < np * K; j += 32)
      st[(j / K) * KP + j % K] = vr_c[off + j];
    for (int r = lane; r < np; r += 32) {
#pragma unroll
      for (int q = 0; q < Z; ++q)
        st[r * KP + K + q] = zc[q * z_q + (p0 + r) * z_n];
    }
    __syncwarp();
#pragma unroll 1
    for (int r = lane; r < np; r += 32) {
      float* row = st + r * KP;
      float x[D], s[H], zz[Z], xn[D], hv[H];
#pragma unroll
      for (int d = 0; d < D; ++d) x[d] = row[d];
#pragma unroll
      for (int h = 0; h < H; ++h) s[h] = row[D + h];
#pragma unroll
      for (int q = 0; q < Z; ++q) zz[q] = row[K + q];
      Body::propose(pv, zz, x, yc, xn);
      const float lwn = Body::reweight(pv, x, xn, yc);
      Body::stat(pv, x, xn, yc, hv);
#pragma unroll
      for (int d = 0; d < D; ++d) row[d] = xn[d];
#pragma unroll
      for (int h = 0; h < H; ++h) row[D + h] = s[h] + scale * hv[h];
      row[K] = lwn;
      lw_c[p0 + r] = lwn;
      mloc = fmaxf(mloc, lwn);
    }
    __syncwarp();
    for (int j = lane; j < np * K; j += 32)
      vn_c[off + j] = st[(j / K) * KP + j % K];
    __syncwarp();
  }
  mloc = warp_max(mloc);
  if (lane == 0) smax[warp] = mloc;
  __syncthreads();                                   // B1
  const float m = warp_max(lane < kWarps ? smax[lane] : -INFINITY);
  const float mf = isfinite(m) ? m : 0.0f;

  // 2. the segments' sums of w = exp(log w' - m), in float64 (a held
  // segment keeps w in place of its log-weights)
  double part = 0.0;
#pragma unroll 4
  for (int i = j0 + lane; i < j1; i += 32) {
    float w;
    if (held) {
      float* slot = st + (i - j0) * KP + K;
      w = expf(*slot - mf);
      *slot = w;
    } else {
      w = expf(lw_c[i] - mf);
    }
    part += static_cast<double>(w);
  }
  part = warp_sum(part);
  if (lane == 0) ssum[warp] = part;
  __syncthreads();                                   // B2
  const double r = warp_scan(lane < kWarps ? ssum[lane] : 0.0);
  const double tot = __shfl_sync(kFull, r, kWarps - 1);
  const double before = __shfl_sync(kFull, r, (warp + 31) & 31);
  double run = warp > 0 ? before : 0.0;
  const bool ok = isfinite(tot) && tot > 0.0;
  const float fN = static_cast<float>(N);

  // 3. the CDF, a tile of the segment at a time
#pragma unroll 1
  for (int t0 = j0; t0 < j1; t0 += 32) {
    const int i = t0 + lane;
    double w = 0.0;
    if (i < j1)
      w = static_cast<double>(held ? st[(i - j0) * KP + K]
                                   : expf(lw_c[i] - mf));
    const double incl = warp_scan(w);
    if (i < j1)
      cdf_c[i] = ok ? static_cast<float>((run + incl) / tot)
                    : static_cast<float>(i + 1) / fN;
    run += __shfl_sync(kFull, incl, 31);
  }
  if (threadIdx.x == 0) {
    const float inc = logf(static_cast<float>(tot)) + mf - log_n;
    ll[c] = ll[c] + scale * inc;
  }
}

// @region launch
template <class Body>
int launch(const float* vr, const float* pvec, const float* z,
           long long z_c, long long z_q, long long z_n, const float* y,
           long long y_c, const float* wt, long long w_c, const float* inw,
           long long i_c, float log_n, float* vn, float* lw, float* cdf,
           float* ll, int C, int N, void* stream) {
  if (C < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  smoother_step_kernel<Body>
      <<<C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          vr, pvec, z, z_c, z_q, z_n, y, y_c, wt, w_c, inw, i_c, log_n, N,
          vn, lw, cdf, ll);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgmcmc_step

// The entry point of one body: the launch on `stream` of the calling
// thread's current device (the caller selects it), which returns
// cudaGetLastError().  vr, pvec, vn, lw, cdf and ll are contiguous; z, y,
// wt and inw are read at the element strides given.
#define SGMCMC_SMOOTHER_STEP_ENTRY(NAME, BODY)                                \
  extern "C" int sgmcmc_smoother_step_##NAME(                                 \
      const float* vr, const float* pvec, const float* z, long long z_c,     \
      long long z_q, long long z_n, const float* y, long long y_c,            \
      const float* wt, long long w_c, const float* inw, long long i_c,       \
      float log_n, float* vn, float* lw, float* cdf, float* ll, int C,       \
      int N, void* stream) {                                                  \
    return sgmcmc_step::launch<BODY>(vr, pvec, z, z_c, z_q, z_n, y, y_c, wt, \
                                     w_c, inw, i_c, log_n, vn, lw, cdf, ll,  \
                                     C, N, stream);                           \
  }
