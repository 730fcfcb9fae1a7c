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
// One block per chain, kThreads threads; thread k owns the contiguous
// particles [k*c, (k+1)*c), c = ceil(N / kThreads).  Per step t:
//   1. block max m of log w, w = exp(log w - m);
//   2. block prefix sum of w, accumulated in float64, CDF = csum / tot
//      rounded to float32 (uniform (j+1)/N when tot is not positive and
//      finite), and the deferred log-likelihood increment of step t-1:
//      ll += w_{t-1} * (m + log tot - log N), -inf when degenerate;
//   3. (lambda < 1) the weight-averaged statistic S_bar;
//   4. for each owned output particle i: ancestor a = #{j : cdf_j <= pos_i}
//      at pos_i = (i + xi_t) / N, clipped to N-1, gather state and
//      statistics of a, propose, reweight, and update
//      s' = lambda s + (1 - lambda) S_bar + w_t h.
// The epilogue adds the last step's increment and writes the
// weight-averaged statistic and the log-likelihood: out[c] = [stat | ll].
//
// Barriers.  A block reduction takes one barrier: each warp writes its
// partial, and after the barrier every warp reduces all kWarps partials
// itself (the same operations in the same order in every warp, so every
// thread holds the same result and no broadcast is needed).  A step has
// three: B1 (the max partials, which each thread publishes at the end of
// the previous step's part 4, so B1 also closes that step's gathers),
// B2 (the scan partials, with sum w^2 of the ESS gate beside them) and B3
// (the CDF complete, with the partial sums of S_bar beside it).  B3 is
// left out when the ESS gate keeps every particle and lambda = 1.
//
// Ancestors.  A thread's positions increase with i, so the first is found
// by binary search and each later one by walking forward from the last
// with the same predicate cdf_j <= pos (after kWalk steps the rest of the
// range is searched): the same index, with fewer dependent loads.  For a
// power-of-two N, (i + xi) * (1/N) is (i + xi) / N exactly.
//
// Options, each a template parameter, so that each variant compiles
// without the others' code and registers (the launcher picks the variant
// from its arguments):
//   - in-kernel normals (seeds != nullptr): the proposal normals come from
//     the Philox generator of philox.cuh, keyed by the chain's seed, at
//     counter (i >> 1, t, q, 0), instead of the normals array (the JAX
//     package's rng="kernel", _box_muller).  Host normals are copied to
//     shared memory by cp.async.  Both are staged right after B1, before
//     the scan's and the CDF's barriers, so that the generator's work and
//     the loads overlap those barriers' waits;
//   - the ESS gate (ess_thr >= 0): with ESS = tot^2 / sum w^2 of the
//     max-shifted weights, a chain resamples only when ESS < ess_thr * N or
//     its weights are degenerate; otherwise every particle keeps its own
//     state (ancestor i) and its new log-weight gains
//     log w_i - m - log tot + log N (fused_pf.py's ESS gate);
//   - the valid gate (vs != nullptr; fused_pf.py's valid_gate): a step with
//     vs[c, t] <= 0 skips part 4, so the chain keeps its carries and
//     log-weights.  The step after such a step finds the log-weights, the
//     carries and the CDF unchanged, so it reuses m, tot, the CDF, the ESS
//     decision, S_bar and the increment of the last computed step, with no
//     barrier: a padded tail costs one multiply-add a step (on the Seq LD
//     fit's windows, 32% of them padding, this saves 9% of the time).
//
// Layout.  The per-step scalars (y, weight, xi, valid) are read from
// device memory (one cached load each a step).  Shared memory holds the
// reduction scratch, the CDF [N], the log-weights [N] and two carry
// buffers [K, N] (state and statistics, K = D + H; the step's normals
// are staged in the first Z rows of the next step's buffer until part 4
// overwrites them): smem_of gives the bytes.  A thread reads and writes
// the log-weights, the normals and the next step's carries of its own
// particles only.  At N = 1024 a block takes 41,312 bytes (SVM, K=4),
// 49,568 (LGSSM, K=5), 57,760 (GARCH, K=6) and 57,824 (SVJM), which lets
// 5, 4, 3 and 3 blocks share an SM; __launch_bounds__ asks the compiler
// for registers that allow as many (min_blocks).  Keeping the
// log-weights and the next carries in registers instead halves the
// shared memory but takes 89-128 registers, 2 blocks per SM, and was
// slower on every variant.
//
// What bounds it on the card is not measured.  Its byte and operation
// bound (chip_smoke.py) is 7-11x below its time.  An estimate from static
// SASS counts (scripts/kernel_resources.py) and a hand count of the
// instructions a particle-step runs (accurate expf / logf, no FMA
// contraction, the float64 prefix sum and CDF division, Philox and
// Box-Muller) puts the time that 132 SMs x 4 schedulers take to issue
// them at about 0.7 of the kernel's; no dynamic instruction count
// confirms it.  The design cuts instructions (the ancestor walk, one
// barrier per reduction, no per-step work on padded steps) and keeps
// registers to the blocks that shared memory allows.
//
// The prefix sum runs in float64 so that the float32 CDF does not depend
// on the summation order: the plain PyTorch version (torch.cumsum in
// float64) then selects the same ancestors.  The file is compiled with
// --fmad=false for the same reason: the model body rounds after every
// operation, as PyTorch's elementwise operators do.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Steps of the ancestor walk before it falls back to a binary search.
constexpr int kWalk = 4;
// Shared memory of an SM (228 KB), reserved per block (1 KB), and the
// particle count of the sampling paths.
constexpr size_t kSmemPerSM = 233472, kSmemReserved = 1024;
constexpr int kPathN = 1024;

// @region reduce
// Reduction scratch at the start of dynamic shared memory.
template <int H>
struct Scratch {
  double scan[kWarps];       // inclusive warp totals of sum w
  double sq[kWarps];         // warp sums of w^2 (ESS gate)
  double sbar[H][kWarps];    // warp sums of the weighted statistics
  float max[kWarps];         // warp maxima of the log-weights
};

// Dynamic shared memory of one block: the reduction scratch, then the
// CDF [N], the log-weights [N] and two carry buffers [K, N] (this step's
// and the next step's; the step's normals are staged in the first Z rows
// of the next step's buffer).
template <class Body>
__host__ __device__ constexpr size_t smem_of(int N) {
  return sizeof(Scratch<Body::H>) + sizeof(float)
      * static_cast<size_t>(2 + 2 * (Body::D + Body::H)) * N;
}

// The resident blocks per SM that shared memory allows at kPathN (at most
// 2048 / kThreads): __launch_bounds__ asks the compiler to fit the
// registers to as many, so that registers do not set a lower count.
template <class Body>
__host__ __device__ constexpr int min_blocks() {
  const size_t by_smem = kSmemPerSM / (smem_of<Body>(kPathN) + kSmemReserved);
  const size_t by_threads = 2048 / kThreads;
  return static_cast<int>(by_smem < by_threads ? by_smem : by_threads);
}

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

// The max / sum of the kWarps partials, in every lane of every warp.
__device__ __forceinline__ float all_max(const float* p) {
  const int lane = threadIdx.x & 31;
  return warp_max(lane < kWarps ? p[lane] : -INFINITY);
}

__device__ __forceinline__ double all_sum(const double* p) {
  const int lane = threadIdx.x & 31;
  return warp_sum(lane < kWarps ? p[lane] : 0.0);
}

// Writes the warp's max of v; B1 publishes it.
__device__ __forceinline__ void publish_max(float v, float* p) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) p[threadIdx.x >> 5] = v;
}

// @region normals
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The step's normals of the thread's particles into zs [Z, N]: Philox and
// Box-Muller (one Philox call per pair of particles), or asynchronous
// copies of the host normals nz [Z, N] (16 bytes where aligned).
template <class Body, bool kRng>
__device__ __forceinline__ void stage_normals(float* zs, const float* nz,
                                              uint32_t key0, uint32_t key1,
                                              int t, int i0, int cnt, int N) {
  constexpr int Z = Body::Z;
  if constexpr (kRng) {
    uint4 r[Z];
#pragma unroll 1
    for (int k = 0; k < cnt; ++k) {
      const int i = i0 + k;
      if (k == 0 || (i & 1) == 0) {
#pragma unroll
        for (int q = 0; q < Z; ++q) r[q] = philox_pair(key0, key1, i >> 1, t,
                                                       q, 0);
      }
#pragma unroll
      for (int q = 0; q < Z; ++q)
        zs[q * N + i] = (i & 1) ? box_muller(r[q].z, r[q].w)
                                : box_muller(r[q].x, r[q].y);
    }
  } else {
#pragma unroll
    for (int q = 0; q < Z; ++q) {
      const float* src = nz + q * N + i0;
      float* dst = zs + q * N + i0;
      int k = 0;
      while (k < cnt) {
        if (k + 4 <= cnt && ((reinterpret_cast<uintptr_t>(src + k)
                              | reinterpret_cast<uintptr_t>(dst + k))
                             & 15) == 0) {
          cp_async16(dst + k, src + k);
          k += 4;
        } else {
          cp_async4(dst + k, src + k);
          k += 1;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
}

// @region search
// #{j : cdf_j <= pos}: a walk forward from `from` (the count at a smaller
// position of the same step) of at most kWalk steps, then a binary search
// of the rest; from < 0 searches the whole range.
__device__ __forceinline__ int upper_bound_from(const float* cdf, int N,
                                                float pos, int from) {
  int lo = 0;
  if (from >= 0) {
    lo = from;
#pragma unroll
    for (int s = 0; s < kWalk; ++s) {
      if (lo >= N || !(cdf[lo] <= pos)) return lo;
      ++lo;
    }
  }
  int hi = N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] <= pos) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// @region prologue
template <class Body, bool kRng, bool kGate, bool kValid>
__global__ void __launch_bounds__(kThreads, min_blocks<Body>())
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
  Scratch<H>& sc = *reinterpret_cast<Scratch<H>*>(smem);
  float* cdf = reinterpret_cast<float*>(smem + sizeof(Scratch<H>));  // [N]
  float* lw = cdf + N;        // [N] log-weights
  float* Vc = lw + N;         // [K, N] the carries of this step
  float* Vn = Vc + K * N;     // [K, N] the carries of the next step

  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = (N + kThreads - 1) / kThreads;
  const int i0 = min(static_cast<int>(threadIdx.x) * chunk, N);
  const int i1 = min(i0 + chunk, N);
  const int cnt = i1 - i0;
  const float fN = static_cast<float>(N);
  const float logN = logf(fN);
  const float om = 1.0f - lam;
  const bool pow2 = (N & (N - 1)) == 0;
  const float invN = 1.0f / fN;
  uint32_t key0 = 0, key1 = 0;
  if (kRng) {
    const unsigned long long sd = static_cast<unsigned long long>(seeds[c]);
    key0 = static_cast<uint32_t>(sd);
    key1 = static_cast<uint32_t>(sd >> 32);
  }
  float pv[P];
#pragma unroll
  for (int p = 0; p < P; ++p) pv[p] = pvec[static_cast<size_t>(c) * P + p];
  const size_t row = static_cast<size_t>(c) * W;

  for (int i = i0; i < i1; ++i) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      Vc[d * N + i] = x0[(static_cast<size_t>(c) * D + d) * N + i];
#pragma unroll
    for (int h = 0; h < H; ++h) Vc[(D + h) * N + i] = 0.0f;
    lw[i] = 0.0f;
  }
  publish_max(cnt > 0 ? 0.0f : -INFINITY, sc.max);

  // m, tot, ok, the CDF, do_res, S_bar and inc are those of the current
  // log-weights unless `stale`
  bool stale = true, ok = true, do_res = true;
  float mf = 0.0f, totf = 0.0f, ltot = 0.0f, inc = 0.0f;
  double tot = 0.0;
  float sbar[H];
#pragma unroll
  for (int h = 0; h < H; ++h) sbar[h] = 0.0f;
  const bool shrink = lam != 1.0f;
  float ll = 0.0f, wprev = 0.0f;

  // @region parts1-3
  for (int t = 0; t < W; ++t) {
    const float y = ys[row + t], wt = weights[row + t], xit = xi[row + t];
    const bool valid = !kValid || vs[row + t] > 0.0f;
    if (stale) __syncthreads();                    // B1: max partials
    // The step's normals go to rows q < Z of Vn, which the last gathers
    // read as Vc: they are done once a thread has passed that step's next
    // B1.  A thread writes and reads only its own particles' normals.
    if (valid)
      stage_normals<Body, kRng>(
          Vn, kRng ? nullptr : normals + (row + t) * Z * N, key0, key1, t,
          i0, cnt, N);

    if (stale) {
      const float m = all_max(sc.max);
      mf = isfinite(m) ? m : 0.0f;
      // 1-2. weights, float64 prefix sum, CDF, increment
      double part = 0.0, part2 = 0.0;
#pragma unroll 1
      for (int i = i0; i < i1; ++i) {
        const float w = expf(lw[i] - mf);
        cdf[i] = w;
        part += static_cast<double>(w);
        if (kGate) part2 += static_cast<double>(w) * static_cast<double>(w);
      }
      const double x = warp_scan(part);
      if (lane == 31) sc.scan[warp] = x;
      if (kGate) {
        const double q = warp_sum(part2);
        if (lane == 0) sc.sq[warp] = q;
      }
      __syncthreads();                             // B2: scan partials
      const double r = warp_scan(lane < kWarps ? sc.scan[lane] : 0.0);
      const double r_prev = __shfl_sync(kFull, r, (warp + 31) & 31);
      tot = __shfl_sync(kFull, r, kWarps - 1);
      double run = (warp > 0 ? r_prev : 0.0) + (x - part);
      ok = isfinite(tot) && tot > 0.0;
      totf = static_cast<float>(tot);
      ltot = logf(totf);
      inc = ok ? mf + ltot - logN : -INFINITY;
      if (kGate) {
        const double sumsq = all_sum(sc.sq);
        const double ess = tot * tot / (sumsq > 0.0 ? sumsq : 1.0);
        do_res = !ok || ess < ess_thr * static_cast<double>(N);
      }
      if (do_res) {
#pragma unroll 1
        for (int i = i0; i < i1; ++i) {
          run += static_cast<double>(cdf[i]);
          cdf[i] = ok ? static_cast<float>(run / tot)
                      : static_cast<float>(i + 1) / fN;
        }
      }
      // 3. weight-averaged statistic for the shrinkage term
      if (shrink) {
        double acc[H];
#pragma unroll
        for (int h = 0; h < H; ++h) acc[h] = 0.0;
#pragma unroll 1
        for (int i = i0; i < i1; ++i) {
          const float p = ok ? expf(lw[i] - mf) / totf : 1.0f / fN;
#pragma unroll
          for (int h = 0; h < H; ++h)
            acc[h] += static_cast<double>(Vc[(D + h) * N + i] * p);
        }
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const double s = warp_sum(acc[h]);
          if (lane == 0) sc.sbar[h][warp] = s;
        }
      }
      if (do_res || shrink) __syncthreads();       // B3: CDF and S_bar
      if (shrink) {
#pragma unroll
        for (int h = 0; h < H; ++h)
          sbar[h] = static_cast<float>(all_sum(sc.sbar[h]));
      }
      stale = false;
    }
    if (t > 0) ll = ll + wprev * inc;
    wprev = wt;
    if (!valid) continue;

    // @region part4
    // 4. resample, propose, reweight, statistic
    if (!kRng) cp_async_wait_all();
    float mloc = -INFINITY;
    int a_run = -1;
#pragma unroll 1
    for (int i = i0; i < i1; ++i) {
      int a = i;
      if (do_res) {
        const float pos = pow2 ? (static_cast<float>(i) + xit) * invN
                               : (static_cast<float>(i) + xit) / fN;
        a_run = upper_bound_from(cdf, N, pos, a_run);
        a = min(a_run, N - 1);
      }
      float x[D], s[H], z[Z], xn[D], hv[H];
#pragma unroll
      for (int d = 0; d < D; ++d) x[d] = Vc[d * N + a];
#pragma unroll
      for (int h = 0; h < H; ++h) s[h] = Vc[(D + h) * N + a];
#pragma unroll
      for (int q = 0; q < Z; ++q) z[q] = Vn[q * N + i];   // before Vn[., i]
      // the gate's carried weight reads this particle's old log-weight
      const float carried = do_res ? 0.0f : lw[i] - mf - ltot + logN;
      Body::propose(pv, z, x, y, xn);
      const float lwp = Body::reweight(pv, x, xn, y);
      const float lwn = do_res ? lwp : lwp + carried;
      lw[i] = lwn;
      mloc = fmaxf(mloc, lwn);
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
    stale = true;
    publish_max(mloc, sc.max);   // read after the next B1
  }

  // @region epilogue
  // the last deferred increment and the weight-averaged statistic (m and
  // tot computed anew, cached or not: the same values)
  __syncthreads();
  const float m = all_max(sc.max);
  mf = isfinite(m) ? m : 0.0f;
  double part = 0.0;
#pragma unroll 1
  for (int i = i0; i < i1; ++i) part += static_cast<double>(expf(lw[i] - mf));
  const double incl = warp_scan(part);
  if (lane == 31) sc.scan[warp] = incl;
  __syncthreads();
  tot = __shfl_sync(kFull, warp_scan(lane < kWarps ? sc.scan[lane] : 0.0),
                    kWarps - 1);
  ok = isfinite(tot) && tot > 0.0;
  totf = static_cast<float>(tot);
  inc = ok ? mf + logf(totf) - logN : -INFINITY;
  ll = ll + wprev * inc;
  double acc[H];
#pragma unroll
  for (int h = 0; h < H; ++h) acc[h] = 0.0;
#pragma unroll 1
  for (int i = i0; i < i1; ++i) {
    const float p = ok ? expf(lw[i] - mf) / totf : 1.0f / fN;
#pragma unroll
    for (int h = 0; h < H; ++h)
      acc[h] += static_cast<double>(Vc[(D + h) * N + i] * p);
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const double s = warp_sum(acc[h]);
    if (lane == 0) sc.sbar[h][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const double s = all_sum(sc.sbar[h]);
      if (lane == 0) out[static_cast<size_t>(c) * (H + 1) + h] =
          static_cast<float>(s);
    }
    if (lane == 0) out[static_cast<size_t>(c) * (H + 1) + H] = ll;
  }
}

// @region launch
using KernelFn = void (*)(const float*, const float*, const float*,
                          const long long*, const float*, const float*,
                          const float*, const float*, float, double, int, int,
                          float*);

template <class Body, bool kRng, bool kGate>
KernelFn pick_valid(bool valid) {
  return valid ? &fused_window_kernel<Body, kRng, kGate, true>
               : &fused_window_kernel<Body, kRng, kGate, false>;
}

template <class Body, bool kRng>
KernelFn pick_gate(bool gate, bool valid) {
  return gate ? pick_valid<Body, kRng, true>(valid)
              : pick_valid<Body, kRng, false>(valid);
}

// The variant for in-kernel normals (rng), the ESS gate and the valid gate.
template <class Body>
KernelFn pick(bool rng, bool gate, bool valid) {
  return rng ? pick_gate<Body, true>(gate, valid)
             : pick_gate<Body, false>(gate, valid);
}

// Lets a block of `kernel` take `smem` bytes of dynamic shared memory.
inline cudaError_t allow_smem(KernelFn kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <class Body>
int launch(const float* pvec, const float* x0, const float* normals,
           const long long* seeds, const float* ys, const float* weights,
           const float* xi, const float* vs, float* out, int C, int W, int N,
           float lam, double ess_thr, void* stream) {
  if ((normals == nullptr) == (seeds == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn kernel = pick<Body>(seeds != nullptr, ess_thr >= 0.0,
                                     vs != nullptr);
  const size_t smem = smem_of<Body>(N);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pvec, x0, normals, seeds, ys, weights, xi, vs, lam, ess_thr, W, N, out);
  return static_cast<int>(cudaGetLastError());
}

// What the runtime reports for one variant at N particles on the current
// device: out = [resident blocks per SM, the same with no dynamic shared
// memory, registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per block, threads per block, the SM's most threads].
template <class Body>
int occupancy(bool rng, bool gate, bool valid, int N, int* out) {
  const KernelFn kernel = pick<Body>(rng, gate, valid);
  const size_t smem = smem_of<Body>(N);
  cudaFuncAttributes attr;
  int blocks = 0, bare = 0, device = 0, sm_threads = 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bare, kernel,
                                                        kThreads, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &sm_threads, cudaDevAttrMaxThreadsPerMultiProcessor, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[7] = {blocks, bare, attr.numRegs,
                       static_cast<int>(attr.localSizeBytes),
                       static_cast<int>(smem), kThreads, sm_threads};
  for (int k = 0; k < 7; ++k) out[k] = vals[k];
  return 0;
}

}  // namespace

// The entry points of one body: the bytes of dynamic shared memory a block
// needs (the query keeps its (W, valid) arguments, which no longer change
// the bytes), the launch on `stream` of the calling thread's current
// device (the caller selects it), which returns cudaGetLastError(), and
// the runtime's occupancy report of one variant (see occupancy above; 0 or
// a CUDA error code).  Exactly one of `normals` (host normals) and `seeds`
// (in-kernel normals) is non-null; a negative `ess_thr` turns the ESS gate
// off, a null `vs` the valid gate.
#define SGMCMC_FUSED_WINDOW_ENTRY(NAME, BODY)                                \
  extern "C" size_t sgmcmc_fused_window_##NAME##_smem(int W, int N,          \
                                                      int valid) {           \
    return smem_of<BODY>(N);                                                 \
  }                                                                          \
  extern "C" int sgmcmc_fused_window_##NAME(                                 \
      const float* pvec, const float* x0, const float* normals,              \
      const long long* seeds, const float* ys, const float* weights,         \
      const float* xi, const float* vs, float* out, int C, int W, int N,    \
      float lam, double ess_thr, void* stream) {                             \
    return launch<BODY>(pvec, x0, normals, seeds, ys, weights, xi, vs, out,  \
                        C, W, N, lam, ess_thr, stream);                      \
  }                                                                          \
  extern "C" int sgmcmc_fused_window_##NAME##_occupancy(                     \
      int rng, int gate, int valid, int N, int* out) {                       \
    return occupancy<BODY>(rng != 0, gate != 0, valid != 0, N, out);         \
  }
