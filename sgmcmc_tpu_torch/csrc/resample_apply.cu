// Resample-apply for Hopper (sm_90a): out[c, i, :] = vals[c, a(c, i), :]
// with the ancestor a(c, i) = min(#{j : cdf[c, j] <= pos[c, i]}, N-1),
// the port's one ancestor rule (searchsorted side="right").
//
// Replaces three TPU kernels of sgmcmc_tpu/ops/pallas/resample.py, which
// compute this one function:
//   K2a _resample2_kernel (:178), launched by resample_apply_pallas2;
//   K2b _resample2_batched_kernel (:232), by resample_apply_pallas2_batched;
//   K3  _resample_kernel (:31), by resample_apply_pallas.
// It computes what they compute, not the way Mosaic computed it: no one-hot
// matrix, no bf16 hi/lo value split, no three-piece CDF split.  Those exist
// because a TPU cannot gather along lanes; here the ancestor is a binary
// search and the values are copied, so the output equals the plain version
// (torch.searchsorted + torch.gather) bit for bit.
//
// Layout: pos [C, n], cdf [C, N] (non-decreasing), vals [C, N, K] and
// out [C, n, K], float32, contiguous.  One block of 256 threads per
// (chain, tile of 1024 positions):
//   1. the chain's CDF is copied into shared memory (when N*4 bytes plus
//      the tile's indices fit in the 227 KB a block may use; beyond that,
//      N > max_shared_n(), the same code searches the CDF in device memory);
//   2. each thread finds the ancestors of its positions by binary search
//      (multinomial positions are unsorted, so no merge path) and stores
//      them in shared memory;
//   3. the block copies the tile's rows, as one 16-byte load and store per
//      row when K = 4 and the rows are 16-byte aligned, else one float per
//      thread over the tile's n_tile * K outputs, so that neighbouring
//      threads write neighbouring addresses.
//
// What bounds it on the card: device memory.  Per particle it reads pos
// (4 B), the CDF (4 B) and one row of vals (4K B) and writes 4K B, and it
// does only about log2(N) compares per position: at C=8192, N=1024, K=4
// that is 335.5 MB, about 0.10 ms at 3.35 TB/s.  The design reads the CDF
// and the positions once, coalesced, keeps the search in shared memory,
// and writes the output coalesced; the row reads are a gather within the
// chain's N*K*4 bytes (16 KB at N=1024, K=4), which stay in L1/L2.
//
// Wide rows.  The particle filter's predict surface resamples each row of
// an elementwise statistic with the particles: K = D + T * dim, 2,000-3,000
// floats at T = 1000, for one chain (or one row per sequence).  There the
// launch above is C * ceil(n / 1024) blocks, one block for one chain, which
// copies 12 MB alone on a card of 132 SMs, one division per element.  The
// wide launch, which the caller chooses (ops/cuda/resample.py), gives each
// warp one position and a slice of kWideCols = 1024 columns of its row
// (32 a lane), in a grid of (C * ceil(n / 8)) x ceil(K / 1024) blocks of 8
// warps.  The warp finds its ancestor together: each level of the search
// probes 32 evenly spaced CDF entries (one a lane, the CDF in L2) and
// narrows the range to the gap the ballot of `cdf <= pos` ends in, so
// N = 1000 takes two dependent loads, not ten.  Then every lane loads its
// 32 floats before it stores them: no shared memory, no barrier, no
// division per element, a lane's neighbours on neighbouring columns.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;            // positions per block
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory per block
// the wide launch: a warp a position, kWideCols columns a block
constexpr int kWarps = kThreads / 32;
constexpr int kLaneCols = 32;
constexpr int kWideCols = 32 * kLaneCols;
constexpr unsigned kFullMask = 0xffffffffu;

size_t shared_bytes(int N) {
  return kTile * sizeof(int) + static_cast<size_t>(N) * sizeof(float);
}

__device__ __forceinline__ int ancestor(const float* cdf, int N, float p) {
  int lo = 0, hi = N;  // upper bound: first j with cdf[j] > p
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < N ? lo : N - 1;
}

template <bool kSharedCdf>
__global__ void __launch_bounds__(kThreads)
resample_apply_kernel(const float* __restrict__ pos,
                      const float* __restrict__ cdf,
                      const float* __restrict__ vals,
                      float* __restrict__ out, int n, int N, int K,
                      int tiles, bool vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sidx = reinterpret_cast<int*>(smem);
  const int c = blockIdx.x / tiles;
  const int i0 = (blockIdx.x - c * tiles) * kTile;
  const int cnt = min(kTile, n - i0);
  const float* cdf_c = cdf + static_cast<size_t>(c) * N;
  const float* search = cdf_c;
  if (kSharedCdf) {
    float* scdf = reinterpret_cast<float*>(smem + kTile * sizeof(int));
    for (int j = threadIdx.x; j < N; j += kThreads) scdf[j] = cdf_c[j];
    __syncthreads();
    search = scdf;
  }
  const float* pos_t = pos + static_cast<size_t>(c) * n + i0;
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    sidx[i] = ancestor(search, N, pos_t[i]);
  }
  __syncthreads();
  const float* vals_c = vals + static_cast<size_t>(c) * N * K;
  float* out_t = out + (static_cast<size_t>(c) * n + i0) * K;
  if (vec4) {
    const float4* v4 = reinterpret_cast<const float4*>(vals_c);
    float4* o4 = reinterpret_cast<float4*>(out_t);
    for (int i = threadIdx.x; i < cnt; i += kThreads) o4[i] = v4[sidx[i]];
  } else {
    const int total = cnt * K;
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int i = e / K;
      out_t[e] = vals_c[static_cast<size_t>(sidx[i]) * K + (e - i * K)];
    }
  }
}

// The ancestor min(#{j : cdf[j] <= p}, N-1) of a warp's position p (the
// same in every lane).  The answer lies in [lo, hi]; a level probes
// lo + (l+1) * step - 1 in lane l, and the lanes whose probe is <= p form
// a prefix of cnt lanes (the CDF is non-decreasing), so it lies in
// [lo + cnt * step, lo + (cnt+1) * step - 1]; the last level probes every
// entry of a range of at most 32.
__device__ __forceinline__ int warp_ancestor(const float* cdf, int N,
                                             float p, int lane) {
  int lo = 0, hi = N;
  int len = N;  // a bound on hi - lo
  while (len > 32) {
    const int step = (len + 31) / 32;
    const int j = lo + (lane + 1) * step - 1;
    const int cnt = __popc(__ballot_sync(kFullMask,
                                         j < hi && cdf[j] <= p));
    hi = min(hi, lo + (cnt + 1) * step - 1);
    lo += cnt * step;
    len = step - 1;
  }
  const int j = lo + lane;
  return min(lo + __popc(__ballot_sync(kFullMask, j < hi && cdf[j] <= p)),
             N - 1);
}

__global__ void __launch_bounds__(kThreads)
resample_apply_wide_kernel(const float* __restrict__ pos,
                           const float* __restrict__ cdf,
                           const float* __restrict__ vals,
                           float* __restrict__ out, int n, int N, int K,
                           int row_tiles) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x / row_tiles;
  const int i = (blockIdx.x - c * row_tiles) * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp: no barrier follows
  const int a = warp_ancestor(cdf + static_cast<size_t>(c) * N, N,
                              pos[static_cast<size_t>(c) * n + i], lane);
  const float* src = vals + (static_cast<size_t>(c) * N + a) * K;
  float* dst = out + (static_cast<size_t>(c) * n + i) * K;
  const int k0 = blockIdx.y * kWideCols + lane;
  float v[kLaneCols];
#pragma unroll
  for (int j = 0; j < kLaneCols; ++j) {
    const int k = k0 + 32 * j;
    if (k < K) v[j] = src[k];
  }
#pragma unroll
  for (int j = 0; j < kLaneCols; ++j) {
    const int k = k0 + 32 * j;
    if (k < K) dst[k] = v[j];
  }
}

int launch_wide(const float* pos, const float* cdf, const float* vals,
                float* out, int C, int n, int N, int K, void* stream) {
  const int row_tiles = (n + kWarps - 1) / kWarps;
  const dim3 grid(C * row_tiles, (K + kWideCols - 1) / kWideCols);
  resample_apply_wide_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      pos, cdf, vals, out, n, N, K, row_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSharedCdf>
int launch(const float* pos, const float* cdf, const float* vals,
           float* out, int C, int n, int N, int K, void* stream) {
  const int tiles = (n + kTile - 1) / kTile;
  const size_t smem = kSharedCdf ? shared_bytes(N) : kTile * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        resample_apply_kernel<kSharedCdf>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec4 = K == 4
      && reinterpret_cast<uintptr_t>(vals) % 16 == 0
      && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  resample_apply_kernel<kSharedCdf>
      <<<C * tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          pos, cdf, vals, out, n, N, K, tiles, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest N whose CDF the kernel keeps in shared memory.
int sgmcmc_resample_apply_max_shared_n(void) {
  return static_cast<int>((kSmemLimit - kTile * sizeof(int)) / sizeof(float));
}

// Launches the resample-apply on `stream` of the calling thread's current
// device (the caller selects it), the wide launch when `wide` is nonzero,
// else the tiled one; returns cudaGetLastError().  The caller ensures
// C, n, N, K >= 1, C * ceil(n / 8) < 2^31 and, for the wide launch,
// ceil(K / 1024) <= 65535.
int sgmcmc_resample_apply(const float* pos, const float* cdf,
                          const float* vals, float* out, int C, int n,
                          int N, int K, int wide, void* stream) {
  if (wide) return launch_wide(pos, cdf, vals, out, C, n, N, K, stream);
  if (shared_bytes(N) <= kSmemLimit) {
    return launch<true>(pos, cdf, vals, out, C, n, N, K, stream);
  }
  return launch<false>(pos, cdf, vals, out, C, n, N, K, stream);
}

}  // extern "C"
