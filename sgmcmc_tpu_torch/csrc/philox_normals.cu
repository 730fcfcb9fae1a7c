// Standalone Philox normal generator for Hopper (sm_90a).
//
// Replaces the TPU kernel _kernel (launched by draw) of
// scripts/tpu_probe_kernel_rng.py, the probe of the in-kernel generator
// that the JAX package's fused window uses for rng="kernel".  It writes the
// normals of csrc/philox.cuh for every (chain c, step t, noise dimension q,
// particle i) of a [C, W, Z, N] block, the layout in which the fused window
// consumes them, or the raw words (b1, b2) of every particle as
// [C, W, Z, N, 2] int32.  The port draws the initial-state normals of the
// in-kernel-generator path with it (stream 1), and the checks on the card
// hold it against its plain PyTorch version.
//
// What bounds it on the card: its output bytes (4 per normal), with about
// as many integer and float operations per byte as the card can issue.
// One Philox4x32-10 call (10 rounds of 2 mul.hi, 2 mul.lo and 4 xor, 9
// key bumps of 2 adds: 98 integer operations) gives the words of a pair
// of particles (2k, 2k+1), and two Box-Muller transforms (mask, convert,
// add, scale twice, then -2x, log, sqrt, 2 pi x, cos and the product: 14
// each, log and cos counted as one) their normals.  The index math is in
// 32 bits and outside the per-pair work: a block's row (c, t) comes from
// blockIdx.x (one 32-bit division by W), its noise dimension q from
// blockIdx.z and its pairs from blockIdx.y, and each thread computes
// kPairs adjacent pairs and writes them with 16-byte stores where the row
// is aligned.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 2;   // pairs of particles per thread

template <bool kWords>
__global__ void __launch_bounds__(kThreads)
philox_kernel(const long long* __restrict__ seeds, int W, int Z, int N,
              int t0, int s, void* __restrict__ out) {
  const unsigned r = blockIdx.x;                // c * W + t
  const unsigned c = r / static_cast<unsigned>(W);
  const int t = static_cast<int>(r - c * static_cast<unsigned>(W));
  const int q = blockIdx.z;
  const int P = (N + 1) >> 1;
  const int k0 = (blockIdx.y * kThreads + threadIdx.x) * kPairs;
  if (k0 >= P) return;
  const unsigned long long seed = static_cast<unsigned long long>(seeds[c]);
  const uint32_t key0 = static_cast<uint32_t>(seed);
  const uint32_t key1 = static_cast<uint32_t>(seed >> 32);
  const size_t base = (static_cast<size_t>(r) * Z + q) * N;  // row start
  uint4 w[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j)
    if (k0 + j < P) w[j] = philox_pair(key0, key1, k0 + j, t0 + t, q, s);
  const int i = 2 * k0;                         // first particle
  // all kPairs pairs inside the row, at a 16-byte aligned address
  const bool vec = i + 2 * kPairs <= N
      && ((base + i) * (kWords ? 2 : 1)) % 4 == 0
      && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (kWords) {
    int* o = static_cast<int*>(out) + 2 * (base + i);
    if (vec) {
#pragma unroll
      for (int j = 0; j < kPairs; ++j)
        reinterpret_cast<int4*>(o)[j] = make_int4(
            static_cast<int>(w[j].x), static_cast<int>(w[j].y),
            static_cast<int>(w[j].z), static_cast<int>(w[j].w));
    } else {
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const int ia = i + 2 * j;
        if (ia >= N) break;
        o[4 * j] = static_cast<int>(w[j].x);
        o[4 * j + 1] = static_cast<int>(w[j].y);
        if (ia + 1 < N) {
          o[4 * j + 2] = static_cast<int>(w[j].z);
          o[4 * j + 3] = static_cast<int>(w[j].w);
        }
      }
    }
  } else {
    float* o = static_cast<float*>(out) + base + i;
    float z[2 * kPairs];
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      z[2 * j] = box_muller(w[j].x, w[j].y);
      z[2 * j + 1] = box_muller(w[j].z, w[j].w);
    }
    if (vec) {
      static_assert(kPairs == 2, "one float4 store per thread");
      *reinterpret_cast<float4*>(o) = make_float4(z[0], z[1], z[2], z[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 2 * kPairs; ++j)
        if (i + j < N) o[j] = z[j];
    }
  }
}

template <bool kWords>
int launch(const long long* seeds, void* out, int C, int W, int Z, int N,
           int t0, int s, void* stream) {
  const long long rows = static_cast<long long>(C) * W;
  const int P = (N + 1) / 2;
  const int tiles = (P + kThreads * kPairs - 1) / (kThreads * kPairs);
  if (rows == 0) return 0;
  if (rows > 0x7fffffffLL || tiles > 65535 || Z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows), tiles, Z);
  philox_kernel<kWords><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      seeds, W, Z, N, t0, s, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// normals [C, W, Z, N] float32 for steps t0 .. t0+W-1 of stream s; returns
// cudaGetLastError() (the caller selects the device).
int sgmcmc_philox_normals(const long long* seeds, float* out, int C, int W,
                          int Z, int N, int t0, int s, void* stream) {
  return launch<false>(seeds, out, C, W, Z, N, t0, s, stream);
}

// raw words [C, W, Z, N, 2] int32: (b1, b2) of every particle.
int sgmcmc_philox_words(const long long* seeds, int* out, int C, int W,
                        int Z, int N, int t0, int s, void* stream) {
  return launch<true>(seeds, out, C, W, Z, N, t0, s, stream);
}

}  // extern "C"
