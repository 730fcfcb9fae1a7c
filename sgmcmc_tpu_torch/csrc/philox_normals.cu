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
// What bounds it on the card: operations.  One thread computes one pair of
// particles (2k, 2k+1): one Philox4x32-10 call (10 rounds of 2 mul.hi,
// 2 mul.lo and 4 xor, 9 key bumps of 2 adds: 98 integer operations) and two
// Box-Muller transforms (mask, convert, add, scale twice, then -2x, log,
// sqrt, 2 pi x, cos and the product: 14 each, log and cos counted as one).
// It writes 4 bytes per normal, coalesced as one 8-byte store per thread.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kWords>
__global__ void __launch_bounds__(kThreads)
philox_kernel(const long long* __restrict__ seeds, int W, int Z, int N,
              int t0, int s, long long n_pairs, void* __restrict__ out) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (g >= n_pairs) return;
  const int P = (N + 1) >> 1;
  const int k = static_cast<int>(g % P);
  const long long row = g / P;                  // (c * W + t) * Z + q
  const int q = static_cast<int>(row % Z);
  const int t = static_cast<int>((row / Z) % W);
  const long long c = row / (static_cast<long long>(Z) * W);
  const unsigned long long seed = static_cast<unsigned long long>(seeds[c]);
  const uint4 r = philox_pair(static_cast<uint32_t>(seed),
                              static_cast<uint32_t>(seed >> 32), k, t0 + t,
                              q, s);
  const long long i = row * N + 2 * k;          // flat index of particle 2k
  const bool two = 2 * k + 1 < N;
  const bool vec = two && (N % 2 == 0);         // i even: aligned stores
  if (kWords) {
    int* o = static_cast<int*>(out) + 2 * i;
    if (vec) {
      *reinterpret_cast<int4*>(o) = make_int4(
          static_cast<int>(r.x), static_cast<int>(r.y),
          static_cast<int>(r.z), static_cast<int>(r.w));
    } else {
      o[0] = static_cast<int>(r.x);
      o[1] = static_cast<int>(r.y);
      if (two) {
        o[2] = static_cast<int>(r.z);
        o[3] = static_cast<int>(r.w);
      }
    }
  } else {
    float* o = static_cast<float*>(out) + i;
    const float z0 = box_muller(r.x, r.y);
    if (vec) {
      *reinterpret_cast<float2*>(o) = make_float2(z0, box_muller(r.z, r.w));
    } else {
      o[0] = z0;
      if (two) o[1] = box_muller(r.z, r.w);
    }
  }
}

template <bool kWords>
int launch(const long long* seeds, void* out, int C, int W, int Z, int N,
           int t0, int s, void* stream) {
  const long long n_pairs = static_cast<long long>(C) * W * Z
                            * ((N + 1) / 2);
  const long long blocks = (n_pairs + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  philox_kernel<kWords><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      seeds, W, Z, N, t0, s, n_pairs, out);
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
