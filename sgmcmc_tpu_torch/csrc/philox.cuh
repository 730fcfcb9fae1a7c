// Counter-based standard normals: Philox4x32-10 and the Box-Muller transform
// of the JAX package's in-kernel generator.
//
// Replaces the TPU's hardware generator (pltpu.prng_seed /
// prng_random_bits), which the JAX package's fused window uses for
// rng="kernel" (_box_muller in sgmcmc_tpu/ops/pallas/fused_pf.py) and which
// the TPU kernel _kernel / draw of scripts/tpu_probe_kernel_rng.py probes.
// A TPU's bits cannot be reproduced here; the transform of bits to normals
// is the same: u = ((b & 0x7fffff) + 0.5) * 2^-23 for two words b1, b2, and
// z = sqrt(-2 log u1) * cos(2 pi u2), in float32.
//
// Layout.  The stream is a pure function of the chain's key and of
// (step t, noise dimension q, particle i, stream s), independent of grid,
// block and thread layout:
//   key     = (seed & 0xffffffff, seed >> 32) of the chain's 64-bit seed;
//   counter = (i >> 1, t, q, s);
//   words (0, 1) of the Philox output feed particle 2k = i & ~1, words
//   (2, 3) feed particle 2k + 1, as (b1, b2) of the transform.
// Stream 0 holds the fused window's proposal normals (t = window step),
// stream 1 the initial-state normals (t = 0).  The plain PyTorch version,
// sgmcmc_tpu_torch/ops/cuda/philox.py, follows the same layout.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The four words for particles (2k, 2k + 1) of (t, q) in stream s.
__device__ __forceinline__ uint4 philox_pair(uint32_t k0, uint32_t k1, int k,
                                             int t, int q, int s) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(k),
                                  static_cast<uint32_t>(t),
                                  static_cast<uint32_t>(q),
                                  static_cast<uint32_t>(s)),
                       k0, k1);
}

__device__ __forceinline__ float box_muller(uint32_t b1, uint32_t b2) {
  const float u1 = (static_cast<float>(b1 & 0x7fffffu) + 0.5f)
                   * 1.1920928955078125e-07f;   // 2^-23
  const float u2 = (static_cast<float>(b2 & 0x7fffffu) + 0.5f)
                   * 1.1920928955078125e-07f;
  return sqrtf(-2.0f * logf(u1)) * cosf(6.28318530717958f * u2);
}
