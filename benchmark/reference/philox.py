"""Philox4x32-10 and Box-Muller, frozen for the reference.

A plain PyTorch implementation of the counter-based generator that the
port's fused window uses for ``rng="kernel"``, written from the published
algorithm (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
SC 2011) and the stream layout that the port documents: the key is the
chain's 64-bit seed as the words ``(seed & 0xffffffff, seed >> 32)``;
particle ``i`` of step ``t``, noise dimension ``q`` and stream ``s`` reads
the block of counter ``(i >> 1, t, q, s)``, words ``(0, 1)`` for even
``i`` and ``(2, 3)`` for odd ``i``; two words give one normal by
``u = ((b & 0x7fffff) + 0.5) * 2^-23`` and
``z = sqrt(-2 log u1) cos(2 pi u2)`` in float32.  Stream 0 holds the
proposal normals, stream 1 the initial-state normals.

Words are int64 tensors holding 32-bit values; a 32 x 32-bit product is
split into a 32 x 16-bit pair so that no intermediate leaves int64.
"""
from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57        # multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85        # Weyl key increments
MASK = 0xFFFFFFFF
ROUNDS = 10
STREAM_PROPOSAL, STREAM_INIT = 0, 1
_TWO_PI = 2.0 * 3.14159265358979


def _mulhilo(m: int, x: torch.Tensor):
    """(high, low) 32-bit words of ``m * x``."""
    lo_part = m * (x & 0xFFFF)                 # < 2^48
    hi_part = m * (x >> 16)                    # < 2^48
    low_sum = lo_part + ((hi_part & 0xFFFF) << 16)
    return (hi_part >> 16) + (low_sum >> 32), low_sum & MASK


def philox4x32(counter, key):
    """Ten Philox rounds on four counter words and two key words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + W0) & MASK
            k1 = (k1 + W1) & MASK
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def normals(seeds: torch.Tensor, t: int, q: int, n: int,
            stream: int) -> torch.Tensor:
    """Standard normals ``[C, n]`` float32 of particles ``0..n-1`` at step
    ``t``, noise dimension ``q`` and ``stream`` for the int64 ``seeds [C]``."""
    dev = seeds.device
    k0 = (seeds & MASK)[:, None]
    k1 = ((seeds >> 32) & MASK)[:, None]
    blocks = (n + 1) // 2
    i = torch.arange(blocks, dtype=torch.int64, device=dev)[None, :]
    full = torch.full((), 0, dtype=torch.int64, device=dev)
    w0, w1, w2, w3 = philox4x32((i, full + t, full + q, full + stream),
                                (k0, k1))
    # even particles read words (0, 1), odd ones (2, 3)
    b1 = torch.stack(torch.broadcast_tensors(w0, w2), -1).reshape(
        seeds.shape[0], 2 * blocks)[:, :n]
    b2 = torch.stack(torch.broadcast_tensors(w1, w3), -1).reshape(
        seeds.shape[0], 2 * blocks)[:, :n]
    u1 = ((b1 & 0x7FFFFF).to(torch.float32) + 0.5) * 2.0 ** -23
    u2 = ((b2 & 0x7FFFFF).to(torch.float32) + 0.5) * 2.0 ** -23
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)
