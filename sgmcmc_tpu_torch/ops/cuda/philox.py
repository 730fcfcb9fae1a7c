"""Counter-based standard normals: Philox4x32-10 with Box-Muller.

Counterpart of the JAX package's in-kernel generator (``_box_muller`` in
``sgmcmc_tpu/ops/pallas/fused_pf.py``, used by its fused window for
``rng="kernel"``) and of the TPU kernel that probes it
(``_kernel`` / ``draw`` in ``scripts/tpu_probe_kernel_rng.py``).  A TPU's
hardware bits cannot be reproduced on the card; the port's generator is a
hand-written Philox4x32-10 (``csrc/philox.cuh``) with the same transform
of two 32-bit words to one normal:
``u = ((b & 0x7fffff) + 0.5) * 2^-23``, ``z = sqrt(-2 log u1) cos(2 pi u2)``.

Layout (the same in the CUDA source and in the plain version here): the
key is the chain's 64-bit seed as two words ``(seed & 0xffffffff,
seed >> 32)``; particle ``i`` of step ``t``, noise dimension ``q`` and
stream ``s`` reads the Philox block of counter ``(i >> 1, t, q, s)``,
words ``(0, 1)`` for even ``i`` and ``(2, 3)`` for odd ``i``.  The stream
depends on nothing else, so any sub-block drawn alone equals the same
slice of a larger draw.  Stream 0 holds the fused window's proposal
normals, stream 1 the initial-state normals.

``philox_normals`` / ``philox_words`` launch the standalone kernel of
``csrc/philox_normals.cu`` for CUDA tensors and run the plain versions for
CPU tensors.  The plain versions compute in int64 with every word masked
to 32 bits; a 32 x 32-bit product is split into 16-bit halves so that no
intermediate leaves int64.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import check_launch, load_library

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF
ROUNDS = 10
STREAM_PROPOSAL, STREAM_INIT = 0, 1
_LOW23, _SCALE = 0x7FFFFF, 2.0 ** -23
_TWO_PI = 2.0 * 3.14159265358979      # the JAX package's float literal


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of ``m * x`` for a 32-bit constant ``m`` and
    int64 ``x`` holding 32-bit words; partial products of 16-bit halves
    stay below 2^34."""
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    ll = ml * xl
    mid = ml * xh + mh * xl + (ll >> 16)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = mh * xh + (mid >> 16)
    return hi, lo


def philox4x32_reference(counter, key):
    """Philox4x32-10 on int64 tensors holding 32-bit words: ``counter`` a
    sequence of four broadcastable tensors, ``key`` of two; returns the four
    output words."""
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


def seed_words(seeds: torch.Tensor):
    """The Philox key words (low, high) of int64 seeds."""
    return seeds & MASK, (seeds >> 32) & MASK


def philox_words_reference(seeds: torch.Tensor, W: int, Z: int, N: int,
                           stream: int = STREAM_PROPOSAL,
                           t0: int = 0) -> torch.Tensor:
    """Raw words ``[C, W, Z, N, 2]`` (int64 holding uint32): ``(b1, b2)`` of
    every particle of steps ``t0 .. t0+W-1``."""
    dev = seeds.device
    k0, k1 = (k[:, None, None, None] for k in seed_words(seeds))
    P = (N + 1) // 2

    def ar(n, start=0):
        return torch.arange(start, start + n, dtype=torch.int64, device=dev)
    counter = (ar(P)[None, None, None, :], ar(W, t0)[None, :, None, None],
               ar(Z)[None, None, :, None],
               torch.full((), stream, dtype=torch.int64, device=dev))
    w0, w1, w2, w3 = philox4x32_reference(counter, (k0, k1))
    b1 = torch.stack(torch.broadcast_tensors(w0, w2), -1)
    b2 = torch.stack(torch.broadcast_tensors(w1, w3), -1)
    shape = b1.shape[:-2] + (2 * P,)
    return torch.stack([b1.reshape(shape)[..., :N],
                        b2.reshape(shape)[..., :N]], -1)


def box_muller_reference(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Normals from two int64 word tensors, in float32, in the order of
    operations of ``_box_muller`` and of ``csrc/philox.cuh``."""
    u1 = ((b1 & _LOW23).to(torch.float32) + 0.5) * _SCALE
    u2 = ((b2 & _LOW23).to(torch.float32) + 0.5) * _SCALE
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def philox_normals_reference(seeds: torch.Tensor, W: int, Z: int, N: int,
                             stream: int = STREAM_PROPOSAL,
                             t0: int = 0) -> torch.Tensor:
    """Plain version of the kernel: normals ``[C, W, Z, N]`` float32."""
    words = philox_words_reference(seeds, W, Z, N, stream, t0)
    return box_muller_reference(words[..., 0], words[..., 1])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library with the Philox entry points bound."""
    lib = load_library()
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.sgmcmc_philox_normals, lib.sgmcmc_philox_words):
        fn.argtypes = [P, P, I, I, I, I, I, I, P]
        fn.restype = I
    return lib


def _launch(entry: str, seeds, W, Z, N, stream, t0, dtype, tail):
    if seeds.dim() != 1 or seeds.dtype != torch.int64:
        raise ValueError(f"seeds must be a 1-D int64 tensor, got "
                         f"{tuple(seeds.shape)} {seeds.dtype}")
    if not seeds.is_contiguous():
        raise ValueError("seeds must be contiguous")
    if min(W, Z, N) < 1 or t0 < 0 or stream < 0:
        raise ValueError(f"need W, Z, N >= 1 and t0, stream >= 0; got "
                         f"W={W} Z={Z} N={N} t0={t0} stream={stream}")
    if seeds.device.type != "cuda":
        raise ValueError(f"no Philox kernel for device {seeds.device}")
    C = seeds.shape[0]
    out = torch.empty((C, W, Z, N) + tail, dtype=dtype, device=seeds.device)
    # the library's runtime launches on the thread's current device
    with torch.cuda.device(seeds.device):
        rc = getattr(_library(), entry)(
            seeds.data_ptr(), out.data_ptr(), C, W, Z, N, t0, stream,
            torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "Philox generator")
    return out


def philox_normals(seeds: torch.Tensor, W: int, Z: int, N: int,
                   stream: int = STREAM_PROPOSAL,
                   t0: int = 0) -> torch.Tensor:
    """Standard normals ``[C, W, Z, N]`` float32 of the chains' ``seeds``
    (``[C]`` int64) for steps ``t0 .. t0+W-1`` of ``stream``.  CUDA tensors
    launch the kernel on the current stream and count one in
    ``philox_normals.launches``; CPU tensors run
    :func:`philox_normals_reference`."""
    if seeds.device.type == "cpu":
        return philox_normals_reference(seeds, W, Z, N, stream, t0)
    out = _launch("sgmcmc_philox_normals", seeds, W, Z, N, stream, t0,
                  torch.float32, ())
    philox_normals.launches += 1
    return out


philox_normals.launches = 0


def philox_words(seeds: torch.Tensor, W: int, Z: int, N: int,
                 stream: int = STREAM_PROPOSAL, t0: int = 0) -> torch.Tensor:
    """The raw words ``[C, W, Z, N, 2]`` behind :func:`philox_normals`:
    int32 holding the uint32 bits on CUDA (one launch of the same kernel),
    int64 from :func:`philox_words_reference` on CPU tensors."""
    if seeds.device.type == "cpu":
        return philox_words_reference(seeds, W, Z, N, stream, t0)
    return _launch("sgmcmc_philox_words", seeds, W, Z, N, stream, t0,
                   torch.int32, (2,))
