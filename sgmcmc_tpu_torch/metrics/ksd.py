"""Kernel Stein discrepancy with the IMQ kernel, as blocked matmuls.

Counterpart of ``sgmcmc_tpu/metrics/ksd.py`` in plain PyTorch, on the card
unless the caller passes ``device="cpu"`` (the JAX package computes it
outside any Pallas kernel, on its default device):

KSD^2 = (1/M^2) sum_{i,j} [ k(xi,xj) gi.gj
                            + gi . grad_xj k + gj . grad_xi k
                            + trace_d(grad_xi grad_xj k) ]
with k(x,y) = (c^2 + ||x-y||^2)^(-beta), where g are score values
(grad log posterior) at the samples.  The pairs are summed over
``[Mi, Mj]`` blocks of at most ``max_block_size`` rows, the samples
padded to a whole number of blocks and the padding masked, as in the JAX
package.
"""
from __future__ import annotations

import torch


def _stein_block(xi, gi, mi, xj, gj, mj, c2, beta):
    """Masked sum of Stein-kernel terms over one [Mi, Mj] block."""
    d = xi.shape[-1]
    diff = xi[:, None, :] - xj[None, :, :]          # [Mi, Mj, d]
    r2 = (diff * diff).sum(-1)
    base = c2 + r2
    k = base ** (-beta)
    kp = -beta * base ** (-beta - 1.0)              # dk/d(r2)
    kpp = beta * (beta + 1.0) * base ** (-beta - 2.0)
    gg = torch.matmul(gi, gj.mT)                    # [Mi, Mj]
    # grad_{xj} k = -2 kp diff,  grad_{xi} k = 2 kp diff
    t2 = -2.0 * kp * torch.einsum("id,ijd->ij", gi, diff)
    t3 = 2.0 * kp * torch.einsum("jd,ijd->ij", gj, diff)
    t4 = -2.0 * d * kp - 4.0 * kpp * r2
    w = mi[:, None] * mj[None, :]
    return (w * (k * gg + t2 + t3 + t4)).sum()


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} needs a CUDA card but no "
                           "CUDA device is available; pass device='cpu' to "
                           "run on the CPU")
    return device


def imq_ksd(x, grads, c: float = 1.0, beta: float = 0.5,
            max_block_size: int = 512, device="cuda",
            dtype=torch.float64) -> torch.Tensor:
    """IMQ KSD of samples x [M, d] with score values grads [M, d] (arrays
    or tensors), computed in ``dtype`` on ``device`` (the card unless
    ``device="cpu"``).  Returns a 0-d tensor."""
    device = _device(device)
    x = torch.as_tensor(x, dtype=dtype, device=device)
    grads = torch.as_tensor(grads, dtype=dtype, device=device)
    M, d = x.shape
    c2 = c * c
    n_blocks = max(1, -(-M // max_block_size))
    B = -(-M // n_blocks)
    pad = n_blocks * B - M
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(n_blocks, B, d)
    gp = torch.nn.functional.pad(grads, (0, 0, 0, pad)).reshape(n_blocks, B,
                                                                  d)
    mp = torch.nn.functional.pad(torch.ones((M,), dtype=dtype,
                                            device=device),
                                 (0, pad)).reshape(n_blocks, B)
    total = torch.zeros((), dtype=dtype, device=device)
    for i in range(n_blocks):
        for j in range(n_blocks):
            total = total + _stein_block(xp[i], gp[i], mp[i], xp[j], gp[j],
                                         mp[j], c2, beta)
    return torch.sqrt(total) / M


def _stack(trace, var, device, dtype):
    """The field ``var`` of each entry, flattened and stacked into [M, d]
    on ``device`` (tensors are stacked where they lie, then moved)."""
    return torch.stack([torch.as_tensor(getattr(p, var)).reshape(-1)
                        for p in trace]).to(device=device, dtype=dtype)


def compute_ksd(param_list, grad_list, variables: list[str], c: float = 1.0,
                beta: float = 0.5, max_block_size: int = 512,
                device="cuda", dtype=torch.float64):
    """Per-variable KSD over a parameter trace, on the card unless
    ``device="cpu"``: ``param_list`` / ``grad_list`` are lists of
    parameters and score values (dataclasses with the fields
    ``variables``, tensors or arrays, each flattened); returns {variable:
    float}."""
    device = _device(device)
    out = {}
    for var in variables:
        x = _stack(param_list, var, device, dtype)
        g = _stack(grad_list, var, device, dtype)
        out[var] = float(imq_ksd(x, g, c, beta, max_block_size, device,
                                 dtype))
    return out
