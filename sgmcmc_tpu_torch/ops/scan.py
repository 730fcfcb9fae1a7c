"""An inclusive associative scan over one axis of a tuple of tensors.

PyTorch has no public counterpart of ``jax.lax.associative_scan``; this is
the Hillis-Steele scan: round r combines every element with the one
``2^r`` places before it, so ceil(log2 T) rounds of batched operations on
whole ``[..., T, ...]`` tensors give every prefix.  It does more combines
than JAX's work-efficient tree (about T log2 T against 2T) in fewer
rounds; the two trees differ only in rounding.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor], dim: int,
                     reverse: bool = False) -> tuple:
    """Every inclusive prefix ``e_0 . e_1 . ... . e_t`` of the elements
    ``elems`` (a tuple of tensors sharing their size along ``dim``, counted
    from the left and the same axis in each) under the associative
    ``fn(a, b)``, with ``a`` the earlier operand.  ``reverse=True`` scans
    from the end, as JAX's does: the suffixes, with ``a`` the later
    operand (the already-combined suffix) and ``b`` the earlier element."""
    elems = tuple(elems)
    if reverse:
        elems = tuple(torch.flip(x, (dim,)) for x in elems)
    T = elems[0].shape[dim]
    d = 1
    while d < T:
        earlier = tuple(x.narrow(dim, 0, T - d) for x in elems)
        later = tuple(x.narrow(dim, d, T - d) for x in elems)
        comb = fn(earlier, later)
        elems = tuple(torch.cat([x.narrow(dim, 0, d), c], dim)
                      for x, c in zip(elems, comb))
        d *= 2
    if reverse:
        elems = tuple(torch.flip(x, (dim,)) for x in elems)
    return elems
