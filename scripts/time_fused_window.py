#!/usr/bin/env python3
"""Time the fused-window kernel (K1: SVM body, host normals, no gate) at
the benchmark shape, for the port's package found under ``--root``.

    python3 scripts/time_fused_window.py [--root DIR]

Made to compare two trees of the repository on one card: unpack the other
tree into a git-ignored directory and run this script from the checkout
with ``--root`` pointing at each tree in turn (A, B, B, A).  The inputs
(C=8192 chains, N=1024 particles, W=60 steps) are made with plain torch
from a fixed seed, so both trees see the same data.  Seven rounds of 20
calls are timed by CUDA events.  Prints one line: the root, the card's
``nvidia-smi`` name and power limit, the median of the rounds' times (ms
per call) and each round's time.
"""
import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import torch

C, N, W = 8192, 1024, 60
REPS, ROUNDS = 20, 7


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_fused_window: no CUDA device is available")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from sgmcmc_tpu_torch.models import svm
    from sgmcmc_tpu_torch.ops.cuda import fused_pf
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.rand((C, 3), generator=gen, device=dev)
    pvec = torch.stack([0.5 + 0.45 * u[:, 0], (0.3 + 1.2 * u[:, 1]) ** -0.5,
                        (0.5 + 1.5 * u[:, 2]) ** -0.5], -1).contiguous()
    x0 = torch.randn((C, 1, N), generator=gen, device=dev)
    normals = torch.randn((C, W, 1, N), generator=gen, device=dev)
    ys = (torch.exp(0.5 * torch.randn((C, W), generator=gen, device=dev))
          * torch.randn((C, W), generator=gen, device=dev))
    weights = 1.0 + 2.0 * torch.rand((C, W), generator=gen, device=dev)
    weights[:, :10] = 0.0
    weights[:, 50:] = 0.0
    xi = torch.rand((C, W), generator=gen, device=dev)
    inputs = (pvec, x0, normals, ys, weights, xi)

    def call():
        return fused_pf.fused_window(svm.FUSED, *inputs)
    out = call()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite K1 output")
    rounds = []
    for _ in range(ROUNDS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(REPS):
            call()
        end.record()
        torch.cuda.synchronize()
        rounds.append(start.elapsed_time(end) / REPS)
    print(f"root {args.root}: K1 svm host normals C={C} N={N} W={W}: "
          f"median {statistics.median(rounds):.4f} ms, rounds "
          f"{' '.join(f'{r:.4f}' for r in rounds)} ({card})", flush=True)


if __name__ == "__main__":
    main()
