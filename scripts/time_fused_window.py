#!/usr/bin/env python3
"""Time variants of the fused-window kernel (K1), the standalone Philox
generator (K4) and the resample-apply kernel for the port's package found
under ``--root``.

    python3 scripts/time_fused_window.py [--root DIR] [--variant NAME ...]
        [--out FILE]

A K1 variant is a model body, the normals' route (``host`` or in-kernel
``rng``), the ESS gate, the valid gate, the window length W and the number
of rows C.  The named variants are the rows of PERF.md's kernel table, each
at its own shape (``--list`` prints them); a variant may also be spelled
out as ``body[,rng][,ess=0.5][,ld][,W=60][,C=8192]`` (``ld``: the Seq LD
fit's valid-gate shape, below).  ``philox`` is K4 at
the initial-state draw of the headline path (8192 chains x 1024 normals).
A resample-apply variant is ``ra,C=..,N=..,K=..`` (C chains of N
particles, rows of K floats, multinomial positions on random weights):
the ``ra_predict_*`` rows are the predict surface's wide rows (the shapes
of ``chip_smoke.PREDICT_SHAPES``), the others the default and PaRIS paths'
(K = 4, 6, 1).  Besides the CUDA-event time over a loop of host calls, a
resample-apply line carries the device time per call in a CUDA graph
(``graph_ms``, no host launch cost) and both times of ``torch.searchsorted``
+ ``torch.gather`` (``gather_ms``, ``gather_graph_ms``).  Rows of K >= 64
take ``chip_smoke.wide_row_inputs`` (log-weights of spread 0.5, copies of
vals used in turn, the bound over the ancestors' rows only) and also time
both launches (``tiled_graph_ms``, ``wide_graph_ms``; ``wide`` is the one
``resample_apply`` takes): spell out ``ra,C=256,N=1000,K=91`` and the like
to find where they cross over.

Shapes.  W=60 rows: C=8192 chains, N=1024, the buffered window of S=40,
B=10 (zero weights on the 10-step buffers).  ``*_seq`` rows: the Seq SGLD
window, 8192 rows, W=24 (S=16, B=4).  ``ld``: the Seq LD fit, 1024 chains x
8 sequences = 8192 rows of ``chip_smoke.py``'s ``SEQ_LENGTHS`` (the
LD fit's: W = 941, 68% of row-steps valid), the valid gate on (row r runs
the steps t < length of sequence r % 8).  ``chip_smoke.py`` holds every
variant against its plain version; this script only times.

Made to compare two trees of the repository on one card: unpack the other
tree into a git-ignored directory and run this script once per tree, in
turns (A, B, B, A), each run with ``--root`` at its tree.  Every input is
made with plain torch from a fixed seed, so both trees see the same data.
Each variant is timed by CUDA events over rounds of calls after a warm-up;
one JSON line per variant gives the root, the card's ``nvidia-smi`` name and
power limit, the median ms per call, every round's time, and the least time
the card could take for the variant's work (``bound_ms``: bytes over the
memory rate or operations over the float32 rate, whichever is larger,
counted by ``chip_smoke.py``'s ``bound_ms`` and ``k1_ops`` on this
variant's inputs).  ``--out`` appends the lines to a file too.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

N = 1024
PRESETS = {
    "svm_host": "svm",
    "svm_rng": "svm,rng",
    "svm_ess": "svm,ess=0.5",
    "lgssm_optimal_rng": "lgssm_optimal,rng",
    "lgssm_prior_rng": "lgssm_prior,rng",
    "garch_optimal_host": "garch_optimal",
    "garch_optimal_rng": "garch_optimal,rng",
    "garch_prior_host": "garch_prior",
    "garch_prior_rng": "garch_prior,rng",
    "svjm_host": "svjm",
    "svjm_rng": "svjm,rng",
    "svm_rng_seq": "svm,rng,W=24",
    "garch_optimal_rng_seq": "garch_optimal,rng,W=24",
    "svjm_rng_seq": "svjm,rng,W=24",
    "svm_valid_rng_ld": "svm,rng,ld",
    "philox": "philox",
    "ra_predict_svm": "ra,C=1,N=1000,K=3001",
    "ra_predict_svm_n10000": "ra,C=1,N=10000,K=3001",
    "ra_predict_seq": "ra,C=8,N=1000,K=2824",
    "ra_predict_garch_y": "ra,C=1,N=1000,K=2002",
    "ra_k2b": "ra,C=8192,N=1024,K=4",
    "ra_k6": "ra,C=8192,N=1024,K=6",
    "ra_paris_100": "ra,C=8192,N=100,K=1",
    "ra_paris_ld": "ra,C=64,N=1000,K=1",
}


def parse(spec):
    """A variant spec as a dict (see the module docstring)."""
    spec = PRESETS.get(spec, spec)
    parts = spec.split(",")
    v = dict(body=parts[0], rng=False, ess=None, ld=False, W=60, C=8192,
             N=N, K=1)
    for p in parts[1:]:
        key, _, val = p.partition("=")
        if key in ("rng", "ld"):
            v[key] = True
        elif key == "ess":
            v[key] = float(val)
        elif key in ("W", "C", "N", "K"):
            v[key] = int(val)
        else:
            raise SystemExit(f"time_fused_window: unknown option {p!r}")
    return v


def k1_inputs(v, models, dev, seq_lengths):
    """(model, pvec, x0, normals, ys, weights, xi, seeds, vs) of a variant,
    from a fixed seed."""
    body, C = v["body"], v["C"]
    gen = torch.Generator(device=dev).manual_seed(0)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def z(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    mod = models[body.split("_")[0]]
    model = mod.FUSED_PRIOR if body.endswith("prior") else mod.FUSED
    a, lq, lr = 0.5 + 0.45 * u(C), (0.3 + 1.2 * u(C)) ** -0.5, \
        (0.5 + 1.5 * u(C)) ** -0.5
    if body == "svm":
        cols, sd = [a, lq, lr], 1.0 / (lq * torch.sqrt(1.0 - a * a))
    elif body.startswith("lgssm"):
        cols, sd = [a, torch.ones_like(a), lq, lr], \
            torch.full_like(a, 10.0 ** 0.5)
    elif body.startswith("garch"):
        mu, phi, lam = 0.2 + 0.8 * u(C), 0.5 + 0.4 * u(C), 0.1 + 0.4 * u(C)
        cols, sd = [mu, phi, lam, lr], torch.sqrt(mu)
    else:                                       # svjm
        pj = 0.02 + 0.28 * u(C)
        lqj = (0.5 + 2.0 * u(C)) ** -0.5
        cols = [a, lq, lr, lqj, torch.logit(pj), torch.special.ndtri(pj)]
        sd = 1.0 / (lq * torch.sqrt(1.0 - a * a))
    pvec = torch.stack(cols, -1).contiguous()
    D, Z = model.n_state, model.noise_dims
    x0 = torch.zeros((C, D, N), device=dev)
    x0[:, 0] = sd[:, None] * z(C, N)
    W = v["W"]
    vs = None
    if v["ld"]:
        lengths = torch.tensor(seq_lengths, device=dev)
        W = int(lengths.max())
        row_len = lengths[torch.arange(C, device=dev) % len(lengths)]
        vs = (torch.arange(W, device=dev)[None] < row_len[:, None]).float()
        weights = vs.clone()
    else:
        B = 10 if W == 60 else 4
        weights = 1.0 + 2.0 * u(C, W)
        weights[:, :B] = 0.0
        weights[:, W - B:] = 0.0
    ys = torch.exp(0.5 * z(C, W)) * z(C, W)
    if vs is not None:
        ys = ys * vs
    xi = u(C, W)
    normals = seeds = None
    if v["rng"]:
        seeds = torch.randint(-2 ** 63, 2 ** 63 - 1, (C,), generator=gen,
                              dtype=torch.int64, device=dev)
    else:
        normals = z(C, W, Z, N)
    return (model, pvec, x0, normals, ys.contiguous(), weights.contiguous(),
            xi, seeds, vs)


def time_call(call, reps, rounds):
    call()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            call()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--variant", action="append",
                    help="a name of --list or a spec; default: every name")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.list:
        for name, spec in PRESETS.items():
            print(f"{name}: {spec}")
        return
    if not torch.cuda.is_available():
        sys.exit("time_fused_window: no CUDA device is available")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from sgmcmc_tpu_torch.models import garch, lgssm, svjm, svm
    from sgmcmc_tpu_torch.ops.cuda import fused_pf, philox, resample
    models = dict(svm=svm, lgssm=lgssm, garch=garch, svjm=svjm)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    for name in args.variant or list(PRESETS):
        v = parse(name)
        extra = {}
        if v["body"] == "ra":
            C, n, K = v["C"], v["N"], v["K"]
            gen = torch.Generator(device=dev).manual_seed(0)
            if K >= 64:
                pos, cdf, sets, nbytes = chip_smoke.wide_row_inputs(
                    gen, C, n, K, dev)
            else:
                cdf = resample.weights_cdf(
                    2.0 * torch.randn((C, n), generator=gen, device=dev))
                pos = torch.rand((C, n), generator=gen, device=dev)
                sets = [torch.randn((C, n, K), generator=gen, device=dev)]
                nbytes = 4 * (pos.numel() + cdf.numel()
                              + 2 * sets[0].numel())

            def over_sets(fn):
                return lambda: [fn(pos, cdf, vals) for vals in sets]

            def graph(fn):
                return (chip_smoke.graph_ms(over_sets(fn), reps=reps)
                        / len(sets))

            call = over_sets(resample.resample_apply)
            reps = max(10, min(200, int(2e8 / (8 * C * n * K * len(sets)))))
            rounds = [t / len(sets) for t in time_call(call, reps,
                                                       args.rounds)]
            gather = resample.resample_apply_reference
            extra = dict(
                graph_ms=graph(resample.resample_apply),
                gather_ms=statistics.median(time_call(
                    over_sets(gather), reps, args.rounds)) / len(sets),
                gather_graph_ms=graph(gather), copies=len(sets))
            # both launches (a tree from before the launch choice moved
            # to ops/cuda/resample.py times the one it takes)
            if K >= 64 and hasattr(resample, "_launch"):
                # both launches against the plain version before timing
                ref = gather(pos, cdf, sets[0])
                for wide in (False, True):
                    got = resample._launch(pos, cdf, sets[0], wide=wide)
                    if not torch.equal(got, ref):
                        raise AssertionError(
                            f"{name}: the {'wide' if wide else 'tiled'} "
                            "launch differs from its plain version")
                extra.update(
                    wide=resample.wide_launch(C, n, K, dev),
                    tiled_graph_ms=graph(lambda *a: resample._launch(
                        *a, wide=False)),
                    wide_graph_ms=graph(lambda *a: resample._launch(
                        *a, wide=True)))
            shape = f"C={C} N={n} K={K}"
            bound = chip_smoke.bound_ms(nbytes, C * n * (n.bit_length() + 1))
        elif v["body"] == "philox":
            seeds = torch.randint(
                -2 ** 63, 2 ** 63 - 1, (v["C"],), dtype=torch.int64,
                generator=torch.Generator(device=dev).manual_seed(0),
                device=dev)

            def call():
                return philox.philox_normals(seeds, 1, 1, N,
                                             stream=philox.STREAM_INIT)
            rounds = time_call(call, 200, args.rounds)
            shape = f"C={v['C']} W=1 Z=1 N={N}"
            bound = chip_smoke.bound_ms(
                8 * v["C"] + 4 * v["C"] * N,
                v["C"] * N // 2 * chip_smoke.PHILOX_PAIR_OPS)
        else:
            model, pvec, x0, normals, ys, weights, xi, seeds, vs = \
                k1_inputs(v, models, dev, chip_smoke.SEQ_LENGTHS)

            def call():
                return fused_pf.fused_window(
                    model, pvec, x0, normals, ys, weights, xi, 1.0,
                    v["ess"], seeds=seeds, vs=vs)
            out = call()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"non-finite K1 output for {name}")
            W = ys.shape[1]
            ms_guess = 0.2 * W * v["C"] / 8192
            rounds = time_call(call, max(2, int(100 / ms_guess)),
                               args.rounds)
            shape = f"C={v['C']} N={N} W={W}" + (
                f" ({int((vs > 0).sum())} row-steps valid)"
                if vs is not None else "")
            nbytes = 4 * (sum(a.numel() for a in (pvec, x0, normals, ys,
                                                  weights, xi, vs)
                              if a is not None) + out.numel()) + (
                8 * seeds.numel() if seeds is not None else 0)
            bound = chip_smoke.bound_ms(nbytes, chip_smoke.k1_ops(
                v["C"], v["body"], rng=v["rng"], ess=v["ess"] is not None,
                Z=model.noise_dims, steps=W,
                active=None if vs is None else int((vs > 0).sum())))
            del out
        rec = dict(root=args.root, variant=name, spec=PRESETS.get(name, name),
                   shape=shape, ms=statistics.median(rounds),
                   bound_ms=bound[0], bound_by=bound[1],
                   rounds=[round(r, 5) for r in rounds], **extra, card=card)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
