"""Distributed SG-MCMC training step: chains x particles over a device mesh.

Counterpart of ``sgmcmc_tpu/parallel/training.py``.  Each rank runs the
SGLD step of its chain block (``sharding.shard_chain_states``); the
particle filter of each chain runs one of three routes, as in the JAX
package (``training.py:50-60``):

* P = 1 particle rank: the sampler's own score, so the fused window (K1,
  ``ops/cuda/fused_pf.py``) wherever ``fit_scan`` takes it;
* ``island_fused`` with P > 1: K1 at ``N_loc = N / P`` particles on every
  rank, an independent island filter on draws of its own, the statistic
  and log-likelihood averaged over the particle group (``all_reduce``
  SUM / P) — the island estimator of Vergé et al. (2015);
* otherwise the sharded smoother of ``pf_shard.py`` (global resampling).

Random streams.  Draws that every particle rank of a chain block must
share — the window start, the systematic comb's uniform, the Langevin
noise — come from the block's ``shared`` generator; the particle draws
(initial and proposal normals, multinomial uniforms, K1's Philox seeds,
PaRIS's backward uniforms) from the rank's ``own`` generator, seeded from
(seed, chain block, particle rank): the port's ``fold_in(key,
axis_index("particle"))``.  So the particle ranks of a block update the
same parameters.  Unlike the JAX package the island route takes any
N_loc (its ``n_local % 8`` is a TPU sublane rule; K1 takes any particle
count).
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..inference import sgmcmc
from ..inference.sgmcmc import PFScore, PFScoreConfig, WindowDraws
from ..models.base import ParticleKernel, StatisticFn
from ..ops.subsequence import sample_start
from ..utils.profiling import span
from . import sharding
from .pf_shard import SUM, run_buffered_pf_sharded

# below this many particles a rank the island estimator's smoother bias
# grows past the reference's Nemeth trade (scripts/island_bias_sweep.json)
ISLAND_MIN_PARTICLES = 256


def _seed(*words) -> int:
    return int(np.random.SeedSequence([int(w) for w in words])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def rank_generators(generator: torch.Generator, mesh):
    """``(shared, own)`` generators of this rank.  With one chain block
    ``shared`` is ``generator`` itself (so a 1 x 1 mesh draws exactly what
    ``fit_scan(num_chains=C)`` draws); otherwise both are seeded from one
    draw of ``generator``, which every rank makes alike: ``shared`` from
    (it, chain block), ``own`` from (it, chain block, particle rank).
    ``own`` is None for one particle rank."""
    n_chain = sharding.axis_size(mesh, "chain")
    P = sharding.axis_size(mesh, "particle")
    if n_chain == 1 and P == 1:
        return generator, None
    c, p = sharding.mesh_coordinates(mesh)
    dev = generator.device
    base = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=dev))

    def gen(*words):
        return torch.Generator(device=dev).manual_seed(_seed(base, *words))
    shared = generator if n_chain == 1 else gen(c)
    return shared, (None if P == 1 else gen(c, p))


def _starts(score: PFScore, shared, R: int, device) -> torch.Tensor:
    """The window starts of R rows, from the shared generator."""
    cfg = score.config
    if score.full:
        return torch.zeros((R,), dtype=torch.int64, device=device)
    return sample_start(shared, cfg.subsequence_length, score.T, R,
                        cfg.partition_style, device)


def island_row_scores(score: PFScore, shared, own, params, observations,
                      group):
    """The island route's per-row ``(statistic [R, H], loglik [R])``: K1
    at ``score.config.n_particles`` (= N_loc) particles on this rank's
    draws, summed over ``group`` and divided by its size P."""
    P = dist.get_world_size(group)
    R = params.num_chains * score.rows_per_chain
    with span("sgmcmc.score.draw"):
        draws = score._noise(own, observations.device,
                             _starts(score, shared, R, observations.device))
    stat, ll = score.row_scores(own, params, observations, draws)
    return (sharding.all_reduce(stat, SUM, group) / P,
            sharding.all_reduce(ll, SUM, group) / P)


def sharded_row_scores(score: PFScore, shared, own, params, observations,
                       group):
    """The sharded smoother's per-row ``(statistic [R, H], loglik [R])``:
    ``run_buffered_pf_sharded`` over this rank's ``N / P`` particles of
    every row's filter (``score.config.n_particles`` = N, P the size of
    ``group``)."""
    cfg = score.config
    n_local = cfg.n_particles // dist.get_world_size(group)
    dev = observations.device
    R = params.num_chains * score.rows_per_chain
    W, Z = score.W, score.kernel.noise_dim
    with span("sgmcmc.score.draw"):
        start = _starts(score, shared, R, dev)
        z0 = torch.randn((R, Z, n_local), generator=own, device=dev)
        normals = torch.randn((R, W, Z, n_local), generator=own, device=dev)
        u = (torch.rand((R, W), generator=shared, device=dev)
             if cfg.resampler == "systematic" else
             torch.rand((R, W, n_local), generator=own, device=dev))
        v = (torch.rand((R, W, n_local, cfg.n_tilde), generator=own,
                        device=dev) if cfg.smoother == "paris" else None)
    draws = WindowDraws(start, z0, normals, u, v=v)
    rows, window, step_w, in_win, _, pm, pv = score.inputs(
        params, observations, draws)
    with span("sgmcmc.score.filter"):
        return run_buffered_pf_sharded(
            score.kernel, score.stat_fn, rows, window, z0=z0,
            normals=normals, u=u, statistic_dim=score.statistic_dim,
            group=group, smoother=cfg.smoother, step_weights=step_w,
            in_window=in_win, prior_mean=pm, prior_var=pv,
            resampler=cfg.resampler, lambduh=cfg.lambduh,
            n_tilde=cfg.n_tilde, ess_threshold=cfg.ess_threshold,
            bw_chunk=cfg.bw_chunk, v=v)


def make_distributed_sgld_step(
        kernel: ParticleKernel, stat_fn: StatisticFn, statistic_dim: int,
        unpack, grad_logprior_fn, config: PFScoreConfig, T: int, mesh,
        epsilon: float, prior_mean_var_fn=None, project_fn=None,
        is_scaled: bool = True, fused_model=None, island_fused: bool = False,
        warn_small_islands: bool = True):
    """Build ``step(shared, own, params_local, observations [T, m]) ->
    (params, loglik [C_loc])`` for this rank's chain block (``shared`` /
    ``own``: :func:`rank_generators`).  Each chain's particle filter has
    ``config.n_particles`` particles over the mesh's particle axis; the
    route is the module docstring's.  The step projects with
    ``project_fn``."""
    P = sharding.axis_size(mesh, "particle")
    N = config.n_particles
    if N % P:
        raise ValueError(f"n_particles={N} must split over the particle "
                         f"axis of {P} ranks")
    n_local = N // P
    fused_ok = sgmcmc._fused_eligible(config, fused_model)
    use_island = island_fused and P > 1 and fused_ok
    if use_island and n_local < ISLAND_MIN_PARTICLES and warn_small_islands:
        warnings.warn(
            f"island_fused with island size {n_local} (< 256): the island "
            f"estimator's smoother bias is the Poyiadjis bias at "
            f"N = island size, which grows as islands shrink (~1/N decay; "
            f"per-model measured curves in scripts/island_bias_sweep.json "
            f"— LGSSM exact-Kalman oracle: >= 256 stays under the "
            f"reference's own Nemeth-lambda=0.95 trade, >= 512 ~ global "
            f"resampling; SVM N=2^20 oracle: >= 128 under the Nemeth "
            f"trade, >= 256 ~ global resampling).  Use >= 256 particles "
            f"per device, or disable island_fused for the "
            f"unbiased-at-full-N global-resampling estimator.",
            stacklevel=2)
    if P > 1 and not use_island and config.resampler not in (
            "systematic", "multinomial"):
        raise ValueError(f"the sharded smoother resamples systematic or "
                         f"multinomial, not '{config.resampler}'")
    if P > 1 and not use_island and config.smoother == "paris_ar":
        raise ValueError("the sharded smoother has no paris_ar")
    score = PFScore(kernel, stat_fn, statistic_dim, unpack, config, T,
                    prior_mean_var_fn, fused_model)
    if use_island:
        score = PFScore(kernel, stat_fn, statistic_dim, unpack,
                        dataclasses.replace(config, n_particles=n_local),
                        T, prior_mean_var_fn, fused_model)
        score.fused_on_cpu = True
    M = score.rows_per_chain
    rows_fn = island_row_scores if use_island else sharded_row_scores

    def score_fn(own):
        """The score of this rank: the sampler's own at one particle rank,
        else the rows of the island or sharded route (the generator it is
        called with is the shared one), averaged over the minibatch."""
        if P == 1:
            return score
        group = sharding.axis_group(mesh, "particle")

        def sharded_score(shared, params, observations, draws=None):
            with span("sgmcmc.score"):
                stat, ll = rows_fn(score, shared, own, params, observations,
                                   group)
                C = params.num_chains
                return (unpack(stat.reshape(C, M, -1).mean(1)),
                        ll.reshape(C, M).mean(1))

        return sharded_score

    def step(shared, own, params, observations):
        grad_fn = sgmcmc.make_noisy_grad_fn(score_fn(own), grad_logprior_fn,
                                            T, is_scaled=is_scaled)
        new, ll = sgmcmc.sgld_step(shared, params, observations, grad_fn,
                                   epsilon, T, is_scaled=is_scaled)
        if project_fn is not None:
            new = project_fn(new)
        return new, ll

    return step


def make_distributed_fit(step, num_iters: int):
    """``fit(shared, own, params_local, observations) -> (params,
    loglik [C_loc, num_iters])``: ``num_iters`` distributed steps."""
    fit = make_distributed_fit_recorded(step, num_iters, output_all=False)

    def run(shared, own, params, observations):
        params, _, aux = fit(shared, own, params, observations)
        return params, aux

    return run


def make_distributed_fit_recorded(step, num_iters: int,
                                  steps_per_iter: int = 1,
                                  output_all: bool = True):
    """:func:`make_distributed_fit` with ``fit_scan``'s recording
    conventions: ``num_iters`` recorded iterations of ``steps_per_iter``
    steps.  Returns ``fit(shared, own, params_local, observations) ->
    (params, trace [C_loc, num_iters, ...] or None, loglik [C_loc,
    num_iters])`` over the rank's chain block
    (``sharding.gather_chain_states`` gathers them)."""
    def fit(shared, own, params, observations):
        return sgmcmc.fit(
            shared, params, observations,
            lambda gen, p, obs: step(gen, own, p, obs), num_iters,
            steps_per_iter=steps_per_iter, output_all=output_all)

    return fit
