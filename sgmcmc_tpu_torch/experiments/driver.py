"""Experiment driver CLI (counterpart of ``sgmcmc_tpu/experiments/driver.py``).

    python -m sgmcmc_tpu_torch.experiments.driver --path DIR --model svm \\
        --setup | --make_scripts | --fit | --eval TARGET | \\
        --trace_eval ksd|kstest | --process_out | --make_plots [--device cpu]

Phases:

  --setup          synthetic train/test data, inits, the option grid
  --make_scripts   shell scripts for batch execution
  --fit            checkpointed SG-MCMC fit of --experiment_id (one chain,
                   or C chains with --num_chains C)
  --eval           offline evaluation (train/test/half_avg_train/
                   half_avg_test)
  --trace_eval     trace metrics (ksd, kstest)
  --process_out    the per-experiment CSVs joined with the options
  --make_plots     metric-vs-time facet plots (pandas and matplotlib)

Everything runs on the card unless ``--device cpu``.  Experiment state
lives under --path, in the port's own files (the JAX package's
experiment directories are not read):

  in/options.p, in/options.csv, in/data.p, in/init_{method}.p
  scratch/fit_<id>_state.p, fit_<id>_multichain_state.p,
  scratch/ksd_<id>_state.p                          (resume states)
  out/fit/<id>_parameters.p                         (traces)
  out/{fit,eval,trace_eval}/<id>_*.csv
  processed/aggregated.csv

The pickles hold the port's parameter dataclasses with NumPy leaves,
NumPy arrays and builtins only, so a directory loads without the card,
torch's device state or JAX.  The tables are written without pandas
(``io/tables.py``), as pandas would write them.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from ..evaluation.evaluator import (OfflineEvaluator, SamplerEvaluator,
                                    half_average_parameters_list)
from ..inference import sgmcmc
from ..inference.samplers import Sampler, sampler_for_model
from ..io import checkpoint as ckpt
from ..io import tables
from ..metrics import metric_functions as mf
from ..metrics.ksd import compute_ksd
from ..models.base import params_map
from ..models.registry import get_model
from . import config as cfg

logger = logging.getLogger(__name__)

DRIVER_MODULE = "sgmcmc_tpu_torch.experiments.driver"

KSD_VARIABLES = {
    # the natural trace-eval coordinates of each model
    "svm": ["phi", "sigma", "tau"],
    "svjm": ["phi", "sigma", "tau", "logit_pJ", "sigmaJ"],
    "garch": ["log_mu", "logit_phi", "logit_lambduh", "tau"],
    "lgssm": ["A", "Q", "R"],
    "gauss_hmm": ["logit_pi", "mu", "tau"],
    "arphmm": ["logit_pi", "D", "tau"],
    "slds": ["logit_pi", "A", "sigma", "tau"],
}

TRUE_PARAMS = {
    "svm": dict(A=0.9, Q=0.5, R=1.0),
    "svjm": dict(A=0.9, Q=0.5, R=1.0, pJ=0.05, QJ=2.0),
    "lgssm": dict(A=0.9, Q=0.5, R=1.0),
    "garch": dict(alpha=0.1, beta=0.4, gamma=0.3, R=0.5),
    "gauss_hmm": dict(pi=[[0.9, 0.1], [0.1, 0.9]],
                      mu=[[-1.0], [1.0]],
                      R=[[[0.5]], [[0.5]]]),
    "arphmm": dict(pi=[[0.9, 0.1], [0.1, 0.9]],
                   D=[[[0.7]], [[-0.7]]],
                   R=[[[0.5]], [[0.5]]]),
    "slds": dict(pi=[[0.95, 0.05], [0.05, 0.95]],
                 A=[[[0.9]], [[-0.9]]],
                 Q=[[[0.5]], [[0.5]]], C=[[1.0]], R=[[0.5]]),
}

HMM_MODELS = ("gauss_hmm", "arphmm")


def _flat(x) -> np.ndarray:
    return np.ravel(ckpt.tree_to_numpy(x))


def convert_gradient(model_name: str, params, grad):
    """A storage-coordinate score as (values, score) in the natural KSD
    coordinates of ``KSD_VARIABLES`` (SimpleNamespaces of NumPy vectors),
    by the exact chain rule: with sigma = 1/LQinv, dLQinv/dsigma =
    -LQinv^2, so g_sigma = -g_LQinv * LQinv^2; with Q = LQinv^-2 (the
    LGSSM), g_Q = -0.5 * g_LQinv * LQinv^3.  ``params`` / ``grad`` are one
    chain's parameters (tensors on any device, or NumPy)."""
    def scal(x):
        return float(_flat(x)[0])

    if model_name == "svm":
        LQ, LR = scal(params.LQinv_vec), scal(params.LRinv_vec)
        vals = dict(phi=_flat(params.A), sigma=np.array([1.0 / LQ]),
                    tau=np.array([1.0 / LR]))
        grads = dict(phi=_flat(grad.A),
                     sigma=-_flat(grad.LQinv_vec) * LQ ** 2,
                     tau=-_flat(grad.LRinv_vec) * LR ** 2)
    elif model_name == "svjm":
        LQ, LR = scal(params.LQinv_vec), scal(params.LRinv_vec)
        LJ = scal(params.LQJinv_vec)
        vals = dict(phi=_flat(params.A), sigma=np.array([1.0 / LQ]),
                    tau=np.array([1.0 / LR]),
                    logit_pJ=_flat(params.logit_pJ),
                    sigmaJ=np.array([1.0 / LJ]))
        grads = dict(phi=_flat(grad.A),
                     sigma=-_flat(grad.LQinv_vec) * LQ ** 2,
                     tau=-_flat(grad.LRinv_vec) * LR ** 2,
                     logit_pJ=_flat(grad.logit_pJ),
                     sigmaJ=-_flat(grad.LQJinv_vec) * LJ ** 2)
    elif model_name == "garch":
        LR = scal(params.LRinv_vec)
        vals = dict(log_mu=_flat(params.log_mu),
                    logit_phi=_flat(params.logit_phi),
                    logit_lambduh=_flat(params.logit_lambduh),
                    tau=np.array([1.0 / LR]))
        grads = dict(log_mu=_flat(grad.log_mu),
                     logit_phi=_flat(grad.logit_phi),
                     logit_lambduh=_flat(grad.logit_lambduh),
                     tau=-_flat(grad.LRinv_vec) * LR ** 2)
    elif model_name == "lgssm":
        LQ, LR = scal(params.LQinv_vec), scal(params.LRinv_vec)
        vals = dict(A=_flat(params.A), Q=np.array([LQ ** -2]),
                    R=np.array([LR ** -2]))
        grads = dict(A=_flat(grad.A),
                     Q=-0.5 * _flat(grad.LQinv_vec) * LQ ** 3,
                     R=-0.5 * _flat(grad.LRinv_vec) * LR ** 3)
    elif model_name == "slds":
        # the scalar-block SLDS (n = m = 1): logit_pi and A in storage
        # coordinates; sigma_k = 1/LQinv_k and tau = 1/LRinv (no abs: the
        # -g L^2 chain rule assumes tau = 1/L; the projection keeps L > 0
        # on the driver's traces)
        LQ, LR = _flat(params.LQinv_vec), _flat(params.LRinv_vec)
        vals = dict(logit_pi=_flat(params.logit_pi), A=_flat(params.A),
                    sigma=1.0 / LQ, tau=1.0 / LR)
        grads = dict(logit_pi=_flat(grad.logit_pi), A=_flat(grad.A),
                     sigma=-_flat(grad.LQinv_vec) * LQ ** 2,
                     tau=-_flat(grad.LRinv_vec) * LR ** 2)
    elif model_name in HMM_MODELS:
        # the m = 1 HMMs of the driver's setup: logit_pi rows and the
        # location block in storage coordinates; tau_k = 1/LRinv_k, so
        # g_tau = -g_LRinv * LRinv^2
        LR = _flat(params.LRinv_vec)
        loc = "mu" if model_name == "gauss_hmm" else "D"
        vals = {"logit_pi": _flat(params.logit_pi),
                loc: _flat(getattr(params, loc)), "tau": 1.0 / LR}
        grads = {"logit_pi": _flat(grad.logit_pi),
                 loc: _flat(getattr(grad, loc)),
                 "tau": -_flat(grad.LRinv_vec) * LR ** 2}
    else:
        raise ValueError(f"no natural coordinates for {model_name}")
    return SimpleNamespace(**vals), SimpleNamespace(**grads)


def _make_true_params(model_name: str, dtype=torch.float64, device=None):
    """The synthetic experiments' true parameters (one chain)."""
    p = TRUE_PARAMS[model_name]
    if model_name == "svm":
        from ..models import svm
        return svm.from_scalars(**p, dtype=dtype, device=device)
    if model_name == "svjm":
        from ..models import svjm
        return svjm.from_scalars(**p, dtype=dtype, device=device)
    if model_name == "lgssm":
        from ..models import lgssm
        return lgssm.from_matrices(A=[[p["A"]]], C=[[1.0]], Q=[[p["Q"]]],
                                   R=[[p["R"]]], dtype=dtype, device=device)
    if model_name == "garch":
        from ..models import garch
        return garch.from_alpha_beta_gamma(**p, dtype=dtype, device=device)
    if model_name == "gauss_hmm":
        from ..models import gauss_hmm
        return gauss_hmm.from_values(p["pi"], p["mu"], p["R"], dtype=dtype,
                                     device=device)
    if model_name == "arphmm":
        from ..models import arphmm
        return arphmm.from_values(p["pi"], p["D"], p["R"], dtype=dtype,
                                  device=device)
    if model_name == "slds":
        from ..models import slds
        return slds.from_values(p["pi"], p["A"], p["Q"], p["C"], p["R"],
                                dtype=dtype, device=device)
    raise ValueError(model_name)


def _paths(root):
    return {name: os.path.join(root, name)
            for name in ["in", "scratch", "out", "processed", "scripts"]}


def _to_sampler(sampler: Sampler, params):
    """One parameter object (NumPy or tensor leaves) as tensors on the
    sampler's device in its observations' dtype (float32, float64 for the
    HMMs; another init dtype would change the steps')."""
    return ckpt.tree_to_torch(params, device=sampler.device,
                              dtype=sampler.observations.dtype)


def _unstack_chain(stacked, c: int) -> list:
    """Chain ``c`` of a stacked ``[C, n, ...]`` trace as a list of n
    one-chain parameters (each with its chain axis of 1)."""
    return ckpt.unstack_trace(params_map(lambda x: x[c][:, None], stacked))


# --------------------------------------------------------------------------
# setup
# --------------------------------------------------------------------------

def do_setup(args, sampler_grid=None):
    """Train / test data, inits and the experiment-option grid.  The data
    and the prior init come from one ``torch.Generator`` on ``--device``
    seeded by ``--seed``."""
    model_name = args.model
    true_params = _make_true_params(model_name, device=args.device)
    p = _paths(args.path)
    for d in p.values():
        ckpt.make_path(d)
    model = get_model(model_name)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    # the SLDS's generate_data returns (y, x, z), the others' (y, x)
    train = model.generate_data(gen, true_params, args.T)
    test = model.generate_data(gen, true_params, args.T_test)
    data = dict(observations=ckpt.tree_to_numpy(train[0]),
                latent_vars=ckpt.tree_to_numpy(train[1]),
                test_observations=ckpt.tree_to_numpy(test[0]),
                test_latent_vars=ckpt.tree_to_numpy(test[1]),
                parameters=ckpt.tree_to_numpy(true_params))
    if len(train) > 2:
        data["latent_z"] = ckpt.tree_to_numpy(train[2])
        data["test_latent_z"] = ckpt.tree_to_numpy(test[2])
    ckpt.save_pickle(os.path.join(p["in"], "data.p"), data)

    prior = model.default_prior(device=args.device)
    for method in args.init_methods:
        if method == "truth":
            init = true_params
        elif method == "prior":
            init = model.project_parameters(model.sample_prior(prior, gen, 1))
        else:
            raise ValueError(method)
        ckpt.save_pickle(os.path.join(p["in"], f"init_{method}.p"),
                         ckpt.tree_to_numpy(init))

    if sampler_grid is None:
        sampler_grid = default_sampler_grid(model_name)
    data_args = [dict(init_method=m) for m in args.init_methods]
    options_list = [cfg.with_defaults(o)
                    for o in cfg.dict_product(sampler_grid, data_args)]
    for i, o in enumerate(options_list):
        o["experiment_id"] = i
        o["model"] = model_name
        o["T"] = args.T
    ckpt.save_pickle(os.path.join(p["in"], "options.p"), options_list)
    tables.write_csv(os.path.join(p["in"], "options.csv"), options_list)
    logger.info("setup: %d experiments", len(options_list))
    return options_list


def default_sampler_grid(model_name):
    """The default experiment grid: Poyiadjis O(N) with and without a
    buffer, Nemeth and PaRIS; the LGSSM adds Gibbs and the exact-message
    (Kalman) score.  The HMMs have no particle filter: Gibbs, exact-message
    SGLD with and without a buffer, and SCIR.  The SLDS: Gibbs and the
    buffered complete-data SGLD, its only gradient family."""
    if model_name == "slds":
        grids = [
            dict(iter_type=["Gibbs"], name=["GIBBS"]),
            dict(iter_type=["SGLD"], epsilon=[0.05],
                 subsequence_length=[16], buffer_length=[4],
                 steps_per_iteration=[5], latent_draws=[1],
                 latent_burnin=[5], name=["SGLD_COMPLETE"]),
        ]
        return [o for g in grids for o in cfg.parameter_grid(g)]
    if model_name in HMM_MODELS:
        grids = [
            dict(iter_type=["Gibbs"], name=["GIBBS"]),
            dict(iter_type=["SGLD"], kind=["marginal"], epsilon=[0.1],
                 subsequence_length=[16], buffer_length=[0, 4],
                 steps_per_iteration=[10], name=["SGLD"]),
            dict(iter_type=["SCIR"], epsilon=[0.1],
                 subsequence_length=[16], buffer_length=[4],
                 steps_per_iteration=[10], name=["SCIR"]),
        ]
        return [o for g in grids for o in cfg.parameter_grid(g)]
    grids = [
        dict(iter_type=["SGLD"], epsilon=[0.1], subsequence_length=[40],
             buffer_length=[0, 10], steps_per_iteration=[10],
             pf=["poyiadjis_N"], N=[1000], name=["POYIADJIS_N_1000"]),
        dict(iter_type=["SGLD"], epsilon=[0.1], subsequence_length=[40],
             buffer_length=[10], steps_per_iteration=[10],
             pf=["nemeth"], N=[1000], name=["NEMETH_1000"]),
        dict(iter_type=["SGLD"], epsilon=[0.1], subsequence_length=[40],
             buffer_length=[10], steps_per_iteration=[10],
             pf=["paris"], N=[100], name=["PARIS_100"]),
    ]
    if model_name == "lgssm":
        grids.append(dict(iter_type=["Gibbs"], name=["GIBBS"]))
        grids.append(dict(iter_type=["SGLD"], kind=["marginal"],
                          epsilon=[0.1], subsequence_length=[40],
                          buffer_length=[10], steps_per_iteration=[10],
                          name=["KF"]))
    out = []
    for g in grids:
        out.extend(cfg.parameter_grid(g))
    return out


# --------------------------------------------------------------------------
# fit
# --------------------------------------------------------------------------

def _build_sampler(options, data, init_params, device,
                   obs_key: str = "observations") -> Sampler:
    """The model's sampler on ``device`` at ``init_params`` (one chain,
    NumPy or tensor leaves, cast to the model's dtype); the SLDS's sizes
    (states, latent and observation dimensions) are the parameters'."""
    name = options["model"]
    params = ckpt.tree_to_torch(init_params, device=device,
                                dtype=get_model(name).dtype)
    sizes = {}
    if name == "slds":
        sizes = dict(num_states=params.num_states, n=params.n, m=params.m)
    return sampler_for_model(name, observations=data[obs_key],
                             seed=options.get("seed", 0), device=device,
                             parameters=params, **sizes)


def _metric_fns(options, data):
    variables = KSD_VARIABLES[options["model"]]
    return [mf.metric_function_parameters(data["parameters"], variables,
                                          "logmse")]


def _rank() -> int:
    """This process's rank in the process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def _agree(flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank of the process group (the time
    budget's decision, which each rank's own clock could split)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    box = [flag]
    dist.broadcast_object_list(box, src=0)
    return bool(box[0])


def _mesh_kwargs(args, iter_type: str) -> dict:
    """``fit_scan``'s keywords of ``--num_particle_devices P`` (each
    chain's particle filter over P ranks: one process per device, under
    ``torchrun --nproc_per_node``) and ``--island_fused``."""
    P = getattr(args, "num_particle_devices", 1) or 1
    island = getattr(args, "island_fused", False)
    if P == 1:
        if island:
            raise ValueError("--island_fused needs --num_particle_devices "
                             "> 1")
        return {}
    if iter_type != "SGLD":
        raise ValueError(f"--num_particle_devices needs iter_type SGLD (the "
                         f"distributed training step), not {iter_type!r}")
    if not dist.is_initialized():
        raise ValueError(
            f"--num_particle_devices {P} runs one process per device: "
            f"launch the driver with torchrun --nproc_per_node {P} (or a "
            f"multiple of it)")
    return dict(n_particle_devices=P, island_fused=island)


def _generator_state(sampler) -> np.ndarray:
    return sampler.generator.get_state().numpy()


def _set_generator_state(sampler, state) -> None:
    sampler.generator.set_state(torch.from_numpy(np.asarray(state)))


def _adagrad_state(sampler):
    """The sampler's ADAGRAD state (accumulated squared gradients G and
    step counts t) as NumPy, or None."""
    st = sampler._adagrad_state
    return None if st is None else dict(G=ckpt.tree_to_numpy(st.G),
                                        t=st.t.cpu().numpy())


def _set_adagrad_state(sampler, state) -> None:
    """Restore :func:`_adagrad_state`'s output (None: a fresh state at the
    first ADAGRAD step)."""
    if state is not None:
        sampler._adagrad_state = sgmcmc.AdagradState(
            G=_to_sampler(sampler, state["G"]),
            t=torch.as_tensor(state["t"], device=sampler.device))


def _sampler_rng(device) -> str:
    """The fused window's normals: drawn in the kernel on the card, by
    the host's generator on the CPU (the kernel does not run there)."""
    return "kernel" if torch.device(device).type == "cuda" else "host"


def do_fit_multichain(args, options):
    """C chains through ``Sampler.fit_scan(num_chains=C)`` in chunks of
    ``checkpoint_num_iters`` iterations, checkpointed after each (the
    chunks so far, the parameters and the generator's state), then
    per-coordinate convergence rows.

    Output: out/fit/<id>_parameters.p (``parameters_list``: chain 0's
    trace, so --eval / --trace_eval work unchanged, and
    ``chain_parameters``: the stacked [C, n, ...] trace),
    out/fit/<id>_convergence.csv."""
    from ..metrics.convergence import convergence_summary
    p = _paths(args.path)
    data = ckpt.load_pickle(os.path.join(p["in"], "data.p"))
    init = ckpt.load_pickle(
        os.path.join(p["in"], f"init_{options['init_method']}.p"))
    # a state of its own: a single-chain fit's state is not a resume point
    state_path = os.path.join(
        p["scratch"], f"fit_{options['experiment_id']}_multichain_state.p")
    C = args.num_chains
    iter_type = options.get("iter_type", "SGLD")
    if iter_type not in ("SGLD", "SGRLD", "SGD", "ADAGRAD"):
        raise ValueError(
            f"--num_chains {C} needs a gradient iter_type "
            f"(SGLD/SGRLD/SGD/ADAGRAD), not {iter_type!r}")
    mesh_kwargs = _mesh_kwargs(args, iter_type)
    # under a process group every rank fits, rank 0 alone writes
    writes = _rank() == 0
    sampler = _build_sampler(options, data, init, args.device)
    if not hasattr(sampler, "fit_scan"):
        raise ValueError(
            f"--num_chains needs a fit_scan-capable sampler; "
            f"{type(sampler).__name__} (model {options['model']!r}) has "
            f"none: run it single-chain")
    step_kwargs = cfg.sampler_kwargs(options)
    if sampler.model.has_pf and step_kwargs.get("kind") is None:
        step_kwargs.setdefault("rng", _sampler_rng(sampler.device))
    eps = options.get("epsilon", 0.1)
    steps = options.get("steps_per_iteration", 1)
    max_time = args.max_time or options.get("max_time", 60)
    max_iters = options.get("max_num_iters", 10 ** 6)
    chunk = min(options.get("checkpoint_num_iters", 1000), max_iters)
    # independent prior inits when the experiment's own init is a prior
    # draw; a truth init replicates (the chains part by their noise)
    chain_init = ("prior" if options.get("init_method") == "prior"
                  else "replicate")

    chunks, times, it = [], [], 0
    if os.path.exists(state_path) and not args.no_resume:
        state = ckpt.load_pickle(state_path)
        chunks, times, it = (state["chunks"], state["times"],
                             state["iteration"])
        sampler.parameters = _to_sampler(sampler, state["parameters"])
        sampler._num_chains = state["num_chains"]
        _set_generator_state(sampler, state["generator_state"])
        _set_adagrad_state(sampler, state.get("adagrad_state"))
        chain_init = "replicate"
        logger.info("resumed multichain fit %s at iteration %d",
                    options["experiment_id"], it)

    t0 = time.perf_counter()
    while _agree(time.perf_counter() - t0 < max_time) and it < max_iters:
        n = min(chunk, max_iters - it)
        trace = sampler.fit_scan(iter_type, num_iters=n, epsilon=eps,
                                 steps_per_iteration=steps, num_chains=C,
                                 chain_init=chain_init, **mesh_kwargs,
                                 **step_kwargs)
        chain_init = "replicate"
        chunks.append(ckpt.tree_to_numpy(trace))
        it += n
        times.extend([time.perf_counter() - t0] * n)
        if writes:
            ckpt.save_pickle(state_path, dict(
                chunks=chunks, times=times, iteration=it,
                parameters=ckpt.tree_to_numpy(sampler.parameters),
                num_chains=C, generator_state=_generator_state(sampler),
                adagrad_state=_adagrad_state(sampler)))
    trace = params_map(lambda *xs: np.concatenate(xs, axis=1), *chunks)

    if not writes:
        sampler.select_chain(0)
        return sampler
    out_dir = ckpt.make_path(os.path.join(p["out"], "fit"))
    if it - int(it * 0.5) < 2:
        # half burned, fewer than two samples a chain: nothing to split
        logger.warning("multichain fit %s: %d iterations are too few for "
                       "convergence rows", options["experiment_id"], it)
    else:
        rows = convergence_summary(trace, burn_frac=0.5)
        for r in rows:
            r["experiment_id"] = options["experiment_id"]
        tables.write_csv(os.path.join(
            out_dir, f"{options['experiment_id']}_convergence.csv"), rows)
        worst = max(r["rhat_rank"] for r in rows)
        logger.info("multichain fit %s: %d iters x %d chains, max "
                    "rhat_rank %.3f", options["experiment_id"], it, C, worst)
        if worst > 1.1:
            logger.warning("max rank-normalized split-R-hat %.3f > 1.1: "
                           "chains are not mixed at this budget (see "
                           "*_convergence.csv)", worst)

    parameters_list = [ckpt.tree_to_numpy(init)] + _unstack_chain(trace, 0)
    ckpt.save_trace(os.path.join(
        out_dir, f"{options['experiment_id']}_parameters.p"),
        parameters_list, [0.0] + times,
        extra=dict(chain_parameters=trace, num_chains=C))
    sampler.select_chain(0)
    return sampler


def do_fit(args, options):
    """Checkpointed single-chain fit loop over
    ``SamplerEvaluator.evaluate_sampler_step``, metrics every
    ``eval_freq`` seconds of sampler time and at the last iteration; the
    resume state carries the generator's state and ADAGRAD's, so a resumed
    fit equals an uninterrupted one.  ``--num_chains C > 1`` and the
    mesh flags (``--num_particle_devices``, ``--island_fused``):
    :func:`do_fit_multichain`.
    """
    if (getattr(args, "num_chains", 1) > 1
            or (getattr(args, "num_particle_devices", 1) or 1) > 1
            or getattr(args, "island_fused", False)):
        return do_fit_multichain(args, options)
    p = _paths(args.path)
    data = ckpt.load_pickle(os.path.join(p["in"], "data.p"))
    init = ckpt.load_pickle(
        os.path.join(p["in"], f"init_{options['init_method']}.p"))
    state_path = os.path.join(p["scratch"],
                              f"fit_{options['experiment_id']}_state.p")

    iter_type = options.get("iter_type", "SGLD")
    step_kwargs = cfg.sampler_kwargs(options)
    func_names, func_kwargs = _iter_funcs(iter_type, options, step_kwargs)
    sampler = _build_sampler(options, data, init, args.device)
    evaluator = SamplerEvaluator(
        sampler, metric_functions=_metric_fns(options, data),
        sample_functions=[mf.sample_function_parameters(
            KSD_VARIABLES[options["model"]])])

    parameters_list = [ckpt.tree_to_numpy(sampler.parameters)]
    times = [0.0]
    start_iteration = 0
    if os.path.exists(state_path) and not args.no_resume:
        state = ckpt.load_pickle(state_path)
        ev_state = dict(state["evaluator_state"])
        ev_state["parameters"] = _to_sampler(sampler, ev_state["parameters"])
        evaluator.load_state(ev_state)
        _set_generator_state(sampler, state["generator_state"])
        _set_adagrad_state(sampler, state.get("adagrad_state"))
        parameters_list = state["parameters_list"]
        times = state["times"]
        start_iteration = state["iteration"]
        logger.info("resumed fit %s at iteration %d",
                    options["experiment_id"], start_iteration)

    steps = options.get("steps_per_iteration", 1)
    max_time = args.max_time or options.get("max_time", 60)
    max_iters = options.get("max_num_iters", 10 ** 6)
    checkpoint_every = options.get("checkpoint_num_iters", 1000)
    # eval_freq is seconds of sampler time between metric evaluations;
    # the parameters are recorded every iteration
    eval_freq = options.get("eval_freq", 5)
    t_start = time.perf_counter()
    last_eval = -float("inf")
    it = start_iteration

    def evaluate_now():
        nonlocal last_eval
        evaluator.eval_metric_functions(sampler, evaluator.iteration,
                                        time=evaluator.elapsed_time)
        evaluator.eval_sample_functions(sampler, evaluator.iteration,
                                        time=evaluator.elapsed_time)
        last_eval = evaluator.elapsed_time

    def save_state():
        _save_fit_state(state_path, evaluator, sampler, parameters_list,
                        times, it)

    try:
        while (time.perf_counter() - t_start < max_time
               and it < max_iters):
            for _ in range(steps):
                evaluator.evaluate_sampler_step(func_names, func_kwargs,
                                                evaluate=False)
            if (evaluator.elapsed_time - last_eval > eval_freq
                    or it + 1 >= max_iters):
                evaluate_now()
            parameters_list.append(ckpt.tree_to_numpy(sampler.parameters))
            times.append(evaluator.elapsed_time)
            it += 1
            if it % checkpoint_every == 0:
                save_state()
        if last_eval != evaluator.elapsed_time:
            # a max-time exit between evaluations: the final parameters'
            # metrics must exist
            evaluate_now()
    except Exception:
        save_state()
        raise
    save_state()
    out_dir = ckpt.make_path(os.path.join(p["out"], "fit"))
    ckpt.save_trace(os.path.join(
        out_dir, f"{options['experiment_id']}_parameters.p"),
        parameters_list, times)
    tables.write_csv(os.path.join(
        out_dir, f"{options['experiment_id']}_metrics.csv"),
        evaluator.metric_rows)
    if len(parameters_list) >= 9:
        # split-chain diagnostics of the one chain, stacked [1, n, ...]
        # as the multichain rows, so --process_out aggregates both
        from ..metrics.convergence import convergence_summary
        rows = convergence_summary(_stack_one_chain(parameters_list[1:]),
                                   burn_frac=0.5)
        # burn-in and splitting leave few samples of a short trace
        low_n = len(parameters_list) - 1 < 20
        for r in rows:
            r["experiment_id"] = options["experiment_id"]
            r["low_sample"] = low_n
        tables.write_csv(os.path.join(
            out_dir, f"{options['experiment_id']}_convergence.csv"), rows)
        worst = max(r["rhat_rank"] for r in rows)
        if worst > 1.1:
            logger.warning(
                "fit %s: max rank-normalized split-R-hat %.3f > 1.1 — "
                "the chain is not stationary at this budget (see "
                "*_convergence.csv)", options["experiment_id"], worst)
    logger.info("fit %s: %d iterations", options["experiment_id"], it)
    return sampler


def _stack_one_chain(parameters_list):
    """One chain's list of parameters as a ``[1, n, ...]`` trace (the
    chain axis of each entry dropped), the multichain trace's layout."""
    return params_map(lambda *xs: np.stack([x[0] for x in xs])[None],
                      *parameters_list)


def _iter_funcs(iter_type, options, step_kwargs):
    eps = options.get("epsilon", 0.1)
    step = {"SGLD": "sample_sgld", "SGRLD": "sample_sgrld",
            "SGD": "step_sgd", "ADAGRAD": "step_adagrad"}
    if iter_type in step:
        return ([step[iter_type], "project_parameters"],
                [dict(epsilon=eps, **step_kwargs), {}])
    if iter_type == "SCIR":
        # SGLD with the exact Gamma-process simplex update; the projection
        # is inside the step
        return (["sample_sgld_scir"], [dict(epsilon=eps, **step_kwargs)])
    if iter_type == "Gibbs":
        return (["sample_gibbs", "project_parameters"], [{}, {}])
    raise ValueError(f"Unrecognized iter_type {iter_type}")


def _save_fit_state(path, evaluator, sampler, parameters_list, times,
                    iteration):
    ckpt.save_pickle(path, dict(
        evaluator_state=ckpt.tree_to_numpy(evaluator.save_state()),
        generator_state=_generator_state(sampler),
        adagrad_state=_adagrad_state(sampler),
        parameters_list=parameters_list,
        times=times,
        iteration=iteration,
    ))


# --------------------------------------------------------------------------
# eval
# --------------------------------------------------------------------------

def _eval_params_list(args, trace, half_avg: bool = False,
                      burn_frac: float | None = None):
    """(parameters list, times) of a saved trace for --eval /
    --trace_eval.  ``--eval_chains pooled`` takes every chain of a
    multichain trace (each chain burned and half-averaged on its own, its
    times the last of the shared iteration times; a chain with nothing
    left adds no times); ``0`` the chain-0 view."""
    params_list = trace["parameters_list"]
    times = trace.get("times")
    if times is None:
        times = list(range(len(params_list)))
    mode = getattr(args, "eval_chains", "0")
    if mode == "pooled" and trace.get("chain_parameters") is not None:
        stacked = trace["chain_parameters"]       # leaves [C, n, ...]
        C = trace.get("num_chains") or getattr(
            stacked, dataclasses.fields(stacked)[0].name).shape[0]
        # the chains share the iteration times
        chain_times = list(times[1:]) if len(times) else []
        pooled, pooled_times = [], []
        for c in range(C):
            lst = _unstack_chain(stacked, c)
            if burn_frac:
                lst = lst[int(len(lst) * burn_frac):]
            if half_avg:
                lst = half_average_parameters_list(lst)
            pooled.extend(lst)
            pooled_times.extend(
                chain_times[len(chain_times) - len(lst):] if chain_times
                else range(len(lst)))
        return pooled, pooled_times
    if burn_frac:
        keep = int(len(params_list) * burn_frac)
        params_list = params_list[keep:]
        times = times[keep:]
    if half_avg:
        params_list = half_average_parameters_list(params_list)
    return params_list, times


def do_eval(args, options, target: str):
    """Offline evaluation over a saved trace; ``target`` in {train, test,
    half_avg_train, half_avg_test}."""
    p = _paths(args.path)
    data = ckpt.load_pickle(os.path.join(p["in"], "data.p"))
    trace = ckpt.load_trace(os.path.join(
        p["out"], "fit", f"{options['experiment_id']}_parameters.p"))
    params_list, times = _eval_params_list(
        args, trace, half_avg=target.startswith("half_avg"))
    obs_key = "observations" if target.endswith("train") else \
        "test_observations"
    sampler = _build_sampler(options, data, params_list[-1], args.device,
                             obs_key=obs_key)
    metric_fns = _metric_fns(options, data)
    metric_fns.append(mf.noisy_logjoint_loglike_metric(
        N=args.eval_N, subsequence_length=-1))
    if args.eval_predictive > 0:
        # held-out k-step predictive log-likelihood rows (the particle
        # filter's, slot 0 its log-likelihood; the HMMs' exact one); the
        # SLDS has none
        if not hasattr(sampler, "predictive_loglikelihood"):
            logger.info("model %s has no predictive loglikelihood; "
                        "skipping the predictive metric", options["model"])
        elif sampler.model.has_pf:
            metric_fns.append(mf.noisy_predictive_logjoint_loglike_metric(
                args.eval_predictive, kind="pf", N=args.eval_N))
        else:
            metric_fns.append(mf.noisy_predictive_logjoint_loglike_metric(
                args.eval_predictive, kind="marginal"))
    evaluator = OfflineEvaluator(
        sampler, [_to_sampler(sampler, q) for q in params_list], times,
        metric_functions=metric_fns)
    evaluator.evaluate(num_to_eval=args.num_to_eval)
    out_dir = ckpt.make_path(os.path.join(p["out"], "eval"))
    tables.write_csv(os.path.join(
        out_dir, f"{options['experiment_id']}_{target}_metrics.csv"),
        evaluator.metric_rows)
    logger.info("eval %s %s done", options["experiment_id"], target)


# --------------------------------------------------------------------------
# trace_eval: KSD + KS test
# --------------------------------------------------------------------------

# the KSD loop's checkpoint interval, in scores; a block of scores, the
# chains of one call, never crosses one
KSD_CHECKPOINT_EVERY = 20


def score_block(sampler, params_list, **grad_kwargs) -> list:
    """``sampler.noisy_gradient(**grad_kwargs)`` at each of ``params_list``
    (one chain's parameters each) from one call, the entries as its chains:
    independent scores, as a loop of calls gives them in law.  Returns one
    chain's gradient (NumPy) per entry."""
    stacked = params_map(lambda *xs: np.concatenate(xs, 0),
                         *[ckpt.tree_to_numpy(q) for q in params_list])
    sampler.parameters = _to_sampler(sampler, stacked)
    g = ckpt.tree_to_numpy(sampler.noisy_gradient(**grad_kwargs))
    return [params_map(lambda x: x[j:j + 1], g)
            for j in range(len(params_list))]


def do_eval_ksd(args, options):
    """The PF score (unscaled, the whole series) at each post-burn-in trace
    sample, then the IMQ KSD per natural coordinate.  The scores between
    two checkpoints run as the chains of one call; the accumulated scores,
    the cursor and the generator's state are saved every
    ``KSD_CHECKPOINT_EVERY`` scores, and a run resumes there.
    ``--ksd_passes`` cycles over the trace, averaging the scores."""
    p = _paths(args.path)
    data = ckpt.load_pickle(os.path.join(p["in"], "data.p"))
    trace = ckpt.load_trace(os.path.join(
        p["out"], "fit", f"{options['experiment_id']}_parameters.p"))
    params_list, _ = _eval_params_list(args, trace, burn_frac=1.0 / 3.0)
    if args.max_ksd_samples and len(params_list) > args.max_ksd_samples:
        idx = np.linspace(0, len(params_list) - 1,
                          args.max_ksd_samples).astype(int)
        params_list = [params_list[i] for i in idx]

    sampler = _build_sampler(options, data, params_list[0], args.device)
    # check_finite=False: no host read a call; non-finite scores surface
    # in the KSD
    grad_kwargs = dict(N=args.ksd_N, subsequence_length=-1,
                       is_scaled=False, check_finite=False)
    passes = getattr(args, "ksd_passes", 1) or 1
    state_path = os.path.join(p["scratch"],
                              f"ksd_{options['experiment_id']}_state.p")
    M = len(params_list)
    n_tasks = passes * M
    if os.path.exists(state_path):
        state = ckpt.load_pickle(state_path)
        grad_sums, cur = state["grad_sums"], state["cur_index"]
        _set_generator_state(sampler, state["generator_state"])
        logger.info("ksd %s: resuming at %d/%d",
                    options["experiment_id"], cur, n_tasks)
    else:
        grad_sums, cur = [None] * M, 0
    while cur < n_tasks:
        # a resumed run scores the same blocks
        stop = min(n_tasks,
                   (cur // KSD_CHECKPOINT_EVERY + 1) * KSD_CHECKPOINT_EVERY)
        tasks = range(cur, stop)
        grads = score_block(sampler, [params_list[t % M] for t in tasks],
                            **grad_kwargs)
        for t, g in zip(tasks, grads):
            i = t % M
            grad_sums[i] = g if grad_sums[i] is None else params_map(
                lambda a, b: a + b, grad_sums[i], g)
        cur = stop
        if cur % KSD_CHECKPOINT_EVERY == 0:
            ckpt.save_pickle(state_path, dict(
                grad_sums=grad_sums, cur_index=cur,
                generator_state=_generator_state(sampler)))
    grads = [params_map(lambda a: a / passes, g) for g in grad_sums]
    if os.path.exists(state_path):
        os.remove(state_path)
    variables = KSD_VARIABLES[options["model"]]
    nat = [convert_gradient(options["model"], q, g)
           for q, g in zip(params_list, grads)]
    ksd = compute_ksd([v for v, _ in nat], [g for _, g in nat], variables,
                      max_block_size=512, device=args.device)
    rows = [dict(metric="ksd", variable=v, value=val,
                 experiment_id=options["experiment_id"])
            for v, val in ksd.items()]
    out_dir = ckpt.make_path(os.path.join(p["out"], "trace_eval"))
    tables.write_csv(os.path.join(
        out_dir, f"{options['experiment_id']}_ksd.csv"), rows)
    logger.info("ksd %s: %s", options["experiment_id"], ksd)
    return ksd


def do_eval_ks_test(args, options, all_options):
    """KS two-sample test of each scalar parameter's trace against the
    first Gibbs experiment's trace."""
    from ..metrics.ks_test import ks_test_traces
    p = _paths(args.path)
    gibbs = [o for o in all_options if o.get("iter_type") == "Gibbs"]
    if not gibbs:
        logger.warning("no Gibbs reference run for KS test")
        return None
    ref_trace = ckpt.load_trace(os.path.join(
        p["out"], "fit", f"{gibbs[0]['experiment_id']}_parameters.p"))
    trace = ckpt.load_trace(os.path.join(
        p["out"], "fit", f"{options['experiment_id']}_parameters.p"))
    variables = KSD_VARIABLES[options["model"]]
    rows = ks_test_traces(trace["parameters_list"],
                          ref_trace["parameters_list"], variables)
    for r in rows:
        r["experiment_id"] = options["experiment_id"]
    out_dir = ckpt.make_path(os.path.join(p["out"], "trace_eval"))
    tables.write_csv(os.path.join(
        out_dir, f"{options['experiment_id']}_kstest.csv"), rows)
    return rows


# --------------------------------------------------------------------------
# process_out / make_plots
# --------------------------------------------------------------------------

def do_process_out(args, options_list):
    """Every per-experiment CSV (fit, eval, trace_eval; files in name
    order), each row with its ``source`` file, joined with the options on
    ``experiment_id`` into processed/aggregated.csv (columns in both
    suffixed ``_option``), as ``pd.concat`` and a left ``merge`` write
    it."""
    p = _paths(args.path)
    frames = []
    for sub in ["fit", "eval", "trace_eval"]:
        d = os.path.join(p["out"], sub)
        if not os.path.isdir(d):
            continue
        for fname in sorted(os.listdir(d)):
            if not fname.endswith(".csv"):
                continue
            t = tables.read_csv(os.path.join(d, fname))
            t.add_column("source", f"{sub}/{fname}")
            if "experiment_id" not in t.columns:
                t.add_column("experiment_id", int(fname.split("_")[0]))
            frames.append(t)
    if not frames:
        logger.warning("nothing to aggregate")
        return None
    agg = tables.merge_left(tables.concat(frames),
                            tables.from_rows(options_list), "experiment_id")
    tables.write_csv(os.path.join(p["processed"], "aggregated.csv"), agg)
    logger.info("aggregated %d rows", len(agg))
    return agg


def do_make_plots(args, options_list):
    """Metric-vs-time facet plots of processed/aggregated.csv (pandas and
    matplotlib, imported here)."""
    try:
        import matplotlib  # noqa: F401
        import pandas as pd
    except ImportError as e:
        raise SystemExit(f"--make_plots needs pandas and matplotlib: {e}. "
                         "Install them, or plot processed/aggregated.csv "
                         "elsewhere") from e
    from ..evaluation import plotting
    p = _paths(args.path)
    agg_path = os.path.join(p["processed"], "aggregated.csv")
    if not os.path.exists(agg_path):
        do_process_out(args, options_list)
    fig_dir = ckpt.make_path(os.path.join(p["processed"], "figures"))
    plotting.plot_aggregated_metrics(pd.read_csv(agg_path), fig_dir)


def do_make_scripts(args, options_list):
    """Shell scripts of the fit / eval / trace_eval / process_out phases,
    one driver line per experiment (``python -m`` the port's driver)."""
    from .script_builder import chain_scripts, script_builder
    p = _paths(args.path)
    common = dict(path=args.path, model=args.model)
    if args.device != "cuda":
        common["device"] = args.device
    all_scripts = []
    for phase, extra in [
            ("fit", dict(fit=True)),
            ("eval_train", dict(eval="half_avg_train")),
            ("eval_test", dict(eval="half_avg_test")),
            ("trace_eval", dict(trace_eval="ksd")),
    ]:
        arg_dicts = [dict(common, experiment_id=o["experiment_id"], **extra)
                     for o in options_list]
        all_scripts += script_builder(
            phase, DRIVER_MODULE, arg_dicts, p["scripts"],
            script_splits=args.script_splits)
    all_scripts += script_builder(
        "process_out", DRIVER_MODULE, [dict(common, process_out=True)],
        p["scripts"])
    chain_scripts("run_all", all_scripts, p["scripts"])
    logger.info("wrote %d scripts", len(all_scripts))
    return all_scripts


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

def build_parser():
    parser = argparse.ArgumentParser(
        description="sgmcmc_tpu_torch experiment driver",
        fromfile_prefix_chars="@")
    parser.add_argument("--path", default="./experiment")
    parser.add_argument("--model", default="svm",
                        choices=["svm", "svjm", "lgssm", "garch",
                                 "gauss_hmm", "arphmm", "slds"])
    parser.add_argument("--device", default="cuda",
                        help="where the samplers, scores and KSD run: the "
                             "card (default) or 'cpu'")
    parser.add_argument("--experiment_id", type=int, default=-1)
    parser.add_argument("--setup", action="store_true")
    parser.add_argument("--make_scripts", action="store_true")
    parser.add_argument("--fit", action="store_true")
    parser.add_argument("--eval", type=str, default=None,
                        choices=[None, "train", "test", "half_avg_train",
                                 "half_avg_test"])
    parser.add_argument("--trace_eval", type=str, default=None,
                        choices=[None, "ksd", "kstest"])
    parser.add_argument("--process_out", action="store_true")
    parser.add_argument("--make_plots", action="store_true")
    parser.add_argument("--T", type=int, default=1000)
    parser.add_argument("--T_test", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--init_methods", nargs="+",
                        default=["prior", "truth"])
    parser.add_argument("--max_time", type=float, default=None)
    parser.add_argument("--num_chains", type=int, default=1,
                        help="run C chains through fit_scan(num_chains=C) "
                             "in --fit, recording the stacked trace and "
                             "convergence rows (1: the single-chain loop)")
    parser.add_argument("--num_particle_devices", type=int, default=1,
                        help="shard each chain's particle filter over P "
                             "devices in --fit (fit_scan(n_particle_"
                             "devices=P), SGLD only): one process per "
                             "device, under torchrun --nproc_per_node")
    parser.add_argument("--island_fused", action="store_true",
                        help="with --num_particle_devices > 1: an "
                             "independent fused-window island filter of "
                             "N / P particles per device, averaged")
    parser.add_argument("--eval_chains", type=str, default="0",
                        choices=["0", "pooled"],
                        help="--eval/--trace_eval on a multichain trace: "
                             "'pooled' takes every chain's samples (burn-in "
                             "and half-averaging per chain), '0' chain 0's")
    parser.add_argument("--num_to_eval", type=int, default=20)
    parser.add_argument("--eval_N", type=int, default=1000)
    parser.add_argument("--eval_predictive", type=int, default=5,
                        help="k-step held-out predictive log-likelihood "
                             "rows in --eval; 0 disables")
    parser.add_argument("--ksd_N", type=int, default=1000)
    parser.add_argument("--max_ksd_samples", type=int, default=100)
    parser.add_argument("--ksd_passes", type=int, default=1,
                        help="cycling passes over the trace, averaging "
                             "the PF score noise")
    parser.add_argument("--script_splits", type=int, default=1)
    parser.add_argument("--no_resume", action="store_true")
    return parser


def _selected(options_list, experiment_id):
    if experiment_id == -1:
        return options_list
    return [o for o in options_list
            if o["experiment_id"] == experiment_id]


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(levelname)s: %(asctime)s - %(name)s: %(message)s ")
    args = build_parser().parse_args(argv)
    p = _paths(args.path)
    if int(os.environ.get("WORLD_SIZE", 1)) > 1 and not dist.is_initialized():
        from ..parallel.sharding import initialize_multi_host
        initialize_multi_host()       # under torchrun
    if dist.is_initialized() and _rank() != 0:
        # the other ranks join --fit's collectives; rank 0 does the rest
        args.setup = args.make_scripts = args.process_out = False
        args.make_plots, args.eval, args.trace_eval = False, None, None
    if args.setup:
        do_setup(args)
    if dist.is_initialized():
        dist.barrier()
    options_list = None
    opts_path = os.path.join(p["in"], "options.p")
    if os.path.exists(opts_path):
        options_list = ckpt.load_pickle(opts_path)
    needs_options = (args.make_scripts or args.fit or args.eval
                     or args.trace_eval or args.process_out
                     or args.make_plots)
    if needs_options and options_list is None:
        raise SystemExit(
            f"No experiment options at {opts_path}; run --setup first "
            f"(or pass the correct --path).")
    if args.make_scripts:
        do_make_scripts(args, options_list)
    if args.fit:
        for o in _selected(options_list, args.experiment_id):
            do_fit(args, o)
    if args.eval:
        for o in _selected(options_list, args.experiment_id):
            do_eval(args, o, args.eval)
    if args.trace_eval == "ksd":
        for o in _selected(options_list, args.experiment_id):
            do_eval_ksd(args, o)
    elif args.trace_eval == "kstest":
        for o in _selected(options_list, args.experiment_id):
            do_eval_ks_test(args, o, options_list)
    if args.process_out:
        do_process_out(args, options_list)
    if args.make_plots:
        do_make_plots(args, options_list)


if __name__ == "__main__":
    main()
