"""User-facing sampler classes (counterpart of the SGLD ``fit_scan`` path
of ``sgmcmc_tpu/inference/samplers.py``, with its multi-sequence samplers).

A :class:`Sampler` holds the model, the observations, the prior, the
parameters, a seeded ``torch.Generator`` and its ``device``: the card
unless the caller passes ``device="cpu"``.  Without a card the default
raises; it never falls back to the CPU.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..models.base import params_map
from ..models.registry import ModelAPI, get_model
from . import sgmcmc


class Sampler:
    """Stateful wrapper over the chain-batched SG-MCMC core."""

    def __init__(self, model: ModelAPI | str, observations=None, prior=None,
                 parameters=None, seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device={str(device)!r} needs a CUDA "
                               "card but no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        self.model = get_model(model) if isinstance(model, str) else model
        self.observations = None
        if observations is not None:
            obs = torch.as_tensor(np.asarray(observations) if not isinstance(
                observations, torch.Tensor) else observations)
            obs = obs.to(device=self.device, dtype=torch.float32)
            self.observations = obs[:, None] if obs.ndim == 1 else obs
        self.prior = (self.model.default_prior(device=self.device)
                      if prior is None else prior)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._cache: dict = {}
        self._num_chains: int | None = None
        # without explicit parameters, one projected prior draw (callers
        # such as the benchmark then overwrite it)
        self.parameters = (parameters if parameters is not None else
                           self.model.project_parameters(
                               self.model.sample_prior(self.prior,
                                                       self.generator, 1)))

    @property
    def parameters(self):
        return self._parameters

    @parameters.setter
    def parameters(self, params):
        self._parameters = params.to(self.device)

    @property
    def T(self) -> int:
        return int(self.observations.shape[0])

    def _score_config(self, **kwargs) -> sgmcmc.PFScoreConfig:
        return sgmcmc.PFScoreConfig(
            n_particles=kwargs.get("N", kwargs.get("n_particles", 1000)),
            subsequence_length=kwargs.get("subsequence_length", -1),
            buffer_length=kwargs.get("buffer_length", 0),
            minibatch_size=kwargs.get("minibatch_size", 1),
            smoother=kwargs.get("pf", kwargs.get("smoother", "poyiadjis_N")),
            resampler=kwargs.get("resampler", "multinomial"),
            resample_mode=kwargs.get("resample_mode", "auto"),
            lambduh=kwargs.get("lambduh", 0.95),
            partition_style=kwargs.get("partition_style", "uniform"),
            ess_threshold=kwargs.get("ess_threshold", None),
            bw_chunk=kwargs.get("bw_chunk", None),
            rng=kwargs.get("rng", "host"),
        )

    def _grad_fn(self, kind: str | None = None, **kwargs):
        """The noisy-gradient function of the particle-filter score
        (``kind=None`` or ``"pf"``).  The JAX package's exact message
        passing kinds are not ported yet and raise."""
        if kind in ("marginal", "complete"):
            raise NotImplementedError(
                f"kind={kind!r} (the exact message-passing score) is not "
                "ported yet (ROADMAP.md, Queue 1 item 12); the port runs "
                "kind='pf'")
        if kind not in (None, "pf"):
            raise ValueError(f"Unrecognized kind = '{kind}'")
        m = self.model
        cfg = self._score_config(**kwargs)
        kernel_name = kwargs.get("kernel")
        key = ("grad", cfg, kernel_name, self.T, self._score_key(**kwargs))
        if key not in self._cache:
            score = self._make_score(cfg, kernel_name, **kwargs)
            self._cache[key] = sgmcmc.make_noisy_grad_fn(
                score, lambda p: m.grad_logprior(self.prior, p), self.T)
        return self._cache[key]

    def _score_key(self, **kwargs):
        """What else than the config and kernel selects the score."""
        return None

    def _make_score(self, cfg: sgmcmc.PFScoreConfig, kernel_name,
                    **kwargs) -> sgmcmc.PFScore:
        m = self.model
        return sgmcmc.make_pf_score_fn(
            m.get_kernel(kernel_name), m.grad_statistic,
            m.grad_statistic_dim, m.unpack_grad, cfg, self.T,
            prior_mean_var_fn=m.prior_mean_var,
            fused_model=m.get_fused(kernel_name) if m.get_fused else None)

    # -- multi-chain plumbing ----------------------------------------------
    def _chain_init_params(self, num_chains: int, chain_init):
        """Initial [C, ...] parameters: a stacked parameter object (used
        as-is), ``"prior"`` (C independent prior draws) or ``"replicate"``
        (copies of the current parameters; continues the chains if the
        sampler already holds C of them)."""
        C = int(num_chains)
        if not isinstance(chain_init, str):
            if chain_init.num_chains != C:
                raise ValueError(
                    f"chain_init has {chain_init.num_chains} chains, "
                    f"expected num_chains={C}")
            params = chain_init
        elif chain_init == "replicate":
            if self._num_chains == C:
                return self.parameters
            if self._num_chains is not None:
                raise ValueError(
                    f"sampler holds {self._num_chains} stacked chains; "
                    f"cannot re-fit with num_chains={C}")
            params = params_map(
                lambda x: x.expand((C,) + x.shape[1:]).contiguous(),
                self.parameters)
        elif chain_init == "prior":
            m = self.model
            params = m.project_parameters(
                m.sample_prior(self.prior, self.generator, C))
        else:
            raise ValueError(f"Unrecognized chain_init '{chain_init}'")
        self._num_chains = C
        self.parameters = params
        return self.parameters

    @staticmethod
    def _record_plan(num_iters: int, steps_per_iteration: int, record):
        """(recorded iterations, steps per recorded iteration, output_all).

        A ``record`` interval that does not divide ``num_iters`` truncates
        the run to the largest multiple, with a warning."""
        if record == "none":
            return num_iters, steps_per_iteration, False
        thin = 1 if record == "all" else int(record)
        if thin < 1:
            raise ValueError(f"record={record!r} must be >= 1")
        if thin > num_iters:
            raise ValueError(f"record={record!r} exceeds num_iters="
                             f"{num_iters}: nothing would be recorded")
        n_rec = num_iters // thin
        if n_rec * thin != num_iters:
            warnings.warn(
                f"record={record!r} does not divide num_iters={num_iters}; "
                f"running {n_rec * thin} iterations", stacklevel=3)
        return n_rec, steps_per_iteration * thin, True

    def fit_scan(self, iter_type: str, num_iters: int, epsilon: float = 0.1,
                 steps_per_iteration: int = 1, num_chains: int | None = None,
                 chain_init="replicate", record="all",
                 return_aux: bool = False, **kwargs):
        """Run an SGLD fit and return the parameter trace.

        ``num_chains=C`` runs C independent chains batched in every kernel;
        the trace has a leading chain axis ``[C, iters, ...]`` and the
        sampler then holds the stacked ``[C, ...]`` parameters.  Without
        ``num_chains`` the sampler's single chain runs and the trace is
        ``[iters, ...]``.  ``record`` is ``"all"``, an int k (keep every
        k-th iterate) or ``"none"`` (trace None).  ``return_aux=True`` also
        returns the per-iteration log-likelihoods ``[C, iters]``.
        """
        if iter_type != "SGLD":
            raise NotImplementedError(
                f"fit_scan supports SGLD so far, not '{iter_type}'")
        m, T = self.model, self.T
        n_rec, steps, output_all = self._record_plan(
            num_iters, steps_per_iteration, record)
        grad_fn = self._grad_fn(**kwargs)

        def step(gen, params, obs):
            return sgmcmc.sgld_step(gen, params, obs, grad_fn, epsilon, T)

        params0 = (self.parameters if num_chains is None else
                   self._chain_init_params(int(num_chains), chain_init))
        params, trace, aux = sgmcmc.fit(
            self.generator, params0, self.observations, step, n_rec,
            project_fn=m.project_parameters, steps_per_iter=steps,
            output_all=output_all)
        self.parameters = params
        if num_chains is None:
            aux = aux[0]
            if trace is not None:
                trace = params_map(lambda x: x[0], trace)
        return (trace, aux) if return_aux else trace


class SVMSampler(Sampler):
    def __init__(self, observations=None, **kw):
        super().__init__("svm", observations, **kw)


class GARCHSampler(Sampler):
    def __init__(self, observations=None, **kw):
        super().__init__("garch", observations, **kw)


class SVJMSampler(Sampler):
    """Stochastic-volatility jump model; its EP proposals are not ported
    yet (ROADMAP.md, Queue 1 item 10)."""
    def __init__(self, observations=None, **kw):
        super().__init__("svjm", observations, **kw)


class LGSSMSampler(Sampler):
    """Scalar linear-Gaussian state-space model (n = m = 1).  The JAX
    package's Gibbs mixin is not ported yet (ROADMAP.md, Queue 1 item
    12)."""
    def __init__(self, observations=None, **kw):
        super().__init__("lgssm", observations, **kw)


def pack_sequences(sequences):
    """List of ``[T_i, ...]`` arrays or tensors -> (padded
    ``[n_seq, T_max, ...]`` tensor, zero beyond each length; lengths
    ``[n_seq]`` int64 numpy)."""
    arrays = [np.asarray(s.detach().cpu() if isinstance(s, torch.Tensor)
                         else s) for s in sequences]
    lengths = np.array([a.shape[0] for a in arrays], np.int64)
    packed = np.zeros((len(arrays), int(lengths.max())) + arrays[0].shape[1:],
                      dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        packed[i, :a.shape[0]] = a
    return torch.from_numpy(packed), lengths


class SeqSampler(Sampler):
    """Multi-sequence sampler: the observations are a list of sequences,
    and each gradient subsamples ``num_sequences`` of them (-1: all) and a
    subsequence within each (:class:`~.sgmcmc.SeqPFScore`).  ``T`` is the
    total length.  The predict surface and the exact log-likelihoods are
    not ported yet (ROADMAP.md, Queue 1 item 12)."""

    def __init__(self, model, observations: list, num_sequences: int = -1,
                 **kw):
        packed, lengths = pack_sequences(observations)
        self.lengths = lengths
        self.num_sequences = num_sequences
        super().__init__(model, packed[..., None] if packed.ndim == 2
                         else packed, **kw)

    @property
    def T(self) -> int:
        return int(self.lengths.sum())

    def _score_key(self, **kwargs):
        return kwargs.get("num_sequences", self.num_sequences)

    def _make_score(self, cfg: sgmcmc.PFScoreConfig, kernel_name,
                    **kwargs) -> sgmcmc.SeqPFScore:
        m = self.model
        return sgmcmc.make_seq_pf_score_fn(
            m.get_kernel(kernel_name), m.grad_statistic,
            m.grad_statistic_dim, m.unpack_grad, cfg, self.lengths,
            num_sequences=self._score_key(**kwargs),
            prior_mean_var_fn=m.prior_mean_var,
            fused_model=m.get_fused(kernel_name) if m.get_fused else None)


class SeqSVMSampler(SeqSampler):
    def __init__(self, observations, **kw):
        super().__init__("svm", observations, **kw)


class SeqSVJMSampler(SeqSampler):
    def __init__(self, observations, **kw):
        super().__init__("svjm", observations, **kw)


class SeqGARCHSampler(SeqSampler):
    def __init__(self, observations, **kw):
        super().__init__("garch", observations, **kw)


class SeqLGSSMSampler(SeqSampler):
    def __init__(self, observations, **kw):
        super().__init__("lgssm", observations, **kw)
