"""The port's unfused buffered particle smoothers and the default
multinomial fit_scan path against the JAX package.

The JAX ``run_buffered_pf`` runs with ``resample_mode="auto"``, which on
the CPU resamples through ``resample_apply`` -> gather (searchsorted
side='right'), the port's selection.  The draws it consumes (initial
normals, per-step resampling uniforms and proposal normals) are rebuilt
from its keys and fed to the port.  Tolerances as for the fused window's
plain path: statistic rtol=atol=1e-4, loglik rtol 1e-5 (float32 rounding,
the two CDFs are accumulated in different orders).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgmcmc_tpu.models import svm as jsvm
from sgmcmc_tpu.ops import buffered as jbuffered
from sgmcmc_tpu.ops import subsequence as jsub
from sgmcmc_tpu_torch.inference import sgmcmc
from sgmcmc_tpu_torch.inference.samplers import Sampler, SVMSampler
from sgmcmc_tpu_torch.models import registry, svm
from sgmcmc_tpu_torch.ops import buffered
from sgmcmc_tpu_torch.ops.cuda import fused_pf, resample

torch.set_num_threads(1)

CHAINS = [(0.8, 0.6, 1.1), (0.5, 1.2, 0.8)]
FIELDS = ("A", "LQinv_vec", "LRinv_vec")
N, W = 64, 12


def stacked(ps):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ps)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def jax_draws(scheme, n, steps, key):
    """The draws run_buffered_pf consumes from ``key`` (resample_apply
    path): z0 [n], uniforms [steps] or [steps, n], proposal normals
    [steps, n]."""
    key_init, key_steps = jax.random.split(key)
    z0 = jax.random.normal(key_init, (n, 1), jnp.float32)[:, 0]

    def step(k):
        kr, kp = jax.random.split(k)
        shape = () if scheme == "systematic" else (n,)
        return (jax.random.uniform(kr, shape, jnp.float32),
                jax.random.normal(kp, (n, 1), jnp.float32)[:, 0])

    u, z = jax.vmap(step)(jax.random.split(key_steps, steps))
    return z0, u, z


def windows(seed, C):
    """Observations and step weights [C, W] (two buffer steps)."""
    rng = np.random.default_rng(seed)
    ys = (np.exp(0.5 * rng.standard_normal((C, W)))
          * rng.standard_normal((C, W))).astype(np.float32)
    w = rng.uniform(1.0, 3.0, (C, W)).astype(np.float32)
    w[:, :2] = 0.0
    return ys, w


@functools.lru_cache(maxsize=None)
def jax_pf(cfg):
    """JAX run_buffered_pf over chains, compiled once per config."""
    return jax.jit(jax.vmap(
        lambda k, p, y, sw, v: jbuffered.run_buffered_pf(
            jsvm.KERNEL, jsvm.grad_statistic, p, y[:, None], key=k,
            n_particles=N, statistic_dim=3, step_weights=sw,
            in_window=(sw > 0).astype(sw.dtype), prior_mean=0.0,
            prior_var=v, **dict(cfg))))


def jax_run(cfg, keys, jps, ys, w, pv):
    out = jax_pf(tuple(sorted(cfg.items())))(
        keys, stacked(jps), jnp.asarray(ys), jnp.asarray(w),
        jnp.asarray(pv))
    return np.array(out.mean_statistic), np.array(out.loglikelihood)


def port_run(cfg, draws, params, ys, w, pv):
    z0, u, z = (torch.from_numpy(np.array(a)) for a in draws)
    t = torch.from_numpy
    resample_mode = cfg.pop("resample_mode")
    out = buffered.run_buffered_pf(
        svm.KERNEL, svm.grad_statistic, params, t(ys)[..., None],
        z0=z0[:, None], normals=z[:, :, None], u=u, statistic_dim=3,
        step_weights=t(w), in_window=(t(w) > 0).float(),
        prior_mean=torch.zeros(len(ys)), prior_var=t(pv), **cfg)
    cfg["resample_mode"] = resample_mode
    return out.mean_statistic.numpy(), out.loglikelihood.numpy()


def compare(smoother, resampler, *, seed=0, mode="auto", rtol=1e-4,
            atol=1e-4, ll_rtol=1e-5, **extra):
    C = len(CHAINS)
    jps = [jsvm.from_scalars(*c) for c in CHAINS]
    pv = np.array([float(jsvm.stationary_variance(p)) for p in jps],
                  np.float32)
    ys, w = windows(seed, C)
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    cfg = dict(smoother=smoother, resampler=resampler, resample_mode=mode,
               **extra)
    want_stat, want_ll = jax_run(cfg, keys, jps, ys, w, pv)
    draws = jax.vmap(lambda k: jax_draws(resampler, N, W, k))(keys)
    params = svm.SVMParams(*[torch.cat([getattr(svm.params_from_jax(p), f)
                                        for p in jps]) for f in FIELDS])
    got_stat, got_ll = port_run(cfg, draws, params, ys, w, pv)
    assert np.isfinite(got_stat).all() and np.isfinite(got_ll).all()
    np.testing.assert_allclose(got_stat, want_stat, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got_ll, want_ll, rtol=ll_rtol)


@pytest.mark.parametrize("resampler", ["multinomial", "stratified"])
@pytest.mark.parametrize("smoother,extra", [
    ("poyiadjis_N", {}),
    ("nemeth", {"lambduh": 0.95}),
    ("poyiadjis_N2", {}),
    ("poyiadjis_N2", {"bw_chunk": 16}),
    ("filter", {}),
    ("filter", {"logsumexp_mode": True}),
], ids=["poyiadjis_N", "nemeth", "poyiadjis_N2", "poyiadjis_N2-chunk",
        "filter", "filter-logsumexp"])
def test_unfused_smoother_matches_jax(smoother, extra, resampler):
    compare(smoother, resampler, **extra)


def test_transition_density_matches_jax():
    """The SVM transition density and its maximum, which the O(N^2)
    smoother's backward weights use, on the same particle pairs."""
    rng = np.random.default_rng(5)
    x_t = rng.standard_normal((2, 7, 1)).astype(np.float32)
    x_next = rng.standard_normal((2, 7, 1)).astype(np.float32)
    jps = [jsvm.from_scalars(*c) for c in CHAINS]
    params = svm.SVMParams(*[torch.cat([getattr(svm.params_from_jax(p), f)
                                        for p in jps]) for f in FIELDS])
    got = svm.KERNEL.prior_log_density(params, torch.from_numpy(x_t),
                                       torch.from_numpy(x_next))
    got_max = svm.KERNEL.prior_log_density_max(params)
    for c, p in enumerate(jps):
        np.testing.assert_allclose(
            got[c].numpy(), np.asarray(jsvm.KERNEL.prior_log_density(
                p, jnp.asarray(x_t[c]), jnp.asarray(x_next[c]))),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            float(got_max[c]),
            float(jsvm.KERNEL.prior_log_density_max(p)), rtol=1e-6)


def test_ess_gate_matches_jax():
    compare("poyiadjis_N", "stratified", seed=1, ess_threshold=0.5)


def test_two_level_arithmetic_within_bf16_bound():
    """Against the JAX two-level kernel's arithmetic (``xla2``: values
    through bf16 hi/lo pieces) at that kernel's bound, 2e-3."""
    compare("poyiadjis_N", "multinomial", seed=2, mode="xla2", rtol=2e-3,
            atol=2e-3, ll_rtol=2e-3)


def test_sgld_step_matches_jax_composition_multinomial():
    """One SGLD step of the port's default configuration (multinomial,
    Poyiadjis O(N)) on the draws JAX's score consumes, against the step
    composed from JAX's run_buffered_pf, grad_logprior and the same
    Langevin noise."""
    T, S, B, eps = 40, 8, 2, 0.1
    Wd = S + 2 * B
    C = len(CHAINS)
    ys, _ = jsvm.generate_data(jax.random.PRNGKey(0),
                               jsvm.from_scalars(0.9, 0.5, 1.0), T)
    ys = np.array(ys, np.float32)
    start = np.array([5, 30])
    rng = np.random.default_rng(0)
    noise = {f: rng.standard_normal(s).astype(np.float32)
             for f, s in zip(FIELDS, [(C, 1, 1), (C, 1), (C, 1)])}
    jps = [jsvm.from_scalars(*c) for c in CHAINS]
    jprior = jsvm.default_prior()
    keys = jax.random.split(jax.random.PRNGKey(9), C)

    win, sws = [], []
    for st in start:
        ws = int(np.clip(st - B, 0, T - Wd))
        sw, _ = jbuffered.window_weights(
            st - ws, st - ws + S, jsub.subsequence_weights(st, S, T), Wd)
        win.append(ys[ws:ws + Wd, 0])
        sws.append(np.array(sw, np.float32))
    pv = np.array([float(jsvm.stationary_variance(p)) for p in jps],
                  np.float32)
    jstat, jll = jax_run(dict(smoother="poyiadjis_N", resampler="multinomial",
                              resample_mode="auto"),
                         keys, jps, np.stack(win), np.stack(sws), pv)
    z0, u, z = (np.array(a) for a in jax.vmap(
        lambda k: jax_draws("multinomial", N, Wd, k))(keys))
    want = []
    for c, p in enumerate(jps):
        jg = jsvm.unpack_grad(jstat[c])
        jgp = jsvm.grad_logprior(jprior, p)
        jgrad = jax.tree_util.tree_map(lambda a, b: (a + b) / T, jg, jgp)
        jnew = jsvm.project_parameters(jax.tree_util.tree_map(
            lambda q, g, n: q + eps * g + np.sqrt(2 * eps) * (
                np.sqrt(1.0 / T) * n), p, jgrad,
            jsvm.SVMParams(**{f: v[c] for f, v in noise.items()})))
        want.append((jgrad, jnew, float(jll[c])))

    t = torch.from_numpy
    cfg = sgmcmc.PFScoreConfig(n_particles=N, subsequence_length=S,
                               buffer_length=B)
    assert cfg.resampler == "multinomial"
    score = sgmcmc.make_pf_score_fn(
        svm.KERNEL, svm.grad_statistic, 3, svm.unpack_grad, cfg, T,
        prior_mean_var_fn=registry.SVM.prior_mean_var,
        fused_model=svm.FUSED)
    prior = svm.default_prior()
    grad_fn = sgmcmc.make_noisy_grad_fn(
        score, lambda p: svm.grad_logprior(prior, p), T)
    draws = sgmcmc.WindowDraws(t(start), t(z0)[:, None], t(z)[:, :, None],
                               t(u))
    params = svm.SVMParams(*[torch.cat([getattr(svm.params_from_jax(p), f)
                                        for p in jps]) for f in FIELDS])
    obs = t(ys)
    grad, _ = grad_fn(None, params, obs, draws)
    new, ll = sgmcmc.sgld_step(None, params, obs, grad_fn, eps, T,
                               draws=draws, noise=svm.SVMParams(
                                   **{f: t(v) for f, v in noise.items()}))
    new = svm.project_parameters(new)
    for c, (jgrad, jnew, jll) in enumerate(want):
        for f in FIELDS:
            np.testing.assert_allclose(getattr(grad, f)[c].numpy(),
                                       getattr(jgrad, f), rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(getattr(new, f)[c].numpy(),
                                       getattr(jnew, f), rtol=1e-4,
                                       atol=1e-6)
        np.testing.assert_allclose(float(ll[c]), jll, rtol=1e-5)


@pytest.mark.parametrize("kw", [
    {},
    {"pf": "nemeth"},
    {"pf": "poyiadjis_N2", "bw_chunk": 8},
    {"pf": "filter"},
    {"resampler": "stratified", "ess_threshold": 0.5},
], ids=["default", "nemeth", "poyiadjis_N2", "filter", "stratified-ess"])
def test_fit_scan_unfused_on_cpu(kw):
    """The public fit_scan on the JAX package's defaults (multinomial,
    Poyiadjis O(N)) and the other unfused smoothers: finite traces, no
    kernel launched for CPU tensors."""
    ys, _ = jsvm.generate_data(jax.random.PRNGKey(2),
                               jsvm.from_scalars(0.9, 0.5, 1.0), 40)
    s = SVMSampler(observations=np.array(ys, np.float32), seed=0,
                   device="cpu")
    s.parameters = svm.from_scalars(0.5, 1.0, 2.0)
    launches = (resample.resample_apply.launches,
                fused_pf.fused_window.launches)
    trace, aux = s.fit_scan("SGLD", num_iters=2, epsilon=0.1, num_chains=3,
                            return_aux=True, N=32, subsequence_length=8,
                            buffer_length=2, **kw)
    assert trace.A.shape == (3, 2, 1, 1) and aux.shape == (3, 2)
    for leaf in (trace.A, trace.LQinv_vec, trace.LRinv_vec, aux):
        assert bool(torch.isfinite(leaf).all())
    assert (resample.resample_apply.launches,
            fused_pf.fused_window.launches) == launches


def test_sampler_without_card_raises(monkeypatch):
    """The default device is the card; without one the sampler raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Sampler("svm", observations=np.zeros((10, 1)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SVMSampler(observations=np.zeros((10, 1)), seed=1)
