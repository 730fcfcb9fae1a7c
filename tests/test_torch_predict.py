"""The port's predict surface against the JAX package: the buffered
smoother's elementwise, fixed-lag and save_all modes, the models' moment
maps and predictive statistics, the LGSSM's exact predict functions, the
samplers' ``predict`` / ``predictive_loglikelihood`` (one series and the
padded multi-sequence program) and their contract.

The draws JAX takes from its keys are rebuilt and fed to the port.  JAX
runs the elementwise modes in its gather mode, whose inverse CDF searches
``side="left"`` on a CDF normalised before its sum; the port searches
``side="right"`` on its float64 CDF.  The two differ only at exact ties
(and at CDF near-ties within float32 rounding), which these continuous
inputs meet with probability ~0.  Multinomial resampling there agrees in
law only (JAX draws Gumbel-max categoricals), so the parity cases use
the stratified and systematic resamplers; the predictive filter runs
JAX's resample-apply route, the port's selection, and so takes JAX's
multinomial draws.  The JAX side's predictive statistics run with
x64 off, as the JAX package runs (tests/conftest.py turns it on, and the
SVM's statistic then leaves float32).  Tolerances: float32 statistics
rtol = atol = 1e-4,
log-likelihoods rtol 1e-5, the moment maps rtol 1e-6, the float64 exact
functions 1e-10; the particle filter against the Kalman smoother with the
tolerances of ``tests/test_pf_predict_surface.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgmcmc_tpu.models import garch as jgarch
from sgmcmc_tpu.models import lgssm as jlgssm
from sgmcmc_tpu.models import svjm as jsvjm
from sgmcmc_tpu.models import svm as jsvm
from sgmcmc_tpu.ops import buffered as jbuffered
from sgmcmc_tpu_torch.inference import samplers
from sgmcmc_tpu_torch.models import garch, lgssm, registry, svjm, svm
from sgmcmc_tpu_torch.ops import buffered

torch.set_num_threads(1)

jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
N, W = 64, 12
SVM_CHAINS = [(0.8, 0.6, 1.1), (0.5, 1.2, 0.8)]
F32 = dict(rtol=1e-4, atol=1e-4)
F64 = dict(rtol=1e-10, atol=1e-10)


def stacked(ps):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *ps)


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


@functools.partial(jit, static_argnums=(0, 1, 2, 3))
def jax_draws(scheme, n, steps, Z, key):
    """The draws of JAX's run_buffered_pf from ``key`` in the port's layout:
    z0 [Z, n], uniforms [steps] or [steps, n], normals [steps, Z, n]."""
    key_init, key_steps = jax.random.split(key)
    z0 = jax.random.normal(key_init, (n, 1), jnp.float32).T

    def step(k):
        kr, kp = jax.random.split(k)
        shape = () if scheme == "systematic" else (n,)
        return (jax.random.uniform(kr, shape, jnp.float32),
                jax.random.normal(kp, (n, 1), jnp.float32).T)

    u, z = jax.vmap(step)(jax.random.split(key_steps, steps))
    return z0, u, z


def windows(seed, C, T=W):
    """Observations [C, T] and step weights (two buffer steps)."""
    rng = np.random.default_rng(seed)
    ys = (np.exp(0.5 * rng.standard_normal((C, T)))
          * rng.standard_normal((C, T))).astype(np.float32)
    w = rng.uniform(1.0, 3.0, (C, T)).astype(np.float32)
    w[:, :2] = 0.0
    return ys, w


def svm_inputs():
    jps = [jsvm.from_scalars(*c) for c in SVM_CHAINS]
    pv = np.array([float(jsvm.stationary_variance(p)) for p in jps],
                  np.float32)
    return jps, svm.params_from_jax(stacked(jps)), pv


@functools.lru_cache(maxsize=None)
def jax_pf(cfg):
    """JAX run_buffered_pf with the SVM's sufficient statistic over
    chains."""
    cfg = dict(cfg)
    use_valid = cfg.pop("valid", False)

    def one(k, p, y, sw, v, valid):
        return jbuffered.run_buffered_pf(
            jsvm.KERNEL, jsvm.suff_statistic, p, y[:, None], key=k,
            n_particles=N, statistic_dim=3, step_weights=sw,
            in_window=(sw > 0).astype(sw.dtype), prior_mean=0.0,
            prior_var=v, window_length=W,
            step_valid=valid if use_valid else None, **cfg)
    return jit(jax.vmap(one))


# (smoother, resampler, modes): elementwise smoothers and the filter,
# fixed-lag, save_all, each with and without the step validity gate
CASES = [
    ("poyiadjis_N", "stratified", dict(elementwise=True)),
    ("poyiadjis_N", "systematic", dict(elementwise=True, valid=True)),
    ("filter", "stratified", dict(elementwise=True)),
    ("nemeth", "systematic", dict(elementwise=True, valid=True)),
    ("poyiadjis_N2", "stratified", dict(elementwise=True)),
    ("poyiadjis_N", "systematic", dict(elementwise=True, fixed_lag=3,
                                        valid=True)),
    ("poyiadjis_N", "stratified", dict(elementwise=True, save_all=True)),
]


@pytest.mark.parametrize("smoother,resampler,modes", CASES,
                         ids=["smooth-strat", "smooth-sys-valid",
                              "filter-strat", "nemeth-sys-valid",
                              "n2-strat", "fixed-lag-sys-valid",
                              "save-all-strat"])
def test_buffered_modes_match_jax(smoother, resampler, modes):
    C = len(SVM_CHAINS)
    jps, params, pv = svm_inputs()
    ys, w = windows(1, C)
    if modes.get("fixed_lag"):
        w = np.ones_like(w)          # the predict surface's window
    valid = np.ones((C, W), np.float32)
    valid[1, W - 4:] = 0.0           # a padded tail on chain 1
    keys = jax.random.split(jax.random.PRNGKey(7), C)
    cfg = dict(smoother=smoother, resampler=resampler, **modes)
    want = jax_pf(tuple(sorted(cfg.items())))(
        keys, stacked(jps), jnp.asarray(ys), jnp.asarray(w), jnp.asarray(pv),
        jnp.asarray(valid))
    z0, u, z = (t(a) for a in jax.vmap(
        lambda k: jax_draws(resampler, N, W, 1, k))(keys))
    got = buffered.run_buffered_pf(
        svm.KERNEL, svm.suff_statistic, params, t(ys)[..., None], z0=z0,
        normals=z, u=u, statistic_dim=3, step_weights=t(w),
        in_window=(t(w) > 0).float(), prior_mean=torch.zeros(C),
        prior_var=t(pv), smoother=smoother, resampler=resampler,
        window_length=W, step_valid=t(valid) if modes.get("valid") else None,
        **{k: v for k, v in modes.items() if k != "valid"})
    if modes.get("save_all"):
        (want, want_saved), (got, got_saved) = want, got
        for f in ("statistics", "log_weights", "particles", "loglik"):
            np.testing.assert_allclose(
                getattr(got_saved, f).transpose(0, 1).numpy(),
                np.asarray(getattr(want_saved, f)), **F32, err_msg=f)
        assert got_saved.statistics.shape == (W, C, N, 3 * W)
    assert got.mean_statistic.shape == (C, 3 * W)
    np.testing.assert_allclose(got.mean_statistic.numpy(),
                               np.asarray(want.mean_statistic), **F32)
    np.testing.assert_allclose(got.loglikelihood.numpy(),
                               np.asarray(want.loglikelihood), rtol=1e-5)


def test_buffered_mode_errors():
    """The JAX package's ValueErrors; a non-finite statistic stays in its
    own slot (the named exception: JAX's one-hot product spreads it)."""
    jps, params, pv = svm_inputs()
    ys, w = windows(2, 2)
    gen = torch.Generator().manual_seed(2)
    common = dict(z0=torch.randn(2, 1, 8, generator=gen),
                  normals=torch.randn(2, W, 1, 8, generator=gen),
                  u=torch.rand(2, W, 8, generator=gen), statistic_dim=3,
                  step_weights=t(w), prior_mean=torch.zeros(2),
                  prior_var=t(pv))
    run = functools.partial(buffered.run_buffered_pf, svm.KERNEL,
                            svm.suff_statistic, params, t(ys)[..., None],
                            **common)
    with pytest.raises(ValueError, match="window_length"):
        run(elementwise=True)
    with pytest.raises(ValueError, match="elementwise smoother"):
        run(fixed_lag=2)
    with pytest.raises(ValueError, match="elementwise smoother"):
        run(elementwise=True, window_length=W, fixed_lag=2,
            smoother="filter")
    with pytest.raises(ValueError, match="exclusive"):
        run(elementwise=True, window_length=W, fixed_lag=2, save_all=True)

    def nan_at_4(params, x_t, x_next, y_next, step):
        h = svm.suff_statistic(params, x_t, x_next, y_next, step)
        return h * (float("nan") if step == 4 else 1.0)
    out = buffered.run_buffered_pf(
        svm.KERNEL, nan_at_4, params, t(ys)[..., None], **common,
        smoother="filter", elementwise=True, window_length=W)
    slots = out.statistics.reshape(2, W, 3)
    assert bool(torch.isnan(slots[:, 2]).all())          # t1 = 2
    assert bool(torch.isfinite(slots[:, [0, 1, 3, 4]]).all())


# --------------------------------------------------------------------------
# the LGSSM: the particle filter against the Kalman smoother
# --------------------------------------------------------------------------

T_K = 120
LG = lgssm.from_scalars(0.8, 0.5, 0.3)


@functools.lru_cache(maxsize=None)
def lgssm_sampler():
    ys, _ = lgssm.generate_data(torch.Generator().manual_seed(3), LG, T_K)
    smp = samplers.LGSSMSampler(ys, device="cpu", seed=0)
    smp.parameters = LG
    return smp


def test_pf_y_distr_matches_kalman():
    smp = lgssm_sampler()
    ex_mean, ex_cov = smp.predict(target="y", kind="marginal")
    pf_mean, pf_cov = smp.predict(target="y", N=2000, pf="poyiadjis_N")
    assert pf_mean.shape == ex_mean.shape == (T_K, 1)
    assert pf_cov.shape == ex_cov.shape == (T_K, 1, 1)
    err = np.sqrt(np.mean((pf_mean - ex_mean) ** 2))
    assert err < 0.25 * np.sqrt(np.mean(ex_cov))
    assert np.corrcoef(pf_mean.ravel(), ex_mean.ravel())[0, 1] > 0.98


def test_pf_lag0_is_filtered():
    smp = lgssm_sampler()
    ex_mean, ex_cov = smp.predict(kind="marginal", lag=0)
    pf_mean, pf_cov = smp.predict(N=2000, lag=0)
    err = np.sqrt(np.mean((pf_mean - ex_mean) ** 2))
    assert err < 0.15 * np.sqrt(np.mean(ex_cov))
    assert np.all(pf_cov > 0)
    assert abs(np.mean(pf_cov) / np.mean(ex_cov) - 1.0) < 0.25


def test_pf_fixed_lag_matches_kalman():
    smp = lgssm_sampler()
    ex_mean, _ = smp.predict(kind="marginal", lag=3)
    fl_mean, _ = smp.predict(kind="marginal", lag=0)
    pf_mean, _ = smp.predict(N=2000, lag=3)
    err = np.sqrt(np.mean((pf_mean - ex_mean) ** 2))
    assert err < 0.2
    assert err < np.sqrt(np.mean((pf_mean - fl_mean) ** 2))


def test_pf_predictive_loglik_matches_exact_lag1():
    smp = lgssm_sampler()
    exact1 = smp.predictive_loglikelihood(kind="marginal", lag=1)
    outs = [smp.predictive_loglikelihood(num_steps_ahead=1, N=4000)
            for _ in range(3)]
    assert outs[0].shape == (2,)
    pf1 = float(np.mean([o[1] for o in outs]))
    assert abs(pf1 - exact1) < 0.02 * abs(exact1)


# --------------------------------------------------------------------------
# the models' predict functions
# --------------------------------------------------------------------------

def model_params(name):
    """(port module, JAX module, JAX params, port params) of one chain."""
    if name == "svm":
        jp = jsvm.from_scalars(0.8, 0.6, 1.1)
        return svm, jsvm, jp, svm.params_from_jax(jp)
    if name == "garch":
        jp = jgarch.from_alpha_beta_gamma(0.1, 0.6, 0.2, 0.5)
        return garch, jgarch, jp, garch.params_from_jax(jp)
    if name == "svjm":
        jp = jsvjm.from_scalars(0.9, 0.5, 1.0, 0.1, 2.0)
        return svjm, jsvjm, jp, svjm.params_from_jax(jp)
    jp = jlgssm.from_matrices(A=[[0.8]], C=[[1.2]], Q=[[0.5]], R=[[0.3]])
    jp = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jp)
    return lgssm, jlgssm, jp, lgssm.params_from_jax(jp)


@pytest.mark.parametrize("name", ["svm", "garch", "svjm", "lgssm"])
def test_moment_maps_match_jax(name):
    """latent_moments (GARCH also squared) and y_moments on the same
    statistics."""
    mod, jmod, jp, p = model_params(name)
    api = registry.get_model(name)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((9, 1)).astype(np.float32)
    stats = np.concatenate([x, x * x + 0.3, x ** 4 + 1.0], -1)
    ystats = stats[:, :api.y_statistic_dim]
    cases = [(mod.latent_moments, jmod.latent_moments, stats, {}),
             (mod.y_moments, jmod.y_moments, ystats, {})]
    if name == "garch":
        cases.append((mod.latent_moments, jmod.latent_moments, stats,
                       dict(squared=True)))
    for fn, jfn, st, kw in cases:
        got = fn(p, t(st)[None], **kw)
        want = jfn(jp, jnp.asarray(st), **kw)
        for g, w_ in zip(got, want):
            assert g.shape[1:] == w_.shape
            np.testing.assert_allclose(g[0].numpy(), np.asarray(w_),
                                       rtol=1e-6, atol=1e-7)


def jax_predictive_normals(name, K, n):
    """The draws of JAX's predictive statistic from its fixed base key, in
    the port's [K+1, N, 1] layout."""
    base = jax.random.PRNGKey(0)
    if name == "garch":
        keys = [jax.random.fold_in(jax.random.fold_in(base, k), 1)
                for k in range(K + 1)]
        return np.stack([np.asarray(jax.random.normal(
            kk, (n,), jnp.float32))[:, None] for kk in keys])
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(base, 7919 * k + 1), (n, 1), jnp.float32))
        for k in range(K + 1)])


@pytest.mark.parametrize("name", ["svm", "garch", "svjm", "lgssm"])
def test_predictive_statistic_matches_jax(name):
    """make_predictive_stat_fn on JAX's own base-key draws, at steps inside
    the series and within K of its (valid) end."""
    mod, jmod, jp, p = model_params(name)
    K, n, T = 3, 16, 10
    rng = np.random.default_rng(5)
    ys = rng.standard_normal((T, 1)).astype(np.float32)
    D = 2 if name == "garch" else 1
    x_t = rng.standard_normal((n, D)).astype(np.float32)
    x_next = rng.standard_normal((n, D)).astype(np.float32)
    if name == "garch":
        x_t[:, 1] = x_next[:, 1] = 0.4 + rng.uniform(size=n)
    normals = t(jax_predictive_normals(name, K, n))
    for valid_length in (None, 8):
        jfn = jmod.make_predictive_stat_fn(
            jnp.asarray(ys), K, valid_length=valid_length)
        fn = mod.make_predictive_stat_fn(
            t(ys)[None], K, normals,
            valid_length=None if valid_length is None
            else torch.tensor([valid_length]))
        for step in (0, 5, T - 2):
            with jax.enable_x64(False):     # the JAX package's float32
                want = jfn(jp, jnp.asarray(x_t), jnp.asarray(x_next),
                           jnp.asarray(ys[step]), jnp.int32(step))
            got = fn(p, t(x_t)[None], t(x_next)[None], t(ys[step])[None],
                     step)
            assert got.shape == (1, n, K + 1)
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


@jit
def jax_exact(jp, ys, key):
    """The JAX package's exact predict functions, in one compiled call."""
    S = 3
    key_x, key_eps = jax.random.split(key)

    def path_normals(k):
        k0, kx, ky = jax.random.split(k, 3)
        return (jax.random.normal(k0, (1,), jnp.float64),
                jax.random.normal(kx, (7, 1), jnp.float64),
                jax.random.normal(ky, (8, 1), jnp.float64))
    return dict(
        y_distr=[jlgssm.y_distr(jp, ys, lag=lag) for lag in (None, 0, 2)],
        simulate_distr=[jlgssm.simulate_distr(jp, 7, include_init=inc)
                        for inc in (True, False)],
        z=jax.random.normal(key_x, (S, 15, 1), jnp.float64),
        eps=jax.random.normal(key_eps, (S, 15, 1), jnp.float64),
        y_sample=jlgssm.y_sample(jp, key, ys, num_samples=S,
                                 distr="marginal", lag=1),
        latent=jlgssm.latent_var_sample(jp, key_x, ys, num_samples=S,
                                        distr="marginal"),
        path_normals=jax.vmap(path_normals)(jax.random.split(key, S)),
        paths=jlgssm.simulate_paths(jp, key, 7, num_samples=S))


def test_lgssm_exact_functions_match_jax():
    """y_distr and simulate_distr (float64, 1e-10); y_sample,
    simulate_paths and latent_var_sample(distr='marginal') on JAX's
    normals (1e-10)."""
    jp = jlgssm.from_matrices(A=[[0.8]], C=[[1.2]], Q=[[0.5]], R=[[0.3]],
                              dtype=jnp.float64)
    p = lgssm.params_from_jax(jp, torch.float64)
    rng = np.random.default_rng(6)
    ys = rng.standard_normal((15, 1))
    yt = t(ys, torch.float64)[None]
    want = jax_exact(jp, jnp.asarray(ys), jax.random.PRNGKey(8))
    for lag, w_lag in zip((None, 0, 2), want["y_distr"]):
        for got, w_ in zip(lgssm.y_distr(p, yt, lag=lag), w_lag):
            np.testing.assert_allclose(got[0].numpy(), np.asarray(w_), **F64)
    for inc, w_inc in zip((True, False), want["simulate_distr"]):
        got = lgssm.simulate_distr(p, 7, include_init=inc)
        for k in w_inc:
            np.testing.assert_allclose(got[k][0].numpy(),
                                       np.asarray(w_inc[k]), **F64)
    z, eps = (t(want[k], torch.float64)[None] for k in ("z", "eps"))
    got = lgssm.y_sample(p, None, yt, num_samples=3, distr="marginal", lag=1,
                         normals=z, eps=eps)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want["y_sample"]),
                               **F64)
    got = lgssm.latent_var_sample(p, None, yt, num_samples=3,
                                  distr="marginal", normals=z)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want["latent"]),
                               **F64)
    got = lgssm.simulate_paths(p, None, 7, num_samples=3, normals=tuple(
        t(d, torch.float64)[None] for d in want["path_normals"]))
    for k in want["paths"]:
        np.testing.assert_allclose(got[k][0].numpy(),
                                   np.asarray(want["paths"][k]), **F64)


# --------------------------------------------------------------------------
# the samplers end to end, on shared draws
# --------------------------------------------------------------------------

def share_draws(smp, draws, normals):
    """Feed the port's sampler the JAX side's draws (its own after
    them)."""
    it = iter(draws)
    smp._pf_draws = lambda *args: next(it, None) or type(smp)._pf_draws(
        smp, *args)
    smp._predictive_normals = lambda K, n: normals


@functools.lru_cache(maxsize=None)
def jax_predictive(name, K, n, rows):
    """The JAX samplers' PF predictive program (their
    ``predictive_loglikelihood``'s ``run``: the filter with the
    log-sum-exp statistic over padded rows, summed), compiled once:
    (statistics [K+1], loglik) from (params, observations [R, T, 1],
    lengths [R], key)."""
    jmod = {"svm": jsvm, "garch": jgarch}[name]

    def one(key, p, obs, T_i):
        T_max = obs.shape[0]
        out = jbuffered.run_buffered_pf(
            jmod.get_kernel(None),
            jmod.make_predictive_stat_fn(obs, K, valid_length=T_i), p, obs,
            key=key, n_particles=n, statistic_dim=K + 1, smoother="filter",
            logsumexp_mode=True, prior_mean=0.0,
            prior_var=jmod.stationary_variance(p), resample_mode="auto",
            step_valid=(jnp.arange(T_max) < T_i).astype(obs.dtype))
        return out.statistics, out.loglikelihood

    def run(p, obs, lengths, key):
        stats, lls = jax.vmap(lambda k, o, T_i: one(k, p, o, T_i))(
            jax.random.split(key, rows) if rows > 1 else key[None], obs,
            lengths)
        return stats.sum(0), lls.sum()
    return jit(run)


def jax_predictive_ll(name, K, n, jp, obs, key, lengths):
    """The JAX program's output as its samplers return it: slot 0 the
    log-likelihood."""
    obs = np.asarray(obs, np.float32)
    rows = obs.shape[0]
    lengths = np.asarray(lengths, np.int32)
    with jax.enable_x64(False):     # the JAX package's float32 statistic
        stats, ll = jax_predictive(name, K, n, rows)(
            jp, jnp.asarray(obs), jnp.asarray(lengths), key)
    out = np.array(stats)
    out[0] = float(ll)
    return out


@pytest.mark.parametrize("name", ["svm", "garch"])
def test_predictive_loglikelihood_matches_jax(name):
    """Sampler.predictive_loglikelihood end to end (slot 0 the filter's
    log-likelihood) against the JAX samplers' program on its key's
    draws."""
    mod, jmod, jp, p = model_params(name)
    K, n, T = 2, 32, 14
    rng = np.random.default_rng(9)
    ys = (0.5 * rng.standard_normal((T, 1))).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jax_predictive_ll(name, K, n, jp, ys[None], key, [T])
    z0, u, z = (t(a)[None] for a in jax_draws("multinomial", n, T, 1, key))
    smp = (samplers.SVMSampler if name == "svm"
           else samplers.GARCHSampler)(ys, device="cpu")
    smp.parameters = p
    share_draws(smp, [dict(z0=z0, normals=z, u=u, v=None)],
                t(jax_predictive_normals(name, K, n)))
    got = smp.predictive_loglikelihood(K, N=n)
    assert got.shape == want.shape == (K + 1,)
    np.testing.assert_allclose(got, want, rtol=1e-4)


SEQ_LENGTHS = (9, 14, 6)
JP_SEQ = jsvm.from_scalars(0.8, 0.6, 1.1)


def seq_case():
    """(padded sequences [3, T_max, 1], the port's SeqSVMSampler)."""
    rng = np.random.default_rng(10)
    seqs = [(np.exp(0.5 * rng.standard_normal((n, 1)))
             * rng.standard_normal((n, 1))).astype(np.float32)
            for n in SEQ_LENGTHS]
    padded = np.zeros((len(seqs), max(SEQ_LENGTHS), 1), np.float32)
    for i, sq in enumerate(seqs):
        padded[i, :len(sq)] = sq
    smp = samplers.SeqSVMSampler(seqs, device="cpu")
    smp.parameters = svm.params_from_jax(JP_SEQ)
    return padded, smp


def seq_draws(key, scheme, n, T_max, rows):
    keys = jax.random.split(key, rows)
    z0, u, z = (t(a) for a in jax.vmap(
        lambda k: jax_draws(scheme, n, T_max, 1, k))(keys))
    return dict(z0=z0, normals=z, u=u, v=None)


@functools.lru_cache(maxsize=None)
def jax_seq_predict(target, lag, n):
    """The JAX SeqSampler's padded PF predict program (its ``run``),
    compiled once: mean statistics [R, T_max * dim]."""
    stat_fn, dim = ((jsvm.suff_statistic, 3) if target == "latent"
                    else (jsvm.y_statistic, 1))

    def one(key, p, obs, T_i):
        T_max = obs.shape[0]
        return jbuffered.run_buffered_pf(
            jsvm.KERNEL, stat_fn, p, obs, key=key, n_particles=n,
            statistic_dim=dim, smoother="poyiadjis_N", prior_mean=0.0,
            prior_var=jsvm.stationary_variance(p), resampler="stratified",
            elementwise=True, window_length=T_max,
            fixed_lag=lag, step_valid=(jnp.arange(T_max) < T_i).astype(
                obs.dtype)).mean_statistic

    def run(p, obs, lengths, key):
        keys = jax.random.split(key, obs.shape[0])
        return jax.vmap(lambda k, o, T_i: one(k, p, o, T_i))(keys, obs,
                                                             lengths)
    return jit(run)


def test_seq_predict_matches_jax():
    """SeqSVMSampler.predict, one padded row per sequence, against the JAX
    SeqSampler's program on the same draws (smoothed latent; fixed-lag
    y), through the JAX moment maps."""
    padded, smp = seq_case()
    n, T_max = 32, max(SEQ_LENGTHS)
    lengths = jnp.asarray(SEQ_LENGTHS, jnp.int32)
    with pytest.raises(ValueError, match="Unrecognized target"):
        smp.predict(target="x")
    for target, lag in (("latent", None), ("y", 2)):
        key = jax.random.PRNGKey(12)
        stats = jax_seq_predict(target, lag, n)(
            JP_SEQ, jnp.asarray(padded), lengths, key)
        share_draws(smp, [seq_draws(key, "stratified", n, T_max, 3)], None)
        got = smp.predict(target=target, lag=lag, N=n,
                          resampler="stratified")
        moments = jsvm.latent_moments if target == "latent" \
            else jsvm.y_moments
        for i, ((gm, gc), T_i) in enumerate(zip(got, SEQ_LENGTHS)):
            wm, wc = moments(JP_SEQ, stats[i].reshape(T_max, -1)[:T_i])
            assert gm.shape == (T_i, 1) and gc.shape == (T_i, 1, 1)
            np.testing.assert_allclose(gm, np.asarray(wm), **F32)
            np.testing.assert_allclose(gc, np.asarray(wc), **F32)


def test_seq_predictive_loglikelihood_matches_jax():
    """The padded predictive program; with a subset, rescaled by T_total /
    T_chosen."""
    padded, smp = seq_case()
    n, K, T_max = 32, 2, max(SEQ_LENGTHS)
    key = jax.random.PRNGKey(13)
    want = jax_predictive_ll("svm", K, n, JP_SEQ, padded, key, SEQ_LENGTHS)
    share_draws(smp, [seq_draws(key, "multinomial", n, T_max, 3)],
                t(jax_predictive_normals("svm", K, n)))
    got = smp.predictive_loglikelihood(num_steps_ahead=K, N=n)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    sub = smp.predictive_loglikelihood(num_sequences=2, num_steps_ahead=K,
                                       N=n)
    assert sub.shape == (K + 1,) and np.isfinite(sub).all()


def test_predict_contract():
    """The JAX package's errors, one chain only (select_chain), the HMM
    branch pointing at its slice, the vector LGSSM's predict statistics,
    and the aliases."""
    ys, _ = svm.generate_data(torch.Generator().manual_seed(1),
                              svm.from_scalars(0.9, 0.5, 1.0), 12)
    smp = samplers.SVMSampler(ys, device="cpu")
    with pytest.raises(ValueError, match="'filter' for lag = 0"):
        smp.predict(N=8, lag=0, pf="poyiadjis_N")
    with pytest.raises(ValueError, match="not be 'filter'"):
        smp.predict(N=8, pf="filter")
    with pytest.raises(ValueError, match="Unrecognized target"):
        smp.predict(target="x")
    with pytest.raises(NotImplementedError, match="GARCH-only"):
        smp.predict(N=8, squared=True)
    with pytest.raises(NotImplementedError, match="PF path"):
        smp.predict(N=8, num_samples=2)
    with pytest.raises(NotImplementedError, match="slice 12"):
        smp.predict(kind="marginal")
    with pytest.raises(NotImplementedError, match="exact predictive"):
        smp.predictive_loglikelihood(kind="marginal")
    with pytest.raises(NotImplementedError, match="LGSSM"):
        smp.simulate(5, return_distr=True)
    for name in ("svm", "garch", "svjm"):
        m = registry.get_model(name)
        assert (m.latent_var_distr, m.y_distr, m.y_sample,
                m.simulate_distr, m.simulate_paths) == (None,) * 5
    mean, cov = smp.latent_var_distr(N=8, lag=0)
    assert mean.shape == (12, 1) and cov.shape == (12, 1, 1)
    assert smp.y_distr(N=8)[1].shape == (12, 1, 1)
    smp.fit_scan("SGLD", num_iters=1, num_chains=2, N=8, record="none")
    for call in (lambda: smp.predict(N=8),
                 lambda: smp.predictive_loglikelihood(N=8)):
        with pytest.raises(ValueError, match="select_chain"):
            call()
    smp.select_chain(1)
    assert smp.predictive_loglikelihood(1, N=8).shape == (2,)
    assert smp.prior_init().num_chains == 1
    vec = registry.get_model("lgssm", n=2)
    assert (vec.suff_statistic_dim, vec.y_statistic_dim) == (10, 10)
    ls = samplers.LGSSMSampler(ys, device="cpu")
    draws = ls.latent_var_sample(num_samples=2, kind="marginal")
    assert draws.shape == (2, 12, 1) and draws.dtype == np.float64
    assert ls.y_sample(kind="marginal").shape == (12, 1)
    assert ls.simulate_distr(4)["obs_cov"].shape == (5, 1, 1)
    paths = ls.simulate(4, num_samples=3, include_init=False)
    assert paths["observations"].shape == (3, 4, 1)
