"""The port's vector LGSSM (n, m > 1) against the JAX package, at
(n, m) = (2, 2) and the non-square (3, 2): the kernels' propose and
reweight, the Fisher-identity and sufficient statistics, unpack_grad, the
prior (density, gradient, draw), the projection, the SGRLD preconditioner,
a Gibbs sweep, data generation, the windowed marginal and complete-data
gradients and run_buffered_pf's score; then the vector model through the
port's samplers on the CPU (every fit_scan iteration type, the exact kinds,
Gibbs, the predict surface, whose shapes are held to JAX's).

The two frameworks cannot share random streams, so every draw of the JAX
side is rebuilt from its keys (the splits of ``sgmcmc_tpu/models/lgssm.py``,
``ops/kalman.py:ffbs_sample``, ``ops/buffered.py:run_buffered_pf`` and
``utils/distributions.py:sample_wishart``) and fed to the port.  Both sides
run in float64 here, deterministic and shared-draw functions held at
rtol = atol = 1e-10, but for the particle filter's score, which runs in
float32 (the resample-apply kernel's type; tolerances at the test).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgmcmc_tpu_torch
from sgmcmc_tpu.inference import samplers as jsamplers
from sgmcmc_tpu.models import lgssm as jl
from sgmcmc_tpu.models import registry as jregistry
from sgmcmc_tpu.ops import buffered as jbuffered
from sgmcmc_tpu.ops import kalman as jk
from sgmcmc_tpu_torch.inference import samplers
from sgmcmc_tpu_torch.models import lgssm, registry
from sgmcmc_tpu_torch.ops import buffered

torch.set_num_threads(1)

jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
FIELDS = ("A", "C", "LQinv_vec", "LRinv_vec")
F64 = dict(rtol=1e-10, atol=1e-10)
f64, f32 = jnp.float64, jnp.float32
SHAPES = [(2, 2), (3, 2)]

# two chains' natural (A, C, Q, R) per shape; the first (2, 2) chain is
# the model of tests/test_pf_vs_kalman.py
MATRICES = {
    (2, 2): [
        ([[0.7, 0.1], [0.0, 0.5]], np.eye(2), [[0.5, 0.1], [0.1, 0.4]],
         0.6 * np.eye(2)),
        ([[0.4, -0.2], [0.3, 0.6]], [[1.0, 0.3], [-0.2, 0.9]],
         [[0.8, -0.2], [-0.2, 0.5]], [[0.7, 0.1], [0.1, 0.5]])],
    (3, 2): [
        ([[0.6, 0.1, 0.0], [0.0, 0.5, 0.2], [0.1, 0.0, 0.4]],
         [[1.0, 0.0, 0.5], [0.0, 1.0, -0.3]],
         [[0.5, 0.05, 0.0], [0.05, 0.4, 0.05], [0.0, 0.05, 0.3]],
         [[0.6, 0.1], [0.1, 0.5]]),
        ([[0.3, 0.0, -0.2], [0.2, 0.7, 0.0], [0.0, 0.1, 0.5]],
         [[0.8, -0.1, 0.2], [0.3, 1.1, 0.0]],
         [[0.9, -0.1, 0.1], [-0.1, 0.6, 0.0], [0.1, 0.0, 0.7]],
         [[0.4, -0.05], [-0.05, 0.8]])],
}


def jax_stacked(shape):
    ps = [jl.from_matrices(*mats) for mats in MATRICES[shape]]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ps)


def t(a):
    return torch.from_numpy(np.array(a, np.float64))


def assert_params(got, want, **tol):
    for f in FIELDS:
        np.testing.assert_allclose(
            getattr(got, f).detach().double().numpy().reshape(-1),
            np.asarray(getattr(want, f), np.float64).reshape(-1),
            err_msg=f, **(tol or F64))


def wishart_draws(key, df, n):
    """(chi2 [n], off [n(n-1)/2]) of JAX's sample_wishart from ``key``."""
    key_diag, key_off = jax.random.split(key)
    chi2 = 2.0 * jax.random.gamma(key_diag, (df - jnp.arange(n)) / 2.0,
                                  dtype=f64)
    off = jax.random.normal(key_off, (n * (n - 1) // 2,), f64)
    return chi2, off


def ffbs_normals(key, T, n):
    """The normals of JAX's one-sample FFBS from ``key``, in the port's
    row order (row T-1 draws the last row)."""
    key_last, key_rest = jax.random.split(key)
    z_last = jax.random.normal(key_last, (n,), f64)
    z = jax.vmap(lambda k: jax.random.normal(k, (n,), f64))(
        jax.random.split(key_rest, T - 1))
    return jnp.concatenate([z[::-1], z_last[None]])


@functools.lru_cache(maxsize=None)
def jax_model_functions(n, m):
    """The JAX model functions over two chains, with the normals they
    draw from their keys: compiled once per shape."""
    jprior = jl.default_prior(n, m)

    def one(p, raw, g, key, x_t, x_n, y):
        k_opt, k_pri, k_noise, k_prior = jax.random.split(key, 4)
        out = {}
        for name, k in (("optimal", k_opt), ("prior", k_pri)):
            kern = jl.get_kernel(name)
            prop = kern.propose(p, k, x_t, y)
            out[name] = (jax.random.normal(k, x_t.shape, f64), prop,
                         kern.reweight(p, x_t, prop, y),
                         kern.prior_log_density(p, x_t, prop),
                         kern.prior_log_density_max(p))
        stat = jl.grad_statistic(p, x_t, x_n, y, 0)
        kA, kC, kQ, kR = jax.random.split(k_noise, 4)
        noise_z = jl.LGSSMParams(
            jax.random.normal(kA, (n, n), f64),
            jax.random.normal(kC, (m, n), f64),
            jax.random.normal(kQ, (n, n), f64),
            jax.random.normal(kR, (m, m), f64))
        kq, kr, ka, kc = jax.random.split(k_prior, 4)
        prior_draws = (*wishart_draws(kq, jprior.df_Qinv, n),
                       *wishart_draws(kr, jprior.df_Rinv, m),
                       jax.random.normal(ka, (n, n), f64),
                       jax.random.normal(kc, (m, n), f64))
        out.update(
            stat=stat, suff=jl.suff_statistic(p, x_t, x_n, y, 0),
            unpacked=jl.unpack_grad(stat.mean(0), n, m),
            logprior=jl.logprior(jprior, p),
            grad_logprior=jl.grad_logprior(jprior, p),
            project=jl.project_parameters(raw),
            precondition=jl.precondition(p, g),
            noise=jl.precondition_noise(p, k_noise), noise_z=noise_z,
            correction=jl.correction_term(p),
            sample_prior=jl.sample_prior(jprior, k_prior),
            prior_draws=prior_draws)
        return out
    return jit(jax.vmap(one))


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "3x2"])
def test_model_functions_match_jax(shape):
    """Both kernels on the normals JAX draws, the statistics,
    unpack_grad, the prior's density, gradient and draw (on JAX's Wishart
    and matrix-normal draws), the projection of parameters with negative
    Cholesky diagonals and A of spectral norm above 1, and the
    preconditioner triple (its noise on JAX's normals)."""
    n, m = shape
    N = 8
    rng = np.random.default_rng(n + 10 * m)
    x_t, x_n = rng.standard_normal((2, 2, N, n))
    ys = rng.standard_normal((2, m))
    jp = jax_stacked(shape)
    raw = jl.LGSSMParams(
        A=3.0 * jp.A, C=jp.C + 0.5,
        LQinv_vec=-jp.LQinv_vec, LRinv_vec=jp.LRinv_vec * jnp.where(
            jnp.arange(jp.LRinv_vec.shape[-1]) == 0, -1.0, 1.0))
    g = jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape), jp)
    keys = jax.random.split(jax.random.PRNGKey(n), 2)
    want = jax_model_functions(n, m)(jp, raw, g, keys, jnp.asarray(x_t),
                                     jnp.asarray(x_n), jnp.asarray(ys))
    params = lgssm.params_from_jax(jp, torch.float64)
    for name in ("optimal", "prior"):
        kern = lgssm.get_kernel(name, n, m)
        assert (kern.state_dim, kern.noise_dim) == (n, n)
        z, *w = want[name]
        prop = kern.propose(params, t(z), t(x_t), t(ys))
        got = (prop, kern.reweight(params, t(x_t), prop, t(ys)),
               kern.prior_log_density(params, t(x_t), prop),
               kern.prior_log_density_max(params))
        for gv, wv in zip(got, w):
            np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **F64,
                                       err_msg=name)
    stat = lgssm.grad_statistic(params, t(x_t), t(x_n), t(ys), 0)
    assert stat.shape == (2, N, lgssm.statistic_dim(n, m))
    np.testing.assert_allclose(stat.numpy(), np.asarray(want["stat"]), **F64)
    np.testing.assert_allclose(
        lgssm.suff_statistic(params, t(x_t), t(x_n), t(ys), 0).numpy(),
        np.asarray(want["suff"]), **F64)
    assert_params(lgssm.unpack_grad(stat.mean(1), n, m), want["unpacked"])
    prior = lgssm.default_prior(n, m, dtype=torch.float64)
    np.testing.assert_allclose(lgssm.logprior(prior, params).numpy(),
                               np.asarray(want["logprior"]), **F64)
    assert_params(lgssm.grad_logprior(prior, params), want["grad_logprior"])
    assert_params(lgssm.project_parameters(lgssm.params_from_jax(
        raw, torch.float64)), want["project"])
    assert_params(lgssm.precondition(params, lgssm.params_from_jax(
        g, torch.float64)), want["precondition"])
    assert_params(lgssm.precondition_noise(params, lgssm.params_from_jax(
        want["noise_z"], torch.float64)), want["noise"])
    assert_params(lgssm.correction_term(params), want["correction"])
    draws = lgssm.PriorDraws(*[t(d) for d in want["prior_draws"]])
    assert_params(lgssm.sample_prior(prior, None, 2, draws=draws),
                  want["sample_prior"])


@functools.lru_cache(maxsize=None)
def jax_gibbs(n, m, T):
    """JAX's Gibbs sweep over two chains and the draws it takes."""
    jprior = jl.default_prior(n, m)

    def one(key, p, ys):
        k_x, k_p = jax.random.split(key)
        k1, k2 = jax.random.split(k_p)
        k_v, k_m = jax.random.split(k1)
        return (jl.gibbs_step(key, jprior, p, ys), ffbs_normals(k_x, T, n),
                *wishart_draws(k_v, jprior.df_Qinv + T - 1, n),
                jax.random.normal(k_m, (n, n), f64),
                *wishart_draws(k2, jprior.df_Rinv + T, m))
    return jit(jax.vmap(one, in_axes=(0, 0, None)))


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "3x2"])
def test_gibbs_step_matches_jax_on_shared_draws(shape):
    """One blocked-Gibbs sweep of two chains (FFBS, the conjugate (Q, A)
    block, R given C = I) on the FFBS normals, Bartlett draws and
    matrix-normal normals JAX draws."""
    n, m = shape
    T = 15
    ys = 1.5 * np.random.default_rng(2).standard_normal((T, m))
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    want, *d = jax_gibbs(n, m, T)(keys, jax_stacked(shape), jnp.asarray(ys))
    z, q_chi2, q_off, a_z, r_chi2, r_off = [t(x) for x in d]
    draws = lgssm.GibbsDraws(z, q_chi2, q_off, a_z, r_chi2, r_off)
    got = lgssm.gibbs_step(None, lgssm.default_prior(n, m,
                                                     dtype=torch.float64),
                           lgssm.params_from_jax(jax_stacked(shape),
                                                 torch.float64),
                           t(ys), draws=draws)
    assert_params(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "3x2"])
def test_generate_data_matches_jax(shape):
    """Data generation from the truncated stationary initial law, on the
    normals JAX draws from its key."""
    n, m = shape
    T = 30
    key = jax.random.PRNGKey(5)
    jp = jax.tree_util.tree_map(lambda x: x[0], jax_stacked(shape))
    want_y, want_x = jl.generate_data(key, jp, T)
    k0, kx, ky = jax.random.split(key, 3)
    normals = [np.array(jax.random.normal(k, s, f64))
               for k, s in ((k0, (n,)), (kx, (T, n)), (ky, (T, m)))]
    ys, xs = lgssm.generate_data(None, lgssm.params_from_jax(
        jp, torch.float64), T, normals=normals)
    assert ys.shape == (T, m) and xs.shape == (T, n)
    np.testing.assert_allclose(ys.numpy(), np.asarray(want_y), **F64)
    np.testing.assert_allclose(xs.numpy(), np.asarray(want_x), **F64)


def rolled_window(ys, start, S, B):
    """JAX's marginal-score window: (window, valid, weights)."""
    T = ys.shape[0]
    idx = start - B + np.arange(S + 2 * B)
    valid = ((idx >= 0) & (idx < T)).astype(ys.dtype)
    tt = start + np.arange(S)
    cnt = np.minimum(np.minimum(tt + 1, S), np.minimum(T - S + 1, T - tt))
    return (ys[np.clip(idx, 0, T - 1)], valid,
            ((T - S + 1) / cnt).astype(ys.dtype))


T_W, S_W, B_W, K_W = 20, 6, 3, 2
STARTS = np.array([0, 8, 14, 5])


@functools.lru_cache(maxsize=None)
def jax_windowed(n, m):
    """JAX's windowed marginal and complete gradients over rows, with the
    normals the complete kind draws (K_W a row)."""
    W = S_W + 2 * B_W

    def row(p, w, v, wt, k):
        def draws(kk):
            k_ffbs, k_prev = jax.random.split(kk)
            return (ffbs_normals(k_ffbs, W, n),
                    jax.random.normal(k_prev, (n,), f64))
        return (jl.windowed_marginal_gradient(p, w, v, wt, B_W, S_W),
                jl.windowed_complete_gradient(p, w, v, wt, B_W, S_W, k, K_W),
                jax.vmap(draws)(jax.random.split(k, K_W)))
    return jit(jax.vmap(row))


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "3x2"])
def test_windowed_gradients_match_jax(shape):
    """The buffered exact gradients over edge and interior windows, the
    complete kind on JAX's FFBS and completion normals."""
    n, m = shape
    ys = 1.5 * np.random.default_rng(1).standard_normal((T_W, m))
    win, valid, weights = [np.stack(x) for x in zip(
        *[rolled_window(ys, s, S_W, B_W) for s in STARTS])]
    jrows = jax.tree_util.tree_map(lambda x: x[np.arange(4) % 2],
                                   jax_stacked(shape))
    keys = jax.random.split(jax.random.PRNGKey(3), len(STARTS))
    (mg, mll), (cg, cll), (z, zc) = jax_windowed(n, m)(
        jrows, *[jnp.asarray(a) for a in (win, valid, weights)], keys)
    args = (lgssm.params_from_jax(jrows, torch.float64), t(win), t(valid),
            t(weights), B_W, S_W)
    g, ll = lgssm.windowed_marginal_gradient(*args)
    assert_params(g, mg)
    np.testing.assert_allclose(ll.numpy(), np.asarray(mll), **F64)
    g, ll = lgssm.windowed_complete_gradient(*args, num_samples=K_W,
                                             normals=t(z), completion=t(zc))
    assert_params(g, cg)
    np.testing.assert_allclose(ll.numpy(), np.asarray(cll), **F64)


N_PF, W_PF = 32, 10


@functools.lru_cache(maxsize=None)
def jax_pf(n, m, resampler):
    """JAX's run_buffered_pf (resample_mode="auto": on the CPU its
    resample-apply route, the port's selection) over two chains, with
    the draws it takes: z0 [n, N], uniforms, normals [W, n, N]."""
    jm = jregistry.get_model("lgssm", n=n, m=m)

    def one(key, p, y, sw):
        pm, pv = jm.prior_mean_var(p)
        out = jbuffered.run_buffered_pf(
            jl.get_kernel(None), jl.grad_statistic, p, y, key=key,
            n_particles=N_PF, statistic_dim=jl.statistic_dim(n, m),
            step_weights=sw, in_window=(sw > 0).astype(sw.dtype),
            prior_mean=pm, prior_var=pv, resampler=resampler,
            resample_mode="auto")
        key_init, key_steps = jax.random.split(key)

        def step(k):
            kr, kp = jax.random.split(k)
            shape = () if resampler == "systematic" else (N_PF,)
            return (jax.random.uniform(kr, shape, f32),
                    jax.random.normal(kp, (N_PF, n), f32).T)
        u, z = jax.vmap(step)(jax.random.split(key_steps, W_PF))
        z0 = jax.random.normal(key_init, (N_PF, n), f32).T
        return out.mean_statistic, out.loglikelihood, z0, u, z
    return jit(jax.vmap(one))


@pytest.mark.parametrize("shape,resampler", [
    ((2, 2), "multinomial"), ((2, 2), "systematic"),
    ((3, 2), "multinomial")], ids=["2x2-multinomial", "2x2-systematic",
                                   "3x2-multinomial"])
def test_buffered_score_matches_jax_on_its_draws(shape, resampler):
    """run_buffered_pf's Poyiadjis O(N) score of the vector model (the
    optimal kernel, the (0, 10 I) initial law, a [particles | statistics]
    carry of K = n + statistic_dim columns) on JAX's own per-step draws,
    in float32 on both sides (resample-apply takes float32): the
    log-likelihood at rtol 1e-5; the statistic, whose weighted sums
    cancel to entries near 0 from terms of ~10, at 1e-5 relative to the
    size of its summed terms (the same filter averaging |statistic|)."""
    n, m = shape
    rng = np.random.default_rng(7)
    ys = rng.standard_normal((2, W_PF, m)).astype(np.float32)
    sw = rng.uniform(1.0, 3.0, (2, W_PF)).astype(np.float32)
    sw[:, :2] = 0.0
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    jp = jax.tree_util.tree_map(lambda x: x.astype(f32), jax_stacked(shape))
    want_stat, want_ll, z0, u, z = jax_pf(n, m, resampler)(
        keys, jp, jnp.asarray(ys), jnp.asarray(sw))
    api = registry.get_model("lgssm", n=n, m=m)
    params = lgssm.params_from_jax(jp)
    pm, pv = api.prior_mean_var(params)
    f = torch.from_numpy
    kw = dict(z0=f(np.array(z0)), normals=f(np.array(z)), u=f(np.array(u)),
              statistic_dim=api.grad_statistic_dim, step_weights=f(sw),
              in_window=(f(sw) > 0).float(), prior_mean=pm, prior_var=pv,
              resampler=resampler)
    out = buffered.run_buffered_pf(api.get_kernel(), api.grad_statistic,
                                   params, f(ys), **kw)
    terms = buffered.run_buffered_pf(
        api.get_kernel(), lambda *a: api.grad_statistic(*a).abs(), params,
        f(ys), **kw).mean_statistic.numpy()
    err = np.abs(out.mean_statistic.numpy() - np.asarray(want_stat))
    assert np.all(err <= 1e-5 * terms), (
        f"max |port - JAX| / terms = {(err / terms).max():.3e} > 1e-5")
    np.testing.assert_allclose(out.loglikelihood.numpy(),
                               np.asarray(want_ll), rtol=1e-5)


def test_params_from_jax_round_trips():
    """One chain's and stacked JAX parameters of any shape carried across
    and back; from_matrices equals the JAX package's."""
    for shape in SHAPES:
        jp = jax_stacked(shape)
        for src in (jp, jax.tree_util.tree_map(lambda x: x[1], jp)):
            p = lgssm.params_from_jax(src, torch.float64)
            assert p.n == shape[0] and p.m == shape[1]
            assert p.num_chains == (2 if src is jp else 1)
            back = jl.LGSSMParams(*[getattr(p, f).numpy() for f in FIELDS])
            if src is not jp:
                back = jax.tree_util.tree_map(lambda x: x[0], back)
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(back, f),
                                              np.asarray(getattr(src, f)))
        mats = MATRICES[shape][1]
        assert_params(lgssm.from_matrices(*mats, dtype=torch.float64),
                      jl.from_matrices(*mats))


def test_registry_and_samplers_take_the_vector_model():
    """get_model("lgssm", n, m) is the vector ModelAPI (K1 stays the
    scalar model's), the scalar entry is unchanged, and the LGSSM samplers
    and sampler_for_model build either; sampler_for_model builds the
    GaussHMM's (float64) and names the SLDS's slice."""
    vec = registry.get_model("lgssm", n=2, m=2)
    assert isinstance(vec, sgmcmc_tpu_torch.ModelAPI)
    assert vec.get_fused is None and vec.name == "lgssm_2_2"
    assert registry.get_model("lgssm", n=2, m=2) is vec
    assert registry.get_model("lgssm") is registry.LGSSM
    assert registry.LGSSM.get_fused is lgssm.get_fused
    assert (vec.grad_statistic_dim, vec.suff_statistic_dim) == (14, 10)
    assert registry.get_model("lgssm", n=3, m=2).grad_statistic_dim == \
        jl.statistic_dim(3, 2)
    assert sgmcmc_tpu_torch.get_model is registry.get_model
    ys = np.zeros((10, 2), np.float32)
    s = sgmcmc_tpu_torch.sampler_for_model("lgssm", observations=ys, n=2,
                                           m=2, device="cpu")
    assert isinstance(s, samplers.LGSSMSampler) and s.model is vec
    assert s.parameters.A.shape == (1, 2, 2)
    hmm = sgmcmc_tpu_torch.sampler_for_model(
        "gauss_hmm", observations=ys[:, :1], num_states=3, device="cpu")
    assert isinstance(hmm, samplers.GaussHMMSampler)
    assert hmm.model is registry.get_model("gauss_hmm", num_states=3)
    assert hmm.parameters.mu.shape == (1, 3, 1)
    assert hmm.parameters.mu.dtype == hmm.observations.dtype == torch.float64
    sl = sgmcmc_tpu_torch.sampler_for_model(
        "slds", observations=ys[:, :1], device="cpu")
    assert isinstance(sl, samplers.SLDSSampler)
    assert sl.model is registry.get_model("slds")
    with pytest.raises(ValueError, match="Unknown model"):
        samplers.sampler_for_model("nope")


def vector_data(T=40):
    truth = lgssm.from_matrices(*MATRICES[(2, 2)][0])
    return lgssm.generate_data(torch.Generator().manual_seed(0), truth, T)[0]


@pytest.mark.parametrize("iter_type", ["SGLD", "SGRLD", "SGD", "SGRD",
                                       "ADAGRAD", "SGLD-CV"])
def test_vector_fit_scan_on_cpu(iter_type):
    """Every fit_scan iteration type on the vector model (4 chains,
    multinomial, N=32) stays finite, keeps C = I and a stable A."""
    s = samplers.Sampler(registry.get_model("lgssm", n=2, m=2),
                         observations=vector_data(), device="cpu", seed=1)
    kw = dict(N=32, subsequence_length=8, buffer_length=2)
    if iter_type == "SGLD-CV":
        kw.update(centering_parameters=s.parameters,
                  centering_gradient=s.noisy_gradient(**kw))
    trace = s.fit_scan(iter_type, num_iters=2, num_chains=4, epsilon=0.01,
                       **kw)
    assert trace.A.shape == (4, 2, 2, 2) and trace.LQinv_vec.shape == (4, 2,
                                                                       3)
    for f in FIELDS:
        assert bool(torch.isfinite(getattr(trace, f)).all()), f
    assert bool((trace.C == torch.eye(2)).all())
    assert float(torch.linalg.matrix_norm(trace.A, ord=2).max()) <= 0.99995


def test_vector_exact_kinds_gibbs_and_systematic_on_cpu():
    """The exact kinds (marginal, complete), the systematic resampler
    (on the unfused route, K1 being scalar) and Gibbs sweeps of the
    LGSSMSampler at n = m = 2 stay finite; the exact log-likelihood is
    the Kalman filter's."""
    ys = vector_data()
    s = samplers.LGSSMSampler(ys, n=2, m=2, device="cpu", seed=2)
    for kw in (dict(kind="marginal"), dict(kind="complete", num_samples=2),
               dict(N=32, resampler="systematic")):
        trace = s.fit_scan("SGLD", num_iters=2, num_chains=3,
                           subsequence_length=8, buffer_length=2,
                           epsilon=0.01, **kw)
        assert bool(torch.isfinite(trace.LRinv_vec).all()), kw
    s.select_chain(0)
    for _ in range(2):
        p = s.sample_gibbs()
    assert p.A.shape == (1, 2, 2) and bool(torch.isfinite(p.A).all())
    jp = jl.LGSSMParams(*[getattr(p, f)[0].double().numpy() for f in FIELDS])
    want = jl.marginal_loglikelihood(jp, jnp.asarray(ys.double().numpy()))
    np.testing.assert_allclose(s.exact_loglikelihood(), float(want),
                               rtol=1e-10)


def test_vector_predict_shapes_match_jax():
    """The PF and exact predict surface of one chain of the vector model:
    every shape as the JAX sampler gives it."""
    ys = vector_data(T=12)
    p = lgssm.from_matrices(*MATRICES[(2, 2)][1])
    s = samplers.Sampler(registry.get_model("lgssm", n=2, m=2),
                         observations=ys, device="cpu", parameters=p)
    js = jsamplers.Sampler(
        jregistry.get_model("lgssm", n=2, m=2), observations=np.asarray(ys),
        parameters=jl.from_matrices(*MATRICES[(2, 2)][1], dtype=f32), seed=0)
    for kw in (dict(N=16), dict(target="y", kind="marginal")):
        got, want = s.predict(**kw), js.predict(**kw)
        assert [g.shape for g in got] == [np.shape(w) for w in want], kw
        assert all(np.isfinite(g).all() for g in got)
    for kw in (dict(target="y", N=16), dict(kind="marginal", lag=2)):
        assert [g.shape for g in s.predict(**kw)] == [(12, 2), (12, 2, 2)]
    assert s.predictive_loglikelihood(2, N=16).shape == (3,)
    np.testing.assert_allclose(
        s.predictive_loglikelihood(kind="marginal"),
        js.predictive_loglikelihood(kind="marginal"), rtol=1e-6)
    draws = s.predict(kind="marginal", num_samples=3)
    assert draws.shape == (3, 12, 2)


def test_kalman_message_is_the_state_size():
    """The default messages of the vector model carry n (the messages the
    exact functions start from)."""
    p = lgssm.params_from_jax(jax_stacked((3, 2)), torch.float64)
    f, b = lgssm.default_forward_message(p), lgssm.default_backward_message(p)
    jf = jk.init_forward_message(3)
    np.testing.assert_array_equal(f.precision.numpy(),
                                  np.asarray(jf.precision))
    assert b.precision.shape == (3, 3)
