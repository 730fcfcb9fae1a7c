"""The port's simplex coordinates, discrete-state messages (``ops/hmm.py``)
and GaussHMM against the JAX package.

Both sides get the same numpy inputs.  The deterministic functions are
held in float64 at rtol 1e-10 (atol 1e-12): the messages (weighted and
valid-gated), the marginal log-likelihood, the posterior marginals, the
lagged marginals, the predictive log-likelihood, both gradients (plain and
``use_scir``), the windowed gradients at B = 0 and 4, the prior, its
gradient, the projection and the preconditioner.  The draw-fed functions
(the Dirichlet draws, the prior draw, the preconditioner's noise, the
Gibbs update, the complete-data score on JAX's own z paths) get the draws
the JAX side makes, rebuilt from its keys.  The FFBS, which draws by the
inverse CDF where the JAX package uses a Gumbel-max, and the complete-data
score's mean are held in law; the marginal log-likelihood also against
path enumeration.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from sgmcmc_tpu.models import gauss_hmm as jg
from sgmcmc_tpu.ops import hmm as jh
from sgmcmc_tpu.utils import simplex as js
from sgmcmc_tpu_torch.models import gauss_hmm as g
from sgmcmc_tpu_torch.ops import hmm
from sgmcmc_tpu_torch.utils import simplex

torch.set_num_threads(1)

# The JAX side is compiled without XLA's backend optimisations: it runs
# once, and the compile is most of its time.
jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
F64 = dict(rtol=1e-10, atol=1e-12)
f64 = jnp.float64
FIELDS = ("logit_pi", "mu", "LRinv_vec")
K, M, T, C = 3, 2, 20, 2


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               **(tol or F64))


def assert_params(got, want, fields=FIELDS, **tol):
    for f in fields:
        close(getattr(got, f), getattr(want, f), **tol)


def t(a):
    return torch.from_numpy(np.array(a))


def chain(tree, c):
    return jax.tree_util.tree_map(lambda x: x[c], tree)


def over_chains(fn, n=C):
    """fn(c) for each chain c (a jitted one-chain JAX function, compiled
    once), the outputs stacked along a leading chain axis."""
    outs = [fn(c) for c in range(n)]
    return jax.tree_util.tree_map(lambda *x: np.stack(x), *outs)


def jax_chains(seed=0, k=K, m=M, c=C):
    """c GaussHMM chains (stacked JAX parameters) with distinct pi, mu and
    correlated R."""
    rng = np.random.default_rng(seed)
    ps = []
    for _ in range(c):
        A = rng.standard_normal((k, m, m)) * 0.3
        R = A @ np.swapaxes(A, -1, -2) + np.eye(m) * 0.5
        ps.append(jg.from_values(rng.dirichlet(np.ones(k) * 3, size=k),
                                 rng.standard_normal((k, m)), R))
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *ps)


@functools.lru_cache(maxsize=None)
def case():
    """(JAX chains, port chains, ys [T, m], weights, valid) of the
    deterministic tests."""
    rng = np.random.default_rng(1)
    jp = jax_chains()
    ys = rng.standard_normal((T, M)) * 1.5
    w = rng.uniform(0.5, 2.0, T)
    v = (np.arange(T) % 7 != 3).astype(np.float64)
    return jp, g.params_from_jax(jp), ys, w, v


# --------------------------------------------------------------------------
# simplex coordinates
# --------------------------------------------------------------------------

def simplex_calls(arrays):
    """(name, arguments) of every call the simplex test makes."""
    logit, pi, e, gp, alpha, p, lp = arrays
    return (("pi_from_logit", (logit,)), ("logit_from_pi", (pi,)),
            ("pi_from_expanded", (e,)), ("expanded_from_pi", (pi,)),
            ("project_logit", (logit,)), ("project_logit", (logit, False)),
            ("project_expanded", (e,)), ("project_expanded", (e, True)),
            ("grad_logit_from_grad_pi", (gp, pi)),
            ("grad_expanded_from_grad_pi", (gp, e)),
            ("dirichlet_logprior", (pi, alpha)),
            ("dirichlet_grad_logit", (pi, alpha)),
            ("dirichlet_grad_logit", (pi, alpha, True)),
            ("dirichlet_grad_expanded", (e, alpha)),
            ("dirichlet_grad_expanded", (e, alpha, True)),
            ("prob_from_logit", (lp,)), ("logit_from_prob", (p,)),
            ("grad_logit_from_grad_prob", (lp, p)),
            ("beta_logprior", (p, 2.0, 3.0)),
            ("beta_grad_logit", (lp, 2.0, 3.0)))


@jit
def jax_simplex(arrays, counts, key):
    out = [getattr(js, name)(*args) for name, args in simplex_calls(arrays)]
    alpha = arrays[4]
    return (out, js.dirichlet_sample(key, alpha),
            js.dirichlet_posterior_sample(key, alpha, counts),
            jax.random.gamma(key, alpha),
            jax.random.gamma(key, alpha + counts))


def test_simplex_functions_match_jax():
    """All 15 functions of utils/simplex.py, the draws on JAX's gammas."""
    rng = np.random.default_rng(2)
    logit = rng.standard_normal((4, 3))
    pi = np.exp(logit) / np.exp(logit).sum(-1, keepdims=True)
    arrays = (logit, pi, rng.standard_normal((4, 3)),
              rng.standard_normal((4, 3)), rng.uniform(0.5, 3.0, (4, 3)),
              rng.uniform(0.05, 0.95, 5), rng.standard_normal(5))
    counts = rng.integers(0, 5, (4, 3)).astype(np.float64)
    want, dir_w, post_w, gam, gam_post = jax_simplex(
        arrays, counts, jax.random.PRNGKey(3))
    for (name, args), w in zip(simplex_calls(tuple(map(t, arrays))), want):
        close(getattr(simplex, name)(*args), w, err_msg=name, **F64)
    alpha = t(arrays[4])
    close(simplex.dirichlet_sample(None, alpha, gamma=t(gam)), dir_w)
    close(simplex.dirichlet_posterior_sample(None, alpha, t(counts),
                                             gamma=t(gam_post)), post_w)
    draw = simplex.dirichlet_sample(torch.Generator().manual_seed(0), alpha)
    close(draw.sum(-1), np.ones(4))


# --------------------------------------------------------------------------
# ops/hmm.py and the GaussHMM's deterministic surface
# --------------------------------------------------------------------------

@jit
def jax_messages(logP, Pi, w, v):
    f0, b0 = jh.default_forward_message(K), jh.default_backward_message(K)
    out = []
    for ww, vv in ((None, None), (w, None), (None, v), (w, v)):
        f = jh.forward_messages(logP, Pi, f0, ww, vv)
        b = jh.backward_messages(logP, Pi, b0, ww, vv)
        out += [f.prob, f.log_constant, b.prob, b.log_constant]
    return out


def test_messages_match_jax_weighted_and_valid_gated():
    """Forward and backward messages of two chains' Pi on one logP, plain,
    weighted, valid-gated and both."""
    jp, p, ys, w, v = case()
    logP = g.emission_logliks(p, t(ys))                      # [C, T, K]
    Pi = np.asarray(p.pi)
    want = over_chains(lambda c: jax_messages(np.asarray(logP[c]), Pi[c], w,
                                              v))
    got = []
    f0, b0 = hmm.default_forward_message(K), hmm.default_backward_message(K)
    for ww, vv in ((None, None), (t(w), None), (None, t(v)), (t(w), t(v))):
        f = hmm.forward_messages(logP, p.pi, f0, ww, vv)
        b = hmm.backward_messages(logP, p.pi, b0, ww, vv)
        got += [f.prob, f.log_constant, b.prob, b.log_constant]
    for a, b in zip(got, want):
        close(a, b)


@jit
def jax_exact(jp, ys, w, v):
    """Per chain (vmapped by the caller): the marginal log-likelihoods,
    posterior marginals, lagged marginals and predictive
    log-likelihoods."""
    logP = jg.emission_logliks(jp, ys)
    f0, b0 = jg.default_forward_message(jp), jg.default_backward_message(jp)
    joint, marg = jh.posterior_marginals(logP, jp.pi, f0, b0, valid=v)
    return ([jg.marginal_loglikelihood(jp, ys),
             jg.marginal_loglikelihood(jp, ys, weights=w, valid=v),
             joint, marg]
            + [jg.latent_var_distr(jp, ys, lag=lag)
               for lag in (None, 0, -2, 3)]
            + [jg.predictive_loglikelihood(jp, ys, lag=lag)
               for lag in (0, 1, 2)])


def test_exact_functions_match_jax():
    jp, p, ys, w, v = case()
    want = over_chains(lambda c: jax_exact(chain(jp, c), ys, w, v))
    y = t(ys)
    logP = g.emission_logliks(p, y)
    joint, marg = hmm.posterior_marginals(
        logP, p.pi, g.default_forward_message(p),
        g.default_backward_message(p), valid=t(v))
    got = ([g.marginal_loglikelihood(p, y),
            g.marginal_loglikelihood(p, y, weights=t(w), valid=t(v)),
            joint, marg]
           + [g.latent_var_distr(p, y, lag=lag) for lag in (None, 0, -2, 3)]
           + [g.predictive_loglikelihood(p, y, lag=lag) for lag in (0, 1, 2)])
    for a, b in zip(got, want):
        close(a, b)


def brute_force_loglik(pi, mu, R, ys):
    """log p(y) by enumerating the K^T paths (the oracle of
    tests/test_gauss_hmm.py)."""
    k = pi.shape[0]
    logP = np.array([[stats.multivariate_normal.logpdf(y, mu[j], R[j])
                      for j in range(k)] for y in ys])
    total = -np.inf
    for path in itertools.product(range(k), repeat=len(ys)):
        lp = np.log(np.ones(k) / k @ pi[:, path[0]]) + logP[0, path[0]]
        for s in range(1, len(ys)):
            lp += np.log(pi[path[s - 1], path[s]]) + logP[s, path[s]]
        total = np.logaddexp(total, lp)
    return total


def test_marginal_loglikelihood_against_path_enumeration():
    rng = np.random.default_rng(4)
    pi = rng.dirichlet(np.ones(3) * 3, size=3)
    mu = np.linspace(-2, 2, 3)[:, None]
    R = np.stack([np.eye(1) * (0.3 + 0.2 * k) for k in range(3)])
    ys = rng.standard_normal((5, 1)) * 1.5
    got = g.marginal_loglikelihood(g.from_values(pi, mu, R), t(ys))
    close(got, [brute_force_loglik(pi, mu, R, ys)])


@functools.partial(jit, static_argnames=("B",))
def jax_gradients(jp, ys, w, v, win, valid, wts, B):
    """(full, windowed) gradients of one chain, plain and use_scir."""
    S = wts.shape[-1]
    return [(jg.gradient_marginal_loglikelihood(jp, ys, weights=w,
                                                use_scir=u, valid=v),
             jg.windowed_marginal_gradient(jp, win, valid, wts, B, S,
                                           use_scir=u))
            for u in (False, True)]


def rolled_windows(ys, starts, S, B):
    """The exact score's rolled windows (window, valid, weights)."""
    n = ys.shape[0]
    idx = starts[:, None] - B + np.arange(S + 2 * B)
    valid = ((idx >= 0) & (idx < n)).astype(np.float64)
    s = starts[:, None] + np.arange(S)
    cnt = np.minimum(np.minimum(s + 1, S), np.minimum(n - S + 1, n - s))
    return ys[np.clip(idx, 0, n - 1)], valid, (n - S + 1) / cnt


@pytest.mark.parametrize("B", [0, 4])
@pytest.mark.parametrize("use_scir", [False, True])
def test_gradients_match_jax(use_scir, B):
    """The closed-form gradient (weights and a valid gate) and the
    windowed estimator over an edge and an interior window."""
    jp, p, ys, w, v = case()
    win, valid, wts = rolled_windows(ys, np.array([0, 9]), 8, B)
    (want, (want_w, want_ll)) = over_chains(lambda c: jax_gradients(
        chain(jp, c), ys, w, v, win[c], valid[c], wts[c], B))[int(use_scir)]
    got = g.gradient_marginal_loglikelihood(p, t(ys), weights=t(w),
                                            use_scir=use_scir, valid=t(v))
    assert_params(got, want)
    got_w, got_ll = g.windowed_marginal_gradient(p, t(win), t(valid),
                                                 t(wts), B, 8, use_scir)
    assert_params(got_w, want_w)
    close(got_ll, want_ll)


def wishart_draws(key, df, m):
    """The chi-squares and off-diagonal normals of the JAX package's
    sample_wishart from ``key``."""
    kd, ko = jax.random.split(key)
    return (2.0 * jax.random.gamma(kd, (df - jnp.arange(m)) / 2.0, dtype=f64),
            jax.random.normal(ko, (m * (m - 1) // 2,), f64))


@jit
def jax_prior_side(jp, key):
    prior = jg.default_prior(K, M)
    lp = jg.logprior(prior, jp)
    grads = (jg.grad_logprior(prior, jp), jg.grad_logprior(prior, jp, True))
    proj = (jg.project_parameters(jp),
            jg.project_parameters(jp, center_logit=False))
    pre = jg.precondition(jp, jg.gradient_marginal_loglikelihood(
        jp, jnp.zeros((3, M))))
    noise = jg.precondition_noise(jp, key)
    kp, km, kr = jax.random.split(key, 3)
    z = (jax.random.normal(kp, (K, K), f64), jax.random.normal(km, (K, M),
                                                               f64),
         jax.random.normal(kr, (K, M, M), f64))
    draw = jg.sample_prior(prior, key)
    kp, kr, km = jax.random.split(key, 3)
    chi2, off = jax.vmap(wishart_draws, in_axes=(0, None, None))(
        jax.random.split(kr, K), prior.df_Rinv, M)
    draws = (jax.random.gamma(kp, prior.alpha_pi, dtype=f64), chi2, off,
             jax.random.normal(km, (K, M), f64))
    return (lp, grads, proj, pre, noise, z, jg.correction_term(jp), draw,
            draws)


def test_prior_projection_and_preconditioner_match_jax():
    """logprior, grad_logprior (plain and use_scir), the projection (with
    and without centring), D(theta) grad, the preconditioner's noise on
    JAX's normals, the correction term and the prior draw on JAX's
    gammas, Wishart draws and normals."""
    jp, p, _, _, _ = case()
    # a negative Cholesky diagonal for the projection to reflect
    jp = jp.replace(LRinv_vec=jp.LRinv_vec.at[0, 1, 0].multiply(-1.0))
    p = g.params_from_jax(jp)
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    (lp, grads, proj, pre, noise, z, corr, draw,
     draws) = over_chains(lambda c: jax_prior_side(chain(jp, c), keys[c]))
    prior = g.default_prior(K, M)
    close(g.logprior(prior, p), lp)
    assert_params(g.grad_logprior(prior, p), grads[0])
    assert_params(g.grad_logprior(prior, p, use_scir=True), grads[1])
    assert_params(g.project_parameters(p), proj[0])
    assert_params(g.project_parameters(p, center_logit=False), proj[1])
    gm = g.gradient_marginal_loglikelihood(p, torch.zeros((3, M),
                                                          dtype=torch.float64))
    assert_params(g.precondition(p, gm), pre)
    assert_params(g.precondition_noise(p, g.GaussHMMParams(*map(t, z))),
                  noise)
    assert_params(g.correction_term(p), corr)
    assert_params(g.sample_prior(prior, None, C, g.PriorDraws(
        *map(t, draws))), draw)


def test_scir_transition_update_matches_jax():
    """SCIR's exact update on JAX's Poisson counts and gammas, then the
    centred logits; finite, positive simplex rows."""
    jp, p, _, _, _ = case()
    rng = np.random.default_rng(6)
    a = np.abs(rng.standard_normal((C, K, K))) + np.array([0.0, 1.0])[:, None,
                                                                      None]
    eps = 0.1
    keys = jax.random.split(jax.random.PRNGKey(7), C)

    def jax_side(key, q, aa):
        k1, k2 = jax.random.split(key)
        theta = jnp.exp(q.logit_pi)
        nonc = 2.0 * theta * jnp.exp(-eps) / (1.0 - jnp.exp(-eps))
        J = jax.random.poisson(k1, nonc / 2.0)
        gam = jax.random.gamma(k2, (2.0 * aa + 2.0 * J) / 2.0, dtype=f64)
        return (jg.scir_transition_update(key, q, aa, eps),
                jh.scir_update(key, theta, aa, eps), J, gam)
    side = jit(jax_side)
    want, want_theta, J, gam = over_chains(lambda c: side(keys[c],
                                                          chain(jp, c), a[c]))
    got_theta = hmm.scir_update(None, torch.exp(p.logit_pi), t(a), eps,
                                J=t(J), gamma=t(gam))
    close(got_theta, want_theta)
    got = g.scir_transition_update(None, p, t(a), eps, J=t(J), gamma=t(gam))
    close(got, want)
    # a rate past torch.poisson's int64 range takes the normal
    # approximation (W / nonc = 1 + O(nonc^-1/2)), a diverged chain's NaN
    # rate gives NaN, a zero shape 0, without reaching the samplers
    gen = torch.Generator().manual_seed(0)
    nonc = torch.tensor([6.4e20, 1e60, 2.0, float("nan"), 0.0],
                        dtype=torch.float64)
    W = hmm.sample_noncentral_chi2(gen, torch.full_like(nonc, 0.02), nonc)
    close(W[:2] / nonc[:2], np.ones(2), rtol=1e-6)
    assert bool(torch.isfinite(W[2])) and bool(torch.isnan(W[3]))
    assert W[4] >= 0
    drawn = g.scir_transition_update(gen, p, t(a) * 0 + 0.01, eps)
    pi = torch.softmax(drawn, -1)
    assert torch.isfinite(drawn).all() and (pi > 0).all()
    close(pi.sum(-1), np.ones((C, K)))


@jit
def jax_gibbs(key, z, ys):
    """One chain's gibbs_parameters_sample(key, ...) given z, and the
    draws it makes: the Dirichlet's gammas, the Wishart's chi-squares and
    off-diagonals, the means' normals."""
    prior = jg.default_prior(K, M)
    zo = jax.nn.one_hot(z, K, dtype=f64)
    kp, kr, km = jax.random.split(key, 3)
    chi2, off = jax.vmap(wishart_draws, in_axes=(0, 0, None))(
        jax.random.split(kr, K), prior.df_Rinv + zo.sum(0), M)
    return (jg.gibbs_parameters_sample(key, prior, ys, z),
            (jax.random.gamma(kp, prior.alpha_pi + zo[:-1].T @ zo[1:],
                              dtype=f64), chi2, off,
             jax.random.normal(km, (K, M), f64)))


def test_gibbs_parameters_sample_matches_jax():
    """theta | z, y of two chains on JAX's draws; a sweep on the card's
    own draws stays finite."""
    _, p, ys, _, _ = case()
    rng = np.random.default_rng(8)
    z = rng.integers(0, K, (C, T))
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    want, draws = over_chains(lambda c: jax_gibbs(keys[c], z[c], ys))
    prior = g.default_prior(K, M)
    got = g.gibbs_parameters_sample(None, prior, t(ys), t(z),
                                    draws=g.GibbsDraws(None, *map(t, draws)))
    assert_params(got, want, rtol=1e-9, atol=1e-10)
    sweep = g.gibbs_step(torch.Generator().manual_seed(1), prior, p, t(ys))
    assert all(torch.isfinite(getattr(sweep, f)).all() for f in FIELDS)


@pytest.mark.parametrize("B", [0, 4])
def test_windowed_complete_gradient_on_jax_paths(B):
    """The complete-data score over an edge window (its pre-window state
    completed) and an interior one, two draws each, on the z paths and
    completions the JAX package draws."""
    jp, p, ys, _, _ = case()
    S, ns = 8, 2
    win, valid, wts = rolled_windows(ys, np.array([0, 9]), S, B)
    keys = jax.random.split(jax.random.PRNGKey(10), C)

    def jax_side(key, q, wi, va, wt):
        grad, ll = jg.windowed_complete_gradient(q, wi, va, wt, B, S, key,
                                                 num_samples=ns)

        def paths(k):
            k_ffbs, k_prev = jax.random.split(k)
            zz = jg.latent_var_sample(q, k_ffbs, wi, valid=va)
            p0 = jg.default_forward_message(q).prob
            zi = jax.random.categorical(
                k_prev, jnp.log(p0 * q.pi[:, zz[B]] + 1e-300))
            return zz, zi
        zs, zis = jax.vmap(paths)(jax.random.split(key, ns))
        return grad, ll, zs, zis
    side = jit(jax_side)
    want, want_ll, zs, zis = over_chains(lambda c: side(
        keys[c], chain(jp, c), win[c], valid[c], wts[c]))
    got, got_ll = g.windowed_complete_gradient(
        p, t(win), t(valid), t(wts), B, S, num_samples=ns,
        z=t(zs).long(), z_init=t(zis).long())
    assert_params(got, want)
    close(got_ll, want_ll)


# --------------------------------------------------------------------------
# in law: FFBS and the complete-data score
# --------------------------------------------------------------------------

def chi2_pvalue(z, probs):
    """The chi-square goodness of fit of draws z [N, T] to per-t
    probabilities [T, K], pooled over t."""
    n = z.shape[0]
    k = probs.shape[-1]
    counts = np.stack([(z == j).sum(0) for j in range(k)], -1)
    expected = n * probs
    stat = ((counts - expected) ** 2 / expected).sum()
    return stats.chi2.sf(stat, probs.shape[0] * (k - 1))


def test_ffbs_marginals_match_posterior_marginals():
    """4000 FFBS paths per t against the smoothed marginals (chi-square,
    p > 1e-3), and with a valid gate against the marginals of the series
    without the invalid rows (which copy a neighbouring draw)."""
    rng = np.random.default_rng(11)
    p = g.from_values([[0.8, 0.2], [0.3, 0.7]], [[-1.0], [1.0]],
                      np.stack([np.eye(1) * 0.6] * 2))
    ys = t(rng.standard_normal((25, 1)))
    gen = torch.Generator().manual_seed(12)
    n = 4000
    z = g.latent_var_sample(p, gen, ys, num_samples=n)[0].numpy()
    probs = g.latent_var_distr(p, ys)[0].numpy()
    assert chi2_pvalue(z, probs) > 1e-3
    v = np.ones(25)
    v[[0, 1, 10, 11, 12, 24]] = 0.0
    zv = g.latent_var_sample(p, gen, ys, num_samples=n,
                             valid=t(v))[0].numpy()
    keep = v > 0
    probs_v = g.latent_var_distr(p, ys[keep])[0].numpy()
    assert chi2_pvalue(zv[:, keep], probs_v) > 1e-3
    # the placeholders: an invalid row copies the next valid draw (the
    # backward fill), the invalid tail the last valid one
    for row, src in ((0, 2), (1, 2), (10, 13), (12, 13), (24, 23)):
        np.testing.assert_array_equal(zv[:, row], zv[:, src])


@pytest.mark.parametrize("B", [0, 3])
def test_complete_score_mean_matches_marginal_gradient(B):
    """The Fisher identity on an edge window (start 0: the pre-window
    state completed, and with B > 0 invalid buffer rows): the
    complete-data score over 3000 independent rows within |z| < 5 of the
    windowed marginal gradient."""
    rng = np.random.default_rng(13)
    p1 = g.from_values([[0.85, 0.15], [0.25, 0.75]], [[-1.5], [1.5]],
                       np.stack([np.eye(1) * 0.4] * 2))
    ys = rng.standard_normal((30, 1)) * 1.5
    S, R = 10, 3000
    win, valid, wts = rolled_windows(ys, np.array([0]), S, B)
    exact, _ = g.windowed_marginal_gradient(p1, t(win), t(valid), t(wts),
                                            B, S)
    rows = g.GaussHMMParams(*[x.expand((R,) + x.shape[1:])
                              for x in (p1.logit_pi, p1.mu, p1.LRinv_vec)])
    grad, ll = g.windowed_complete_gradient(
        rows, t(win).expand(R, -1, -1), t(valid).expand(R, -1),
        t(wts).expand(R, -1), B, S,
        generator=torch.Generator().manual_seed(14))
    assert torch.isfinite(ll).all()
    for f in FIELDS:
        draws = getattr(grad, f).reshape(R, -1).numpy()
        want = getattr(exact, f).reshape(-1).numpy()
        se = draws.std(0) / np.sqrt(R) + 1e-12
        zscore = np.abs(draws.mean(0) - want) / se
        assert zscore.max() < 5, (f, zscore)
