"""The port's switching LDS (``models/slds.py``, ``SLDSSampler``, its
registry entry) against the JAX package.

Both sides get the same numpy inputs, in float64, for two chains of
distinct parameters at K=2, n=m=1 (T=30) and K=3, n=m=2 (T=25).  Held at
rtol 1e-10 (atol 1e-12): the x | z messages and ``x_marginal_loglikelihood``
on one z path, the AR log-likelihoods and ``z_marginal_loglikelihood`` on
one x path, the complete-data log-likelihood and its score, the windowed
complete-data pair at B = 0 and B = 4 (step weights zero on the buffers),
the prior, its score, the projection and the conjugate posterior's
hyperparameters.  The draw-fed functions get the draws the JAX side
makes, rebuilt from its keys, at rtol 1e-10 (atol 1e-10): the x | z FFBS
(its normals), the conjugate theta update and the prior draw (the
Dirichlet's gammas, the Wishart chi-squares and off-diagonal normals, the
matrix-normal normals).  Named exception: the z | x FFBS draws by the
inverse CDF where the JAX package draws Gumbel-max; it is held in law,
by a chi-square of 4000 paths against the exact distribution of z | x
enumerated over the 2^5 paths of a short series.  ``SLDSSampler`` runs
end to end at 3 chains on the CPU.
"""
import functools
import itertools
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import sgmcmc_tpu_torch
from sgmcmc_tpu.models import slds as js
from sgmcmc_tpu_torch.inference import samplers
from sgmcmc_tpu_torch.models import registry
from sgmcmc_tpu_torch.models import slds as s
from sgmcmc_tpu_torch.models.base import params_map

torch.set_num_threads(1)

# The JAX side is compiled without XLA's backend optimisations: it runs
# once per shape, and the compile is most of its time.
OPTIONS = {"xla_backend_optimization_level": 0}
jit = functools.partial(jax.jit, compiler_options=OPTIONS)
F64 = dict(rtol=1e-10, atol=1e-12)
DRAWN = dict(rtol=1e-10, atol=1e-10)
f64 = jnp.float64
FIELDS = ("logit_pi", "A", "LQinv_vec", "C", "LRinv_vec")
CASES = [(2, 1, 1, 30), (3, 2, 2, 25)]
C = 2
B_WIN = 4


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               **(tol or F64))


def assert_params(got, want, **tol):
    for f in FIELDS:
        close(getattr(got, f), getattr(want, f), err_msg=f, **tol)


def t(a):
    return torch.from_numpy(np.array(a))


def stack(outs):
    return jax.tree_util.tree_map(lambda *v: np.stack(v), *outs)


def jax_chain(K, n, m, seed):
    """One chain's JAX parameters: distinct pi, rotations A_k, correlated
    Q_k and R, a full C."""
    rng = np.random.default_rng(seed)
    A = 0.8 * np.stack([np.linalg.qr(rng.normal(size=(n, n)))[0]
                        for _ in range(K)])
    Bq = rng.normal(size=(K, n, n)) * 0.3
    Br = rng.normal(size=(m, m)) * 0.3
    return js.from_values(
        rng.dirichlet(np.ones(K) * 3, size=K), A,
        Bq @ np.swapaxes(Bq, -1, -2) + 0.5 * np.eye(n),
        rng.normal(size=(m, n)), Br @ Br.T + 0.4 * np.eye(m))


def step_weights(T, B):
    """Window weights: zero on the B buffer steps at each end, positive in
    between."""
    w = np.random.default_rng(B).uniform(0.5, 2.0, T)
    w[:B] = 0.0
    w[T - B:] = 0.0
    return w


@functools.lru_cache(maxsize=None)
def case(K, n, m, T):
    """(JAX chains, port chains [C], ys [T, m], x [C, T, n], z [C, T])."""
    jps = [jax_chain(K, n, m, 10 * K + c) for c in range(C)]
    rng = np.random.default_rng(K + T)
    ys = rng.normal(size=(T, m)) * 1.5
    x = rng.normal(size=(C, T, n))
    z = rng.integers(0, K, (C, T))
    return jps, s.params_from_jax(stack(jps)), ys, x, z


def compile_all(jobs):
    """The executables of ``jobs`` ((function, example arguments) pairs):
    each traced here and compiled on a thread of its own while the next
    one traces (XLA's compiler runs outside the interpreter's lock)."""
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(jax.jit(fn).lower(*args).compile, OPTIONS)
                   for fn, args in jobs]
        return [f.result() for f in futures]


def jax_reference(jp, key, ys, x, z, w0, wb):
    """One chain's deterministic functions, and its x | z FFBS from
    ``key`` with the normals it draws, rebuilt from the key (the last
    state's, then one a backward step)."""
    K, n, m = jp.num_states, jp.n, jp.m
    T = ys.shape[0]
    prior = js.default_prior(K, n, m)
    # a negative Cholesky diagonal for the projection to reflect
    neg = jp.replace(LQinv_vec=jp.LQinv_vec.at[0, 0].multiply(-1.0),
                     LRinv_vec=jp.LRinv_vec.at[0].multiply(-1.0))
    kl, kr = jax.random.split(key)
    rest = jax.vmap(lambda k: jax.random.normal(k, (n,), f64))(
        jax.random.split(kr, T - 1))
    fwd = js.x_forward_messages(jp, ys, z)
    # the likelihood and the FFBS call the module's x_forward_messages on
    # the same inputs: while this traces, they get the first call's
    # result, so its scan is traced and compiled once
    with mock.patch.object(js, "x_forward_messages", lambda *_: fwd):
        x_ll = js.x_marginal_loglikelihood(jp, ys, z)
        x_draw = js.x_latent_var_sample(jp, key, ys, z)
    return dict(
        fwd=fwd, x_ll=x_ll,
        ar=js.ar_logliks(jp, x),
        z_ll=js.z_marginal_loglikelihood(jp, ys, x),
        cd=js.complete_data_loglikelihood(jp, ys, x, z),
        cd_grad=js.gradient_complete_data_loglikelihood(jp, ys, x, z),
        win=jax.vmap(lambda w: js.windowed_complete_gradient(
            jp, ys, x, z, w))(jnp.stack([w0, wb])),
        lp=js.logprior(prior, jp), lp_grad=js.grad_logprior(prior, jp),
        proj=js.project_parameters(neg),
        proj_free=js.project_parameters(neg, a_threshold=0.5,
                                        fix_C_eye=False),
        post=js.gibbs_posterior_params(prior, ys, x, z), x_draw=x_draw,
        normals=jnp.concatenate([rest[::-1], jax.random.normal(
            kl, (n,), f64)[None]]))


def wishart_draws(key, df, k):
    """The chi-squares and off-diagonal normals the JAX package's
    sample_wishart draws from ``key``."""
    kd, ko = jax.random.split(key)
    return (2.0 * jax.random.gamma(kd, (df - jnp.arange(k)) / 2.0, dtype=f64),
            jax.random.normal(ko, (k * (k - 1) // 2,), f64))


def jax_gibbs_draws(key, ys, z):
    """The draws of gibbs_parameters_sample(key, ...) at K=3, n=m=2
    (``CASES[1]``), rebuilt from the key: the Dirichlet's gammas, each
    state's Wishart draws and A_k normals, then R^-1's and C's."""
    K, n, m = 3, 2, 2
    prior = js.default_prior(K, n, m)
    zo = jax.nn.one_hot(z, K, dtype=f64)
    kp, kq, kr = jax.random.split(key, 3)
    kvm = jax.vmap(jax.random.split)(jax.random.split(kq, K))
    q_chi2, q_off = jax.vmap(wishart_draws, in_axes=(0, 0, None))(
        kvm[:, 0], prior.df_Qinv + zo[1:].sum(0), n)
    kv, km = jax.random.split(kr)
    return (jax.random.gamma(kp, prior.alpha_pi + zo[:-1].T @ zo[1:],
                             dtype=f64), q_chi2, q_off,
            jax.vmap(lambda k: jax.random.normal(k, (n, n), f64))(
                kvm[:, 1]), *wishart_draws(kv, prior.df_Rinv + ys.shape[0],
                                           m),
            jax.random.normal(km, (m, n), f64))


def jax_prior_draws(key):
    """The draws of sample_prior(key, ...) at K=3, n=m=2."""
    K, n, m = 3, 2, 2
    prior = js.default_prior(K, n, m)
    kp, kq, ka, kr, kc = jax.random.split(key, 5)
    q_chi2, q_off = jax.vmap(wishart_draws, in_axes=(0, None, None))(
        jax.random.split(kq, K), prior.df_Qinv, n)
    return (jax.random.gamma(kp, prior.alpha_pi, dtype=f64), q_chi2, q_off,
            jax.random.normal(ka, (K, n, n), f64),
            *wishart_draws(kr, prior.df_Rinv, m),
            jax.random.normal(kc, (m, n), f64))


def jax_gibbs(key, ys, x, z):
    return js.gibbs_parameters_sample(key, js.default_prior(3, 2, 2), ys, x,
                                      z)


def jax_prior(key):
    return js.sample_prior(js.default_prior(3, 2, 2), key)


def keys_of(seed):
    return jax.random.split(jax.random.PRNGKey(seed), C)


@functools.lru_cache(maxsize=None)
def references():
    """({case: JAX's :func:`jax_reference` stacked over the chains}, [the
    conjugate update, its draws, the prior draw, its draws] of the chains
    of ``CASES[1]``), every JAX function compiled at once."""
    args = {}
    for K, n, m, T in CASES:
        jps, _, ys, x, z = case(K, n, m, T)
        args[(K, n, m, T)] = [(jp, keys_of(K)[c], ys, x[c], z[c],
                               step_weights(T, 0), step_weights(T, B_WIN))
                              for c, jp in enumerate(jps)]
    _, _, ys, x, z = case(*CASES[1])
    keys = keys_of(7)
    theta = [(jax_gibbs, [(keys[c], ys, x[c], z[c]) for c in range(C)]),
             (jax_gibbs_draws, [(keys[c], ys, z[c]) for c in range(C)]),
             (jax_prior, [(keys[c],) for c in range(C)]),
             (jax_prior_draws, [(keys[c],) for c in range(C)])]
    exes = compile_all([(jax_reference, args[k][0]) for k in CASES]
                       + [(fn, a[0]) for fn, a in theta])
    return ({k: stack([exe(*a) for a in args[k]])
             for exe, k in zip(exes, CASES)},
            [stack([exe(*a) for a in fa[1]])
             for exe, fa in zip(exes[len(CASES):], theta)])


@pytest.mark.parametrize("K,n,m,T", CASES)
def test_deterministic_functions_match_jax(K, n, m, T):
    _, p, ys, x, z = case(K, n, m, T)
    w0, wb = step_weights(T, 0), step_weights(T, B_WIN)
    want = references()[0][(K, n, m, T)]
    y, xt, zt = t(ys), t(x), t(z)
    for got, w in zip(s.x_forward_messages(p, y, zt), want["fwd"]):
        close(got, w)
    close(s.x_marginal_loglikelihood(p, y, zt), want["x_ll"])
    close(s.marginal_loglikelihood(p, y, z=zt), want["x_ll"])
    close(s.ar_logliks(p, xt), want["ar"])
    close(s.z_marginal_loglikelihood(p, y, xt), want["z_ll"])
    close(s.marginal_loglikelihood(p, y, x=xt), want["z_ll"])
    with pytest.raises(NotImplementedError, match="conditioning on x or z"):
        s.marginal_loglikelihood(p, y)
    close(s.complete_data_loglikelihood(p, y, xt, zt), want["cd"])
    assert_params(s.gradient_complete_data_loglikelihood(p, y, xt, zt),
                  want["cd_grad"])
    for i, wts in enumerate((w0, wb)):
        grad, ll = s.windowed_complete_gradient(p, y, xt, zt,
                                                t(wts).expand(C, -1))
        want_grad, want_ll = jax.tree_util.tree_map(lambda v: v[:, i],
                                                    want["win"])
        assert_params(grad, want_grad)
        close(ll, want_ll)
        close(s.windowed_complete_data_loglikelihood(
            p, y, xt, zt, t(wts).expand(C, -1)), want_ll)
    prior = s.default_prior(K, n, m)
    close(s.logprior(prior, p), want["lp"])
    assert_params(s.grad_logprior(prior, p), want["lp_grad"])
    neg = dataclass_negated(p, n, m)
    assert_params(s.project_parameters(neg), want["proj"])
    assert_params(s.project_parameters(neg, a_threshold=0.5,
                                       fix_C_eye=False), want["proj_free"])
    for k, v in s.gibbs_posterior_params(prior, y, xt, zt).items():
        close(v.expand(want["post"][k].shape), want["post"][k], err_msg=k)


def dataclass_negated(p, n, m):
    """``p`` with its first Cholesky diagonals negated, as the JAX side's
    ``neg``."""
    LQ, LR = p.LQinv_vec.clone(), p.LRinv_vec.clone()
    LQ[:, 0, 0] *= -1.0
    LR[:, 0] *= -1.0
    return s.SLDSParams(p.logit_pi, p.A, LQ, p.C, LR)


@pytest.mark.parametrize("K,n,m,T", CASES)
def test_x_ffbs_matches_jax_and_sweep_composes(K, n, m, T):
    """x | z FFBS on JAX's normals; a sweep fed its FFBS normals and
    uniforms is x | z, then z | x, then theta | x, z on the generator's
    draws."""
    _, p, ys, x, z = case(K, n, m, T)
    ref = references()[0][(K, n, m, T)]
    want_x, normals = ref["x_draw"], ref["normals"]
    y, xt, zt = t(ys), t(x), t(z)
    close(s.x_latent_var_sample(p, None, y, zt, t(normals)), want_x,
          **DRAWN)
    prior = s.default_prior(K, n, m)
    u = torch.rand((C, T), generator=torch.Generator().manual_seed(0),
                   dtype=torch.float64)
    got, x1, z1 = s.gibbs_step(torch.Generator().manual_seed(1), prior, p, y,
                               xt, zt, s.SLDSDraws(x_normals=t(normals),
                                                   z_uniforms=u))
    close(x1, want_x, **DRAWN)
    torch.testing.assert_close(z1, s.z_latent_var_sample(p, None, y, x1, u),
                               rtol=0, atol=0)
    assert_params(got, s.gibbs_parameters_sample(
        torch.Generator().manual_seed(1), prior, y, x1, z1), rtol=0, atol=0)


def test_conjugate_update_and_prior_draw_match_jax():
    """theta | x, z and the prior draw on JAX's gammas, Wishart draws and
    normals, at K=3, n=m=2 (every block full: the Wishart's off-diagonal
    normals, the matrix normals' row and column factors; JAX's compile of
    its gamma sampler makes a second case the file's slowest part)."""
    K, n, m, T = CASES[1]
    _, _, ys, x, z = case(K, n, m, T)
    want_theta, gibbs, want_prior, drawn = references()[1]
    prior = s.default_prior(K, n, m)
    theta = s.gibbs_parameters_sample(None, prior, t(ys), t(x), t(z),
                                      s.SLDSDraws(*map(t, gibbs)))
    assert_params(theta, want_theta, **DRAWN)
    assert_params(s.sample_prior(prior, None, C, s.SLDSDraws(
        *map(t, drawn))), want_prior, **DRAWN)


def enumerated_z_posterior(p, x):
    """Pr(z | x) of every path of chain 0, by enumeration (z_0 from the
    uniform initial message propagated one step, as the FFBS draws it)."""
    logP = s.ar_logliks(p, x)[0].numpy()
    pi = p.pi[0].numpy()
    T, K = logP.shape
    p0 = np.full(K, 1.0 / K) @ pi
    paths = list(itertools.product(range(K), repeat=T))
    lp = np.array([np.log(p0[zz[0]]) + logP[0, zz[0]] + sum(
        np.log(pi[zz[i - 1], zz[i]]) + logP[i, zz[i]] for i in range(1, T))
        for zz in paths])
    w = np.exp(lp - lp.max())
    return paths, w / w.sum()


def test_z_ffbs_matches_enumeration_in_law():
    """4000 inverse-CDF FFBS paths of z | x (T=5, K=2) against the exact
    path distribution: chi-square over the paths with 5 or more expected
    draws (the rest pooled), p > 1e-3."""
    jp = jax_chain(2, 1, 1, 3)
    p = s.params_from_jax(jp)
    x = t(np.random.default_rng(1).normal(size=(1, 5, 1)) * 1.2)
    paths, probs = enumerated_z_posterior(p, x)
    R = 4000
    rows = params_map(lambda v: v.expand((R,) + v.shape[1:]), p)
    z = s.z_latent_var_sample(rows, torch.Generator().manual_seed(2), None,
                              x.expand(R, -1, -1))
    index = {zz: i for i, zz in enumerate(paths)}
    counts = np.bincount([index[tuple(r)] for r in z.tolist()],
                         minlength=len(paths))
    expected = R * probs
    keep = expected >= 5
    obs = np.append(counts[keep], counts[~keep].sum())
    exp = np.append(expected[keep], expected[~keep].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    pval = stats.chisquare(obs, exp).pvalue
    assert pval > 1e-3, (pval, counts, expected)


def test_generate_data_recursion():
    """(y, x, z) on given draws: the inverse-CDF z path, then x_t = A_{z_t}
    x_{t-1} + chol(Q_{z_t}) e_t from x_0 = 0 and y_t = C x_t + chol(R)
    e'_t."""
    p = s.params_from_jax(jax_chain(3, 2, 2, 5))
    T = 12
    rng = np.random.default_rng(6)
    u, ex, ey = rng.random(T + 1), rng.normal(size=(T, 2)), rng.normal(
        size=(T, 2))
    ys, xs, zs = s.generate_data(None, p, T, draws=(t(u), t(ex), t(ey)))
    assert ys.shape == (T, 2) and xs.shape == (T, 2) and zs.shape == (T,)
    A, LQ = p.A[0].numpy(), np.linalg.cholesky(p.Q[0].numpy())
    Cm, LR = p.C[0].numpy(), np.linalg.cholesky(p.R[0].numpy())
    xv = np.zeros(2)
    for i, k in enumerate(zs.tolist()):
        xv = A[k] @ xv + LQ[k] @ ex[i]
        close(xs[i], xv)
        close(ys[i], Cm @ xv + LR @ ey[i])
    y2, x2, z2 = registry.get_model("slds", num_states=3, n=2,
                                    m=2).generate_data(
        torch.Generator().manual_seed(0), p, 50)
    assert bool(torch.isfinite(y2).all()) and int(z2.max()) < 3


def test_sampler_end_to_end_on_three_chains():
    """Gibbs fit, both exact likelihoods, the complete-data gradient and
    SGLD step at 3 chains; a mistyped latent option raises."""
    truth = s.from_values([[0.95, 0.05], [0.05, 0.95]], [[[0.9]], [[-0.9]]],
                          [[[0.5]], [[0.5]]], [[1.0]], [[0.5]])
    ys, _, _ = s.generate_data(torch.Generator().manual_seed(3), truth, 40)
    three = params_map(lambda v: v.repeat((3,) + (1,) * (v.dim() - 1)),
                       truth)
    smp = sgmcmc_tpu_torch.SLDSSampler(ys, device="cpu", seed=4,
                                       parameters=three)
    trace = smp.fit(2, output_all=True)
    assert len(trace) == 3 and smp.x.shape == (3, 40, 1)
    assert smp.z.shape == (3, 40) and smp.z.dtype == torch.int64
    for given, fn, latent in (("z", s.x_marginal_loglikelihood, smp.z),
                              ("x", s.z_marginal_loglikelihood, smp.x)):
        ll = smp.exact_loglikelihood(given)
        assert ll.shape == (3,) and bool(torch.isfinite(ll).all())
        close(ll, fn(smp.parameters, smp.observations, latent).numpy())
    with pytest.raises(ValueError, match="given"):
        smp.exact_loglikelihood("y")
    kw = dict(subsequence_length=8, buffer_length=2, latent_burnin=1,
              latent_thinning=1, latent_draws=2, N=100, pf="paris")
    grad = smp.noisy_gradient(**kw)
    assert grad.A.shape == (3, 2, 1, 1)
    assert all(bool(torch.isfinite(getattr(grad, f)).all()) for f in FIELDS)
    smp.sample_sgld(0.01, **kw)
    assert all(bool(torch.isfinite(getattr(smp.parameters, f)).all())
               for f in FIELDS)
    out = smp.noisy_logjoint(return_loglike=True, subsequence_length=-1,
                             latent_burnin=1, latent_thinning=0)
    assert out["loglikelihood"].shape == (3,)
    with pytest.raises(TypeError, match="latent_draw"):
        smp.noisy_gradient(latent_draw=1)
    one = samplers.SLDSSampler(ys, device="cpu", seed=5)
    assert isinstance(one.exact_loglikelihood(), float)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            samplers.SLDSSampler(ys)


def test_registry_and_sampler_for_model():
    api = registry.get_model("slds")
    assert api is registry.get_model("slds", num_states=2, n=1, m=1)
    assert not api.has_pf and api.dtype == torch.float64
    assert api.gibbs_step is s.gibbs_step
    assert api.windowed_complete_gradient is s.windowed_complete_gradient
    prior = registry.get_model("slds", num_states=3, n=2, m=2).default_prior()
    assert prior.mean_A.shape == (3, 2, 2) and prior.scale_Rinv.shape == (2,
                                                                          2)
    draw = api.project_parameters(api.sample_prior(
        api.default_prior(), torch.Generator().manual_seed(0), 4))
    assert draw.A.shape == (4, 2, 1, 1) and bool(torch.isfinite(
        api.logprior(api.default_prior(), draw)).all())
    smp = sgmcmc_tpu_torch.sampler_for_model(
        "slds", observations=np.zeros(20), num_states=3, device="cpu")
    assert isinstance(smp, samplers.SLDSSampler)
    assert smp.model is registry.get_model("slds", num_states=3)
    assert smp.parameters.logit_pi.shape == (1, 3, 3)
    with pytest.raises(ValueError, match="Unknown model"):
        registry.get_model("slds", p=2)
