"""The port's steppers (SGD, SGRLD, ADAGRAD, SGLD-CV), the models'
sufficient statistics and the LGSSM's SGRLD preconditioner, and the
sampler surface (fit_scan for every gradient iter type, fit, fit_timed,
fit_scan_chunked, get_iter_step, select_chain, prior_chain_draws, the
gradient and log-joint methods) against the JAX package.

Deterministic functions are held in float64 at rtol 1e-12 (the 1x1
inverses of the two packages round differently); the steps on a shared
gradient and shared noise (the normals JAX draws from its keys, rebuilt)
at rtol 1e-12; the fits on the LGSSM's exact marginal gradient
(``kind="marginal"``, ``subsequence_length=-1``, deterministic in both
packages), which the port computes in float64 and returns in float32, at
rtol 1e-4, the port's float32 error.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgmcmc_tpu.inference import samplers as jsamplers
from sgmcmc_tpu.inference import sgmcmc as jsg
from sgmcmc_tpu.models import garch as jgarch
from sgmcmc_tpu.models import lgssm as jl
from sgmcmc_tpu.models import svjm as jsvjm
from sgmcmc_tpu.models import svm as jsvm
from sgmcmc_tpu_torch.inference import samplers, sgmcmc
from sgmcmc_tpu_torch.models import garch, lgssm, registry, svjm, svm
from sgmcmc_tpu_torch.models.base import params_map

torch.set_num_threads(1)

jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
FIELDS = ("A", "C", "LQinv_vec", "LRinv_vec")
# (A, Q, R) of two chains, C = 1
CHAINS = [(0.8, 0.5, 1.3), (-0.4, 1.5, 0.6)]
F64 = dict(rtol=1e-12, atol=1e-12)
F32 = dict(rtol=1e-4, atol=1e-5)


def jax_chains(dtype=jnp.float64):
    ps = [jl.from_matrices(A=[[a]], C=[[1.0]], Q=[[q]], R=[[r]], dtype=dtype)
          for a, q, r in CHAINS]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ps)


def assert_params(got, want, fields=FIELDS, **tol):
    for f in fields:
        np.testing.assert_allclose(
            getattr(got, f).detach().double().cpu().numpy().reshape(-1),
            np.asarray(getattr(want, f), np.float64).reshape(-1),
            err_msg=f, **tol)


@pytest.mark.parametrize("name", ["svm", "garch", "svjm"])
def test_suff_statistic_matches_jax(name):
    mod, jmod = {"svm": (svm, jsvm), "garch": (garch, jgarch),
                 "svjm": (svjm, jsvjm)}[name]
    rng = np.random.default_rng(0)
    D = 2 if name == "garch" else 1
    x_t, x_n = rng.standard_normal((2, 2, 9, D))
    got = mod.suff_statistic(None, torch.from_numpy(x_t),
                             torch.from_numpy(x_n), None, 0)
    want = jax.vmap(lambda a, b: jmod.suff_statistic(None, a, b, None, 0))(
        x_t, x_n)
    assert got.shape == (2, 9, 3) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)
    assert registry.get_model(name).suff_statistic_dim == 3


def test_lgssm_preconditioner_matches_jax():
    """precondition, precondition_noise (on the four normals JAX draws from
    its key) and correction_term on two chains."""
    jp = jax_chains()
    rng = np.random.default_rng(1)
    jg = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape), jp)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)

    def one(p, g, key):
        kA, kC, kQ, kR = jax.random.split(key, 4)
        z = [jax.random.normal(k, (1, 1), jnp.float64) for k in (kA, kC)] \
            + [jax.random.normal(k, (1, 1), jnp.float64)[0]
               for k in (kQ, kR)]
        return (jl.precondition(p, g), jl.precondition_noise(p, key),
                jl.correction_term(p), jl.LGSSMParams(*z))

    want_p, want_n, want_c, z = jit(jax.vmap(one))(jp, jg, keys)
    params = lgssm.params_from_jax(jp, torch.float64)
    assert_params(lgssm.precondition(params, lgssm.params_from_jax(
        jg, torch.float64)), want_p, **F64)
    assert_params(lgssm.precondition_noise(params, lgssm.params_from_jax(
        z, torch.float64)), want_n, **F64)
    assert_params(lgssm.correction_term(params), want_c, **F64)
    m = registry.LGSSM
    assert (m.precondition, m.precondition_noise, m.correction_term) == (
        lgssm.precondition, lgssm.precondition_noise, lgssm.correction_term)
    for other in (registry.SVM, registry.GARCH, registry.SVJM):
        assert other.precondition is None


def jax_grad(key, p, obs):
    """A gradient that depends on the parameters (so that SGLD-CV's two
    gradients differ) and a log-likelihood."""
    return jax.tree_util.tree_map(lambda x: 0.3 - 0.7 * x, p), jnp.sum(p.A)


def port_grad(gen, p, obs, draws=None):
    return (params_map(lambda x: 0.3 - 0.7 * x, p),
            p.A.reshape(p.num_chains, -1).sum(1))


port_grad.draw = lambda gen, C, device: None


@pytest.mark.parametrize("step", ["sgd", "sgrld", "adagrad", "sgld_cv"])
def test_step_matches_jax_on_shared_gradient_and_noise(step):
    """One step of each stepper (ADAGRAD: two, so that its state
    accumulates) on two chains, float64, with make_noisy_grad_fn around
    the same score; the Langevin noise is the normals JAX draws from its
    keys."""
    eps, T = 0.05, 20
    jp, jc = jax_chains(), jax.tree_util.tree_map(lambda x: 1.1 * x,
                                                  jax_chains())
    jprior = jl.default_prior(1, 1)
    jprecond = jsg.Preconditioner(jl.precondition, jl.precondition_noise,
                                  jl.correction_term)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    jgf = jsg.make_noisy_grad_fn(
        jax_grad, lambda p: jl.grad_logprior(jprior, p), T,
        preconditioner=jprecond if step == "sgrld" else None)

    def one(key, p, c):
        _, key_noise = jax.random.split(key)
        if step == "sgd":
            return jsg.sgd_step(key, p, None, jgf, eps)[0], p
        if step == "sgrld":
            kA, kC, kQ, kR = jax.random.split(key_noise, 4)
            z = jl.LGSSMParams(*[jax.random.normal(k, (1, 1), jnp.float64)
                                 for k in (kA, kC)],
                               *[jax.random.normal(k, (1, 1), jnp.float64)[0]
                                 for k in (kQ, kR)])
            return jsg.sgrld_step(key, p, None, jgf, jprecond, eps, T)[0], z
        if step == "adagrad":
            st = jsg.adagrad_init(p)
            p1, st, _ = jsg.adagrad_step(key, p, st, None, jgf, eps)
            p2, st, _ = jsg.adagrad_step(key, p1, st, None, jgf, eps)
            return p2, st.G
        cg, _ = jgf(key, c, None)
        return (jsg.sgld_cv_step(key, p, None, jgf, c, cg, eps, T)[0],
                jsg.tree_random_normal(key_noise, p, 1.0))

    want, extra = jit(jax.vmap(one))(keys, jp, jc)
    to = functools.partial(lgssm.params_from_jax, dtype=torch.float64)
    params, centre = to(jp), to(jc)
    prior = lgssm.default_prior(dtype=torch.float64)
    precond = sgmcmc.Preconditioner(lgssm.precondition,
                                    lgssm.precondition_noise,
                                    lgssm.correction_term)
    gf = sgmcmc.make_noisy_grad_fn(
        port_grad, lambda p: lgssm.grad_logprior(prior, p), T,
        preconditioner=precond if step == "sgrld" else None)
    if step == "sgd":
        got = sgmcmc.sgd_step(None, params, None, gf, eps)[0]
    elif step == "sgrld":
        got = sgmcmc.sgrld_step(None, params, None, gf, precond, eps, T,
                                noise=to(extra))[0]
    elif step == "adagrad":
        st = sgmcmc.adagrad_init(params)
        p1, st, _ = sgmcmc.adagrad_step(None, params, st, None, gf, eps)
        got, st, _ = sgmcmc.adagrad_step(None, p1, st, None, gf, eps)
        assert_params(st.G, extra, **F64)
        assert st.t.tolist() == [2, 2]
    else:
        assert gf.draw is port_grad.draw
        cg, _ = gf(None, centre, None)
        got = sgmcmc.sgld_cv_step(None, params, torch.zeros(1), gf, centre,
                                  cg, eps, T, noise=to(extra))[0]
    assert_params(got, want, **F64)


def test_sgld_cv_at_the_centre_is_sgld_with_the_centering_gradient():
    """With theta at the centre, the control variate cancels exactly (both
    gradients on one draw of the particle score, seeds included): the
    SGLD-CV step equals SGLD with the centering gradient, bit for bit."""
    g = torch.Generator().manual_seed(2)
    ys, _ = svm.generate_data(g, svm.from_scalars(0.9, 0.5, 1.0), 40)
    s = samplers.SVMSampler(observations=ys, device="cpu", seed=3)
    kw = dict(N=32, subsequence_length=8, buffer_length=2)
    grad_fn = s._grad_fn(**kw)
    params = svm.SVMParams(A=torch.tensor([0.7, 0.5]).reshape(2, 1, 1),
                           LQinv_vec=torch.tensor([[1.2], [0.8]]),
                           LRinv_vec=torch.tensor([[0.9], [1.1]]))
    c_grad = svm.SVMParams(A=torch.full((2, 1, 1), 0.25),
                           LQinv_vec=torch.full((2, 1), -0.5),
                           LRinv_vec=torch.full((2, 1), 0.125))
    noise = svm.SVMParams(A=torch.randn((2, 1, 1), generator=g),
                          LQinv_vec=torch.randn((2, 1), generator=g),
                          LRinv_vec=torch.randn((2, 1), generator=g))
    got, _ = sgmcmc.sgld_cv_step(torch.Generator().manual_seed(5), params,
                                 s.observations, grad_fn, params, c_grad,
                                 0.1, s.T, noise=noise)
    want, _ = sgmcmc.sgld_step(None, params, s.observations,
                               lambda *a: (c_grad, None), 0.1, s.T,
                               noise=noise)
    for f in ("A", "LQinv_vec", "LRinv_vec"):
        assert torch.equal(getattr(got, f), getattr(want, f))


@functools.lru_cache(maxsize=None)
def lgssm_data(T=12):
    return np.random.default_rng(0).standard_normal((T, 1))


@pytest.mark.parametrize("iter_type", ["SGD", "SGRD", "ADAGRAD"])
def test_fit_scan_matches_jax_on_the_exact_gradient(iter_type):
    """Three iterations of fit_scan on two chains with the LGSSM's exact
    marginal gradient; ADAGRAD twice, continuing its state."""
    ys = lgssm_data()
    kw = dict(num_iters=3, epsilon=0.01, num_chains=2, kind="marginal")
    js = jsamplers.LGSSMSampler(  # parameters given: no prior draw
        observations=ys, seed=0, parameters=jl.from_matrices(
            A=[[0.5]], C=[[1.0]], Q=[[1.0]], R=[[1.0]]))
    want = js.fit_scan(iter_type, chain_init=jax_chains(), **kw)
    s = samplers.LGSSMSampler(observations=ys.astype(np.float32),
                              device="cpu")
    got = s.fit_scan(iter_type, chain_init=lgssm.params_from_jax(
        jax_chains()), **kw)
    assert got.A.shape == (2, 3, 1, 1)
    assert_params(got, want, **F32)
    if iter_type == "ADAGRAD":
        assert_params(s._adagrad_state.G, js._adagrad_state.G, rtol=1e-3)
        assert_params(s.fit_scan(iter_type, **kw), js.fit_scan(
            iter_type, **kw), **F32)
        assert s._adagrad_state.t.tolist() == [6, 6]


def test_sampler_surface_matches_jax():
    """noisy_gradient (with and without the preconditioner),
    exact_logjoint, noisy_logjoint and fit on one chain, on the exact
    marginal gradient."""
    ys = lgssm_data()
    p0 = jl.from_matrices(A=[[0.8]], C=[[1.0]], Q=[[0.5]], R=[[1.3]])
    js = jsamplers.LGSSMSampler(observations=ys, seed=0, parameters=p0)
    s = samplers.LGSSMSampler(observations=ys.astype(np.float32),
                              device="cpu",
                              parameters=lgssm.params_from_jax(p0))
    kw = dict(kind="marginal")
    assert_params(s.noisy_gradient(**kw), js.noisy_gradient(**kw), **F32)
    assert_params(s.noisy_gradient(preconditioner=True, **kw),
                  js.noisy_gradient(preconditioner=True, **kw), **F32)
    np.testing.assert_allclose(s.exact_logjoint(), js.exact_logjoint(),
                               rtol=1e-6)
    joint = s.noisy_logjoint(return_loglike=True, **kw)
    np.testing.assert_allclose(joint["logjoint"], js.exact_logjoint(),
                               rtol=1e-6)
    np.testing.assert_allclose(joint["loglikelihood"],
                               js.exact_loglikelihood(), rtol=1e-6)
    got = s.fit("SGD", 2, epsilon=0.01, output_all=True, **kw)
    want = js.fit("SGD", 2, epsilon=0.01, output_all=True, **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.A.shape == (1, 1, 1)
        assert_params(g, w, **F32)
    sv = samplers.SVMSampler(observations=ys.astype(np.float32),
                             device="cpu")
    sv.parameters = svm.from_scalars(float("nan"), 1.0, 1.0)
    with pytest.raises(ValueError, match="NaNs in gradient"):
        sv.noisy_gradient(N=8)
    sv.noisy_gradient(N=8, check_finite=False)


def svm_sampler(seed=1, T=40):
    g = torch.Generator().manual_seed(0)
    ys, _ = svm.generate_data(g, svm.from_scalars(0.9, 0.5, 1.0), T)
    s = samplers.SVMSampler(observations=ys, device="cpu", seed=seed)
    s.parameters = svm.from_scalars(0.5, 1.0, 2.0)
    return s


KW = dict(N=16, subsequence_length=6, buffer_length=2)


@pytest.mark.parametrize("iter_type", ["SGLD", "ADAGRAD"])
def test_fit_scan_chunked_is_one_fit_scan(iter_type):
    """Chunks of 4 of a 10-iteration fit from the same seed: bitwise equal
    to one fit_scan, stacked (num_chains=3) and as the one chain's list."""
    a, b = svm_sampler(), svm_sampler()
    chunked = a.fit_scan_chunked(iter_type, num_iters=10, chunk_iters=4,
                                 num_chains=3, epsilon=0.05, **KW)
    whole = b.fit_scan(iter_type, num_iters=10, num_chains=3, epsilon=0.05,
                       **KW)
    for f in ("A", "LQinv_vec", "LRinv_vec"):
        assert torch.equal(getattr(chunked, f), getattr(whole, f))
    a, b = svm_sampler(), svm_sampler()
    entries = a.fit_scan_chunked(iter_type, num_iters=10, chunk_iters=4,
                                 epsilon=0.05, **KW)
    whole = b.fit_scan(iter_type, num_iters=10, epsilon=0.05, **KW)
    assert len(entries) == 10 and entries[0].A.shape == (1, 1, 1)
    assert torch.equal(torch.cat([e.A for e in entries]), whole.A)
    with pytest.warns(UserWarning, match="dropping the final 1"):
        thinned = svm_sampler().fit_scan_chunked(
            "SGD", num_iters=9, chunk_iters=4, num_chains=2, record=2, **KW)
    assert thinned.A.shape == (2, 4, 1, 1)


def test_select_chain_and_prior_chain_draws():
    s = svm_sampler()
    first = s.parameters
    init = s.prior_chain_draws(4)
    assert init.A.shape == (4, 1, 1) and s.parameters is first
    assert torch.equal(init.A[:1], first.A)
    s.fit_scan("ADAGRAD", num_iters=2, num_chains=4, chain_init=init, **KW)
    with pytest.raises(ValueError, match="stacked chains"):
        s.prior_chain_draws(2)
    held = s.parameters
    G = s._adagrad_state.G
    assert s.select_chain(2).A.shape == (1, 1, 1)
    assert torch.equal(s.parameters.A, held.A[2:3])
    assert torch.equal(s._adagrad_state.G.A, G.A[2:3])
    assert s._adagrad_state.t.tolist() == [2]
    assert s.select_chain(0) is s.parameters       # one chain: unchanged
    trace = s.fit_scan("ADAGRAD", num_iters=1, **KW)
    assert trace.A.shape == (1, 1, 1) and s._adagrad_state.t.tolist() == [3]
    with pytest.raises(NotImplementedError, match="has no preconditioner"):
        s.fit_scan("SGRLD", num_iters=1, **KW)
    with pytest.raises(NotImplementedError, match="SGLD-CV"):
        s.fit_scan("Gibbs", num_iters=1)


def test_get_iter_step_fit_and_fit_timed():
    s = svm_sampler()
    calls = []
    s.stepped = lambda **k: calls.append(k)
    step = s.get_iter_step("custom")
    assert step(iter_funcs=[("stepped", {"a": 1}), ("stepped", {})]) \
        is s.parameters
    assert calls == [{"a": 1}, {}]
    with pytest.raises(ValueError, match="iter_type"):
        s.get_iter_step("Gibbs")
    out = s.fit("SGLD", 2, epsilon=0.05, output_all=True, **KW)
    assert len(out) == 3 and out[-1] is s.parameters
    for chunk in (None, 3):
        params, times = s.fit_timed("SGD", 0.3, epsilon=0.01, max_samples=4,
                                    chunk_iters=chunk, **KW)
        assert len(params) == len(times) and 2 <= len(params) <= 9
        assert all(p.A.shape == (1, 1, 1) for p in params)
        assert times == sorted(times) and times[0] == 0.0
    lg = samplers.LGSSMSampler(observations=lgssm_data().astype(np.float32),
                               device="cpu", seed=2)
    before = lg.parameters
    after = lg.get_iter_step("Gibbs")()
    assert after is lg.parameters and not torch.equal(after.A, before.A)
    assert float(after.C) == 1.0                  # projected
    assert len(lg.fit("Gibbs", 2, output_all=True)) == 3


def test_trace_size_warning_counts_the_chains_that_run():
    s = svm_sampler()
    s.TRACE_WARN_BYTES = 1000
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s.fit_scan("SGD", num_iters=2, num_chains=4, **KW)   # 4*2*12 bytes
    s.TRACE_WARN_BYTES = 300
    with pytest.warns(UserWarning, match=r"\(4 chains x 10 recorded"):
        s.fit_scan("SGD", num_iters=10, **KW)     # the 4 chains it holds
    s.fit_scan("SGD", num_iters=10, record="none", **KW)


@pytest.mark.parametrize("name", ["svm", "garch", "svjm"])
def test_noisy_loglikelihood_of_the_particle_models(name):
    """The particle filter's log-likelihood with the model's sufficient
    statistic: a float for one chain, [C] for C chains, equal to the
    loglik of the score the sampler builds, on the same draws."""
    cls = {"svm": samplers.SVMSampler, "garch": samplers.GARCHSampler,
           "svjm": samplers.SVJMSampler}[name]
    g = torch.Generator().manual_seed(1)
    model = registry.get_model(name)
    ys, _ = model.generate_data(g, model.project_parameters(
        model.sample_prior(model.default_prior(), g, 1)), 30)
    s = cls(observations=ys, device="cpu", seed=4)
    ll = s.noisy_loglikelihood(N=32)
    assert isinstance(ll, float) and np.isfinite(ll)
    s.fit_scan("SGD", num_iters=1, num_chains=3, epsilon=1e-4, N=16)
    state = s.generator.get_state()
    lls = s.noisy_loglikelihood(N=32, pf="paris")
    s.generator.set_state(state)
    _, want = s._loglik_fn(N=32, pf="paris")(s.generator, s.parameters,
                                             s.observations)
    assert lls.shape == (3,) and torch.equal(lls, want)
    joint = s.noisy_logjoint(N=32)
    assert joint.shape == (3,) and bool(torch.isfinite(joint).all())
