"""The port's ARPHMM against the JAX package, and the HMM family's samplers
(SGLD on the exact messages, the complete kind, SCIR, Gibbs, the Seq
samplers, predict, metric_compare_z) and the experiment driver's HMM grid
on the CPU.

Both sides get the same numpy inputs.  The ARPHMM's deterministic
functions are held in float64 at rtol 1e-10 (atol 1e-12), its Gibbs update
on the draws the JAX side makes (rebuilt from its keys); the sampler paths
by their invariants: ``kind=None`` is the exact messages' score, SCIR keeps
every transition row on the simplex, Gibbs recovers the means at the sizes
of tests/test_gauss_hmm.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgmcmc_tpu_torch
from sgmcmc_tpu.models import arphmm as ja
from sgmcmc_tpu_torch.experiments import driver
from sgmcmc_tpu_torch.inference import samplers
from sgmcmc_tpu_torch.io import checkpoint as ckpt
from sgmcmc_tpu_torch.metrics import metric_functions as mf
from sgmcmc_tpu_torch.models import arphmm as a
from sgmcmc_tpu_torch.models import gauss_hmm, registry

torch.set_num_threads(1)

jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
F64 = dict(rtol=1e-10, atol=1e-12)
f64 = jnp.float64
FIELDS = ("logit_pi", "D", "LRinv_vec")
K, M, P, T, C = 2, 2, 2, 24, 2
S, B = 8, 4


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **(tol or F64))


def assert_params(got, want, **tol):
    for f in FIELDS:
        close(getattr(got, f), getattr(want, f), err_msg=f, **(tol or F64))


def t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def case():
    """(JAX chains, port chains, raw y [T+p, m], stacked y, weights, valid,
    rolled windows at B and at 0)."""
    rng = np.random.default_rng(0)
    ps = []
    for _ in range(C):
        A = rng.standard_normal((K, M, M)) * 0.3
        ps.append(ja.from_values(
            rng.dirichlet(np.ones(K) * 3, size=K),
            rng.standard_normal((K, M, M * P)) * 0.4,
            A @ np.swapaxes(A, -1, -2) + np.eye(M) * 0.5))
    jp = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *ps)
    jp = jp.replace(LRinv_vec=jp.LRinv_vec.at[1, 0, 2].multiply(-1.0))
    y_raw = rng.standard_normal((T + P, M))
    ys = np.asarray(ja.stack_y(jnp.asarray(y_raw), P))
    w = rng.uniform(0.5, 2.0, T)
    v = (np.arange(T) % 5 != 2).astype(np.float64)
    wins = {}
    for b in (0, B):
        starts = np.array([0, 11])
        idx = starts[:, None] - b + np.arange(S + 2 * b)
        valid = ((idx >= 0) & (idx < T)).astype(np.float64)
        s = starts[:, None] + np.arange(S)
        cnt = np.minimum(np.minimum(s + 1, S), np.minimum(T - S + 1, T - s))
        wins[b] = (ys[np.clip(idx, 0, T - 1)], valid, (T - S + 1) / cnt)
    return jp, a.params_from_jax(jp), y_raw, ys, w, v, wins


@jit
def jax_side(jp, ys, w, v, win0, val0, wt0, win, val, wt, key):
    """Per chain: every deterministic function of the ARPHMM, and the
    Gibbs update with the draws it makes."""
    prior = ja.default_prior(K, M, M * P)
    out = dict(
        ll=[ja.marginal_loglikelihood(jp, ys),
            ja.marginal_loglikelihood(jp, ys, weights=w, valid=v)],
        grad=[ja.gradient_marginal_loglikelihood(jp, ys, weights=w,
                                                 use_scir=u, valid=v)
              for u in (False, True)],
        windowed=[ja.windowed_marginal_gradient(jp, win0, val0, wt0, 0, S),
                  ja.windowed_marginal_gradient(jp, win, val, wt, B, S),
                  ja.windowed_marginal_gradient(jp, win, val, wt, B, S,
                                                use_scir=True)],
        distr=[ja.latent_var_distr(jp, ys, lag=lag)
               for lag in (None, 0, -2, 3)],
        pred=[ja.predictive_loglikelihood(jp, ys, lag=lag)
              for lag in (0, 1, 2)],
        lp=ja.logprior(prior, jp),
        glp=[ja.grad_logprior(prior, jp, use_scir=u) for u in (False, True)],
        proj=[ja.project_parameters(jp),
              ja.project_parameters(jp, center_logit=False)],
        pre=ja.precondition(jp, ja.gradient_marginal_loglikelihood(jp, ys)),
        corr=ja.correction_term(jp))
    # the Gibbs update on a z path, and the draws it makes from its key
    z = (jnp.arange(T) // 3) % K
    zo = jax.nn.one_hot(z, K, dtype=f64)
    kp, kr, kd = jax.random.split(key, 3)

    def wishart(k, df):
        k_diag, k_off = jax.random.split(k)
        return (2.0 * jax.random.gamma(k_diag, (df - jnp.arange(M)) / 2.0,
                                       dtype=f64),
                jax.random.normal(k_off, (M * (M - 1) // 2,), f64))
    chi2, off = jax.vmap(wishart)(jax.random.split(kr, K),
                                  prior.df_Rinv + zo.sum(0))
    out["gibbs"] = ja.gibbs_parameters_sample(key, prior, ys, z)
    out["gibbs_draws"] = (
        jax.random.gamma(kp, prior.alpha_pi + zo[:-1].T @ zo[1:], dtype=f64),
        chi2, off, jax.random.normal(kd, (K, M, M * P), f64))
    out["z"] = z
    return out


def test_arphmm_matches_jax():
    """stack_y, the marginal log-likelihood (weighted, valid-gated), both
    gradients, the windowed gradients at B = 0 and 4 (plain and use_scir),
    the lagged marginals, the predictive log-likelihood, the prior and its
    gradients, the projection, the preconditioner, the correction term and
    the Gibbs update on JAX's draws, for two chains."""
    jp, p, y_raw, ys, w, v, wins = case()
    close(a.stack_y(t(y_raw), P), ys)
    keys = jax.random.split(jax.random.PRNGKey(1), C)
    outs = [jax_side(jax.tree_util.tree_map(lambda x: x[c], jp), ys, w, v,
                     *[x[c] for x in wins[0] + wins[B]], keys[c])
            for c in range(C)]
    want = jax.tree_util.tree_map(lambda *x: np.stack(x), *outs)
    y = t(ys)
    close(a.marginal_loglikelihood(p, y), want["ll"][0])
    close(a.marginal_loglikelihood(p, y, weights=t(w), valid=t(v)),
          want["ll"][1])
    for u, wg in zip((False, True), want["grad"]):
        assert_params(a.gradient_marginal_loglikelihood(
            p, y, weights=t(w), use_scir=u, valid=t(v)), wg)
    for (b, u), (wg, wl) in zip(((0, False), (B, False), (B, True)),
                                want["windowed"]):
        got, gl = a.windowed_marginal_gradient(p, *map(t, wins[b]), b, S,
                                               use_scir=u)
        assert_params(got, wg)
        close(gl, wl)
    for lag, wd in zip((None, 0, -2, 3), want["distr"]):
        close(a.latent_var_distr(p, y, lag=lag), wd)
    for lag, wp in zip((0, 1, 2), want["pred"]):
        close(a.predictive_loglikelihood(p, y, lag=lag), wp)
    prior = a.default_prior(K, M, M * P)
    close(a.logprior(prior, p), want["lp"])
    for u, wg in zip((False, True), want["glp"]):
        assert_params(a.grad_logprior(prior, p, use_scir=u), wg)
    assert_params(a.project_parameters(p), want["proj"][0])
    assert_params(a.project_parameters(p, center_logit=False),
                  want["proj"][1])
    assert_params(a.precondition(p, a.gradient_marginal_loglikelihood(p, y)),
                  want["pre"])
    assert_params(a.correction_term(p), want["corr"])
    got = a.gibbs_parameters_sample(
        None, prior, y, t(want["z"]).long(),
        draws=a.GibbsDraws(None, *map(t, want["gibbs_draws"])))
    assert_params(got, want["gibbs"], rtol=1e-9, atol=1e-10)


# --------------------------------------------------------------------------
# the samplers on the CPU
# --------------------------------------------------------------------------

TRUTH = {name: driver._make_true_params(name)
         for name in ("gauss_hmm", "arphmm")}


def hmm_sampler(name, T_len=60, seed=0, **kw):
    ys, zs = registry.get_model(name).generate_data(
        torch.Generator().manual_seed(seed), TRUTH[name], T_len)
    return samplers.sampler_for_model(name, observations=ys, device="cpu",
                                      seed=seed + 1, **kw), zs


FIT = dict(subsequence_length=16, buffer_length=4)


@pytest.mark.parametrize("name", ["gauss_hmm", "arphmm"])
def test_sampler_end_to_end(name):
    """At 3 chains: kind=None is the exact messages' score (the same trace
    as kind='marginal'), the complete kind runs, SCIR keeps every
    transition row on the simplex with positive entries, a Gibbs sweep
    and SGRLD run; then predict and metric_compare_z on one chain."""
    s, zs = hmm_sampler(name)
    twin, _ = hmm_sampler(name)
    assert s._default_kind() == "marginal"
    assert s.observations.dtype == s.parameters.logit_pi.dtype == \
        torch.float64
    tr = s.fit_scan("SGLD", num_iters=2, num_chains=3, chain_init="prior",
                    **FIT)
    tw = twin.fit_scan("SGLD", num_iters=2, num_chains=3, chain_init="prior",
                       kind="marginal", **FIT)
    for f in ("logit_pi", "LRinv_vec"):
        assert torch.equal(getattr(tr, f), getattr(tw, f))
    tc = s.fit_scan("SGLD", num_iters=2, kind="complete", num_samples=2,
                    **FIT)
    assert torch.isfinite(tc.logit_pi).all()
    for _ in range(3):
        s.sample_sgld_scir(0.1, **FIT)
    pi = s.parameters.pi
    assert pi.shape == (3, 2, 2) and (pi > 0).all()
    close(pi.sum(-1), np.ones((3, 2)))
    s.sample_gibbs()
    s.fit_scan("SGRLD", num_iters=1, **FIT)
    assert all(torch.isfinite(x).all() for x in
               (s.parameters.logit_pi, s.parameters.LRinv_vec))
    s.select_chain(0)
    probs = s.predict()
    assert probs.shape == (60, 2)
    close(probs.sum(-1), np.ones(60))
    assert s.predict(num_samples=3).shape == (3, 60)
    assert s.predict(num_samples=2, distr="marginal", lag=2).shape == (2, 60)
    with pytest.raises(NotImplementedError, match="target='y'"):
        s.predict(target="y")
    with pytest.raises(NotImplementedError, match="particle filter"):
        s.predict(kind="pf")
    rows = mf.metric_compare_z(zs.numpy())(s)
    assert [r["metric"] for r in rows] == ["z_nmi", "precision", "recall",
                                           "z_accuracy"]
    assert np.isfinite(s.exact_loglikelihood())
    assert np.isfinite(s.predictive_loglikelihood(lag=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        samplers.sampler_for_model(name, observations=s.observations)


def test_default_kind_of_the_particle_models_stays_pf():
    ys = np.zeros((10, 1), np.float32)
    for cls in (samplers.SVMSampler, samplers.GARCHSampler,
                samplers.SVJMSampler, samplers.LGSSMSampler):
        assert cls(ys, device="cpu")._default_kind() == "pf"
    for name in ("GaussHMMSampler", "ARPHMMSampler", "SeqGaussHMMSampler",
                 "SeqARPHMMSampler"):
        assert name in sgmcmc_tpu_torch.__all__


def test_gibbs_recovers_the_means():
    """The model and sizes of tests/test_gauss_hmm.py (mu = -2, 2, T=500,
    var=10, 60 sweeps, the last 40 averaged) on 3 chains at once from a
    neutral start (pi uniform, mu = -0.5, 0.5, R = 1): the sorted means
    within 0.3.  (A prior draw can start the sampler in the mode where the
    states alternate every step, pi near [[0, 1], [1, 0]], with one
    emission for both; the JAX package's sampler stays there too.)"""
    rng = np.random.default_rng(6)
    truth = gauss_hmm.from_values(rng.dirichlet(np.ones(2) * 3, size=2),
                                  [[-2.0], [2.0]],
                                  np.stack([np.eye(1) * 0.3,
                                            np.eye(1) * 0.5]))
    gen = torch.Generator().manual_seed(7)
    ys, _ = gauss_hmm.generate_data(gen, truth, 500)
    start = gauss_hmm.from_values(np.full((2, 2), 0.5), [[-0.5], [0.5]],
                                  np.eye(1))
    s = samplers.GaussHMMSampler(ys, device="cpu", seed=8, parameters=start,
                                 prior=gauss_hmm.default_prior(2, 1, 10.0))
    s._chain_init_params(3, "replicate")
    mus = []
    for i in range(60):
        s.sample_gibbs()
        if i >= 20:
            mus.append(np.sort(s.parameters.mu[..., 0].numpy(), -1))
    est = np.mean(mus, axis=0)
    np.testing.assert_allclose(est, np.array([[-2.0, 2.0]] * 3), atol=0.3)


def test_seq_samplers():
    """SeqGaussHMMSampler and SeqARPHMMSampler: fits (one sequence a
    gradient, and whole sequences), the exact log-likelihood as the sum of
    the sequences', predict and the predictive log-likelihood."""
    gen = torch.Generator().manual_seed(9)
    for name, cls in (("gauss_hmm", samplers.SeqGaussHMMSampler),
                      ("arphmm", samplers.SeqARPHMMSampler)):
        model = registry.get_model(name)
        seqs = [model.generate_data(gen, TRUTH[name], n)[0]
                for n in (30, 45, 25)]
        s = cls(seqs, device="cpu", parameters=TRUTH[name])
        want = sum(float(model.marginal_loglikelihood(TRUTH[name], q)[0])
                   for q in seqs)
        close(s.exact_loglikelihood(), want)
        s.fit_scan("SGLD", num_iters=2, num_chains=2, num_sequences=1,
                   subsequence_length=8, buffer_length=2)
        s.fit_scan("SGLD", num_iters=1, subsequence_length=-1)
        assert torch.isfinite(s.exact_loglikelihood()).all()
        s.select_chain(0)
        out = s.predict()
        assert [o.shape for o in out] == [(30, 2), (45, 2), (25, 2)]
        assert np.isfinite(s.predictive_loglikelihood())


def test_driver_hmm_grid(tmp_path):
    """--setup / --fit / --eval / --trace_eval for the GaussHMM over its
    grid (GIBBS, SGLD at B = 0 and 4, SCIR; two iterations each), then
    process_out; the ARPHMM's setup and one SCIR fit."""
    args = driver.build_parser().parse_args(
        ["--path", str(tmp_path / "g"), "--model", "gauss_hmm", "--device",
         "cpu", "--T", "60", "--T_test", "40", "--num_to_eval", "2",
         "--eval_predictive", "2", "--max_ksd_samples", "4"])
    grid = [dict(o, max_num_iters=2, steps_per_iteration=2)
            for o in driver.default_sampler_grid("gauss_hmm")]
    opts = driver.do_setup(args, grid)
    assert sorted({o["name"] for o in opts}) == ["GIBBS", "SCIR", "SGLD"]
    assert len(opts) == 8
    data = ckpt.load_pickle(str(tmp_path / "g" / "in" / "data.p"))
    assert data["observations"].shape == (60, 1)
    assert data["latent_vars"].dtype == np.int64
    for o in opts:
        smp = driver.do_fit(args, o)
        assert torch.isfinite(smp.parameters.logit_pi).all(), o["name"]
    ev = next(o for o in opts if o["name"] == "SCIR")
    driver.do_eval(args, ev, "half_avg_test")
    ksd = driver.do_eval_ksd(args, ev)
    assert set(ksd) == {"logit_pi", "mu", "tau"}
    rows = driver.do_eval_ks_test(args, ev, opts)
    assert rows and all(0 <= r["value"] <= 1 for r in rows)
    agg = driver.do_process_out(args, opts)
    assert any(r.get("metric") == "2_pred_loglikelihood" for r in agg.rows)
    aargs = driver.build_parser().parse_args(
        ["--path", str(tmp_path / "a"), "--model", "arphmm", "--device",
         "cpu", "--T", "40", "--T_test", "30"])
    aopts = driver.do_setup(aargs, [
        dict(o, max_num_iters=2, steps_per_iteration=1)
        for o in driver.default_sampler_grid("arphmm")
        if o["name"] == "SCIR"])
    smp = driver.do_fit(aargs, aopts[0])
    assert smp.observations.shape == (40, 2, 1)
    args.num_chains = 3
    with pytest.raises(ValueError, match="gradient iter_type"):
        driver.do_fit(args, next(o for o in opts if o["name"] == "SCIR"))
