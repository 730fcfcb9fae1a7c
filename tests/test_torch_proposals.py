"""The port's adaptive proposals against the JAX package: the SVM's Laplace
and EP kernels and the SVJM's EP and EP-avg kernels, draw for draw, in
law, and through the samplers.

``propose`` and ``reweight`` are held to the JAX kernels on the normals
JAX draws from its keys (float32, rtol 1e-5, atol 1e-6; the JAX side runs
with x64 off, as the JAX package runs).  A proposal is the fitted mean
plus sd * z, terms of size 1-3 here, and where the two cancel the float32
rounding of either (the EP quadrature sums, which XLA accumulates in
another order) shows as an absolute error of ~5e-7 of their size: the
proposal's rtol is taken on |mean| + |sd * z|, the size of the terms it
sums, and not on their sum.  The SVJM EP jump: JAX draws
``uniform(kj) < x_pJ``, the port ``z_2 < ndtri(x_pJ)``; the port is fed
``z_2 = ndtri(u)`` of JAX's uniform, so the two agree draw for draw (but
on an exact tie).  The EP-avg case runs two chains of different spreads,
so that a mean or variance taken across chains would show.  The law:
JAX's ``tests/test_svm_model.py`` check that the adaptive proposals
estimate the log-likelihood the bootstrap kernel does (mean within rtol
0.03 over 12 runs) with no more than 1.5x its spread, on the port.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgmcmc_tpu.models import svjm as jsvjm
from sgmcmc_tpu.models import svm as jsvm
from sgmcmc_tpu_torch.inference.samplers import SVJMSampler, SVMSampler
from sgmcmc_tpu_torch.models import registry, svjm, svm
from sgmcmc_tpu_torch.models.base import params_map
from sgmcmc_tpu_torch.ops import buffered

torch.set_num_threads(1)

jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
N = 48
TOL = dict(rtol=1e-5, atol=1e-6)
# (port module, JAX module, JAX parameters of two chains)
MODELS = {
    "svm": (svm, jsvm, [jsvm.from_scalars(0.8, 0.6, 1.1),
                        jsvm.from_scalars(-0.5, 1.2, 0.4)]),
    "svjm": (svjm, jsvjm, [jsvjm.from_scalars(0.9, 0.5, 1.0, 0.1, 2.0),
                           jsvjm.from_scalars(-0.6, 1.3, 0.7, 0.3, 0.8)]),
}


def stacked(ps):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *ps)


@functools.lru_cache(maxsize=None)
def jax_kernel(model, name):
    """The JAX kernel's propose and reweight over two chains, with the
    normals (and the SVJM's jump uniforms) it draws from each key."""
    jmod = MODELS[model][1]
    kern = jmod.get_kernel(name)

    def one(p, key, x_t, y):
        x_next = kern.propose(p, key, x_t, y)
        lw = kern.reweight(p, x_t, x_next, y)
        if model == "svm":
            z = jax.random.normal(key, (x_t.shape[0],), x_t.dtype)
            u = jnp.zeros_like(z)
        else:
            kj, kz = jax.random.split(key)
            z = jax.random.normal(kz, (x_t.shape[0],), x_t.dtype)
            u = jax.random.uniform(kj, (x_t.shape[0],), x_t.dtype)
        return x_next, lw, z, u
    return jit(jax.vmap(one))


@pytest.mark.parametrize("model,name", [("svm", "laplace"), ("svm", "ep"),
                                        ("svjm", "ep"), ("svjm", "ep_avg")])
def test_proposal_matches_jax(model, name):
    mod, _, jps = MODELS[model]
    rng = np.random.default_rng(3)
    # chain 1's particles spread wider and sit elsewhere than chain 0's
    x_t = (rng.standard_normal((2, N, 1))
           * np.array([0.5, 2.0])[:, None, None]
           + np.array([0.0, 1.5])[:, None, None]).astype(np.float32)
    y = np.array([[0.7], [-2.3]], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    with jax.enable_x64(False):
        x_next, lw, z, u = (np.array(a) for a in jax_kernel(model, name)(
            stacked(jps), keys, jnp.asarray(x_t), jnp.asarray(y)))
    p = mod.params_from_jax(stacked(jps))
    kern = mod.get_kernel(name)
    zs = [torch.from_numpy(z)]
    if model == "svjm":
        zs.append(torch.special.ndtri(torch.from_numpy(u)))
    normals = torch.stack(zs, -1)                          # [C, N, Z]
    assert kern.noise_dim == normals.shape[-1]
    got = kern.propose(p, normals, torch.from_numpy(x_t), torch.from_numpy(y))
    # the fitted mean (the proposal at z_1 = 0, the jump draw kept) and
    # sd * z: a proposal is held at rtol on the size of these two terms
    at_mean = normals.clone()
    at_mean[..., 0] = 0.0
    mean = kern.propose(p, at_mean, torch.from_numpy(x_t),
                        torch.from_numpy(y)).numpy()
    terms = np.abs(mean) + np.abs(got.numpy() - mean)
    err = np.abs(got.numpy() - x_next)
    bound = TOL["atol"] + TOL["rtol"] * terms
    assert np.all(err <= bound), (
        f"propose: worst error {err.max()!r}, "
        f"{int((err > bound).sum())} of {err.size} over "
        f"atol + rtol * (|mean| + |sd z|)")
    got_lw = kern.reweight(p, torch.from_numpy(x_t), torch.from_numpy(x_next),
                           torch.from_numpy(y))
    np.testing.assert_allclose(got_lw.numpy(), lw, **TOL)
    assert registry.get_model(model).get_fused(name) is None


def loglik_runs(mod, params, ys, kernel_name, runs, N=256, seed=0):
    """``runs`` independent particle-filter log-likelihoods (one chain a
    run) of ``ys`` with the kernel ``kernel_name`` (float32, the port's
    resampling type)."""
    gen = torch.Generator().manual_seed(seed)
    C, T, dt = runs, ys.shape[0], torch.float32
    rep = params_map(lambda x: x.expand((C,) + x.shape[1:]), params)
    kern = mod.get_kernel(kernel_name)
    out = buffered.run_buffered_pf(
        kern, mod.suff_statistic, rep, ys[None].expand(C, T, 1),
        z0=torch.randn((C, kern.noise_dim, N), generator=gen, dtype=dt),
        normals=torch.randn((C, T, kern.noise_dim, N), generator=gen,
                            dtype=dt),
        u=torch.rand((C, T, N), generator=gen, dtype=dt), statistic_dim=3,
        smoother="filter", prior_mean=torch.zeros(C, dtype=dt),
        prior_var=mod.stationary_variance(rep))
    return out.loglikelihood.numpy()


@pytest.mark.parametrize("model", ["svm", "svjm"])
def test_adaptive_proposals_estimate_the_same_loglik(model):
    """JAX's law check on the port (tests/test_svm_model.py, the SVM's
    Laplace and EP against the bootstrap kernel, there in float64), and
    the same for the SVJM's EP and EP-avg."""
    if model == "svm":
        mod, names = svm, ("laplace", "ep")
        p = svm.from_scalars(0.9, 0.5, 1.0)
    else:
        mod, names = svjm, ("ep", "ep_avg")
        p = svjm.from_scalars(0.9, 0.5, 1.0, 0.1, 2.0)
    ys, _ = mod.generate_data(torch.Generator().manual_seed(0), p, 50)
    res = {k: loglik_runs(mod, p, ys, k, 12, seed=i)
           for i, k in enumerate(("prior",) + names)}
    for name in names:
        np.testing.assert_allclose(res[name].mean(), res["prior"].mean(),
                                   rtol=0.03, err_msg=name)
        assert res[name].std() < res["prior"].std() * 1.5, name


def test_proposals_run_through_the_samplers():
    """fit_scan and the predict surface with each proposal; systematic
    resampling stays on the unfused route (no fused bundle), as in the
    JAX package."""
    p = svjm.from_scalars(0.9, 0.5, 1.0, 0.1, 2.0)
    ys, _ = svjm.generate_data(torch.Generator().manual_seed(1), p, 30)
    for cls, names in ((SVMSampler, ("laplace", "ep")),
                       (SVJMSampler, ("ep", "ep_avg"))):
        smp = cls(ys, device="cpu", seed=2)
        for name in names:
            kw = dict(kernel=name, N=16, subsequence_length=8,
                      buffer_length=2, resampler="systematic")
            score = smp._make_score(smp._score_config(**kw), name)
            assert not score.uses_fused(torch.device("cuda"))
            trace, aux = smp.fit_scan("SGLD", num_iters=2, num_chains=3,
                                      record="all", return_aux=True, **kw)
            assert bool(torch.isfinite(aux).all())
            assert bool(torch.isfinite(trace.A).all())
            smp.select_chain(0)
            mean, cov = smp.predict(N=16, kernel=name)
            assert np.isfinite(mean).all() and mean.shape == (30, 1)
            assert np.isfinite(smp.predictive_loglikelihood(
                2, N=16, kernel=name)).all()
