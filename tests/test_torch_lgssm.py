"""The port's scalar LGSSM and its Kalman oracle against the JAX package:
the model functions, the fused-window bodies and K1's plain version on
the LGSSM bodies (JAX kernel in interpret mode), the Kalman messages and
gradient, the fused score against the exact gradient, and the public
``LGSSMSampler.fit_scan`` on the CPU.

JAX runs in float64 here (tests/conftest.py enables x64).  The port's
model functions and Kalman code are compared in float64; the fused bodies
and K1, which compute in float32, in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgmcmc_tpu_torch
from sgmcmc_tpu.models import lgssm as jl
from sgmcmc_tpu.ops import kalman as jk
from sgmcmc_tpu.ops.pallas.fused_pf import fused_window_batched
from sgmcmc_tpu_torch.inference.samplers import LGSSMSampler
from sgmcmc_tpu_torch.models import lgssm, registry
from sgmcmc_tpu_torch.ops import kalman
from sgmcmc_tpu_torch.ops.cuda import fused_pf

torch.set_num_threads(1)

# (A, C, Q, R) of two chains
CHAINS = [(0.8, 1.2, 0.5, 1.3), (-0.4, 0.7, 1.5, 0.6)]
FIELDS = ("A", "C", "LQinv_vec", "LRinv_vec")
F64 = dict(rtol=1e-12, atol=1e-12)


def jax_chains():
    return [jl.from_matrices(A=[[a]], C=[[c]], Q=[[q]], R=[[r]])
            for a, c, q, r in CHAINS]


def port_chains(dtype=torch.float64):
    ps = [lgssm.params_from_jax(p, dtype) for p in jax_chains()]
    return lgssm.LGSSMParams(*[torch.cat([getattr(p, f) for p in ps])
                               for f in FIELDS])


def jax_stacked():
    """The JAX chains stacked on a leading axis, for jax.vmap."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jax_chains())


@pytest.mark.parametrize("name", ["prior", "optimal"])
def test_kernel_propose_and_reweight_match_jax(name):
    """Shared normals: the JAX kernel's draw from its key, fed to the
    port.  float64, tolerance 1e-12."""
    N = 16
    rng = np.random.default_rng(0)
    x_t = rng.standard_normal((2, N, 1))
    ys = rng.standard_normal((2, 1))
    jkern, kern = jl.get_kernel(name), lgssm.get_kernel(name)

    def one(jp, key, x, y):
        prop = jkern.propose(jp, key, x, y)
        return (jax.random.normal(key, x.shape, x.dtype), prop,
                jkern.reweight(jp, x, prop, y),
                jkern.prior_log_density(jp, x, prop))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    z, *want = [np.array(a) for a in jax.jit(jax.vmap(one))(
        jax_stacked(), keys, jnp.asarray(x_t), jnp.asarray(ys))]
    params = port_chains()
    t = torch.from_numpy
    prop = kern.propose(params, t(z), t(x_t), t(ys))
    got = (prop, kern.reweight(params, t(x_t), prop, t(ys)),
           kern.prior_log_density(params, t(x_t), prop))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **F64)


def test_statistic_prior_and_projection_match_jax():
    """grad_statistic, unpack_grad, logprior, grad_logprior and
    project_parameters in float64, tolerance 1e-12."""
    rng = np.random.default_rng(1)
    x_t, x_n = rng.standard_normal((2, 2, 8, 1))
    ys = rng.standard_normal((2, 1))
    raw = lgssm.LGSSMParams(
        A=torch.tensor([[[1.5]], [[-0.3]]], dtype=torch.float64),
        C=torch.tensor([[[0.7]], [[2.0]]], dtype=torch.float64),
        LQinv_vec=torch.tensor([[-0.8], [1.1]], dtype=torch.float64),
        LRinv_vec=torch.tensor([[0.6], [-2.0]], dtype=torch.float64))
    jraw = jl.LGSSMParams(*[jnp.asarray(getattr(raw, f).numpy().reshape(s))
                            for f, s in zip(FIELDS, [(2, 1, 1), (2, 1, 1),
                                                     (2, 1), (2, 1)])])
    jprior = jl.default_prior(1, 1)

    def one(jp, x, xn, y, jr):
        stat = jl.grad_statistic(jp, x, xn, y, 0)
        return (stat, jl.unpack_grad(stat.mean(0), 1, 1),
                jl.logprior(jprior, jp), jl.grad_logprior(jprior, jp),
                jl.project_parameters(jr))
    stat, unpacked, lp, glp, proj = jax.jit(jax.vmap(one))(
        jax_stacked(), jnp.asarray(x_t), jnp.asarray(x_n), jnp.asarray(ys),
        jraw)
    params = port_chains()
    t = torch.from_numpy
    got = lgssm.grad_statistic(params, t(x_t), t(x_n), t(ys), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(stat), **F64)
    prior = lgssm.default_prior(dtype=torch.float64)
    np.testing.assert_allclose(lgssm.logprior(prior, params).numpy(),
                               np.asarray(lp), **F64)
    for port_p, jax_p in ((lgssm.unpack_grad(got.mean(1)), unpacked),
                          (lgssm.grad_logprior(prior, params), glp),
                          (lgssm.project_parameters(raw), proj)):
        for f in FIELDS:
            np.testing.assert_allclose(
                getattr(port_p, f).numpy().reshape(2, -1),
                np.asarray(getattr(jax_p, f)).reshape(2, -1), **F64)


@pytest.mark.parametrize("name", ["optimal", "prior"])
def test_fused_bodies_match_jax(name):
    """The plain fused bodies against lgssm._fused_* on the same float32
    inputs; tolerance 1e-6 relative (two libraries' float32 log)."""
    rng = np.random.default_rng(2)
    f32 = np.float32
    pv = [rng.uniform(0.3, 0.9, (3, 1)).astype(f32),
          rng.uniform(0.5, 1.5, (3, 1)).astype(f32),
          rng.uniform(0.5, 2.0, (3, 1)).astype(f32),
          rng.uniform(0.5, 2.0, (3, 1)).astype(f32)]
    z, x, xn = rng.standard_normal((3, 3, 32)).astype(f32)
    y = rng.standard_normal((3, 1)).astype(f32)
    jf, pf = jl.get_fused(name), lgssm.get_fused(name)
    jpv = [jnp.asarray(v) for v in pv]
    tpv = [torch.from_numpy(v) for v in pv]
    t = torch.from_numpy
    pairs = [
        (jf.propose(jpv, [jnp.asarray(z)], [jnp.asarray(x)], jnp.asarray(y)),
         pf.propose(tpv, [t(z)], [t(x)], t(y))),
        ([jf.reweight(jpv, [jnp.asarray(x)], [jnp.asarray(xn)],
                      jnp.asarray(y))],
         [pf.reweight(tpv, [t(x)], [t(xn)], t(y))]),
        (jf.stat(jpv, [jnp.asarray(x)], [jnp.asarray(xn)], jnp.asarray(y)),
         pf.stat(tpv, [t(x)], [t(xn)], t(y))),
    ]
    for want, got in pairs:
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
    params = lgssm.LGSSMParams(A=t(pv[0])[:, :, None], C=t(pv[1])[:, :, None],
                               LQinv_vec=t(pv[2]), LRinv_vec=t(pv[3]))
    np.testing.assert_allclose(pf.pack_params(params).numpy(),
                               np.concatenate(pv, 1))


def kalman_case(n):
    """(observations [T, 1], A, C, LQinv, LRinv) in float64: the scalar
    model, or a 2-state model with one observation."""
    rng = np.random.default_rng(3 + n)
    T = 12
    ys = rng.standard_normal((T, 1))
    if n == 1:
        return ys, np.array([[0.8]]), np.array([[1.2]]), \
            np.array([[1.4]]), np.array([[0.9]])
    A = np.array([[0.7, 0.2], [-0.1, 0.5]])
    C = np.array([[1.0, 0.4]])
    LQinv = np.array([[1.3, 0.0], [0.3, 0.8]])
    return ys, A, C, LQinv, np.array([[1.1]])


def kalman_outputs(k, ys, A, C, LQinv, LRinv, w, valid):
    """Messages, marginal log-likelihood and gradients (with and without
    the initial transition) of one kalman module, JAX's or the port's."""
    n = A.shape[-1]
    f, b = k.init_forward_message(n), k.init_backward_message(n)
    args = (ys, A, C, LQinv, LRinv)
    return (*k.forward_messages(*args, f, w, valid),
            *k.backward_messages(*args, b, w, valid),
            k.marginal_loglikelihood(*args, f, b, w),
            *k.gradient_marginal_loglikelihood(*args, f, b, w, True,
                                               valid).values(),
            *k.gradient_marginal_loglikelihood(*args, f, b, w, False,
                                               valid).values())


@pytest.mark.parametrize("n", [1, 2])
def test_kalman_matches_jax(n):
    """Messages, marginal log-likelihood and its gradient, rtol 1e-10, with
    step weights and a masked step; then two chains as one batch."""
    ys, A, C, LQinv, LRinv = kalman_case(n)
    T = ys.shape[0]
    w = np.linspace(0.5, 1.5, T)
    valid = np.ones(T)
    valid[4] = 0.0
    arrays = (ys, A, C, LQinv, LRinv, w, valid)
    # one jitted call: eager JAX compiles every scan and einsum anew
    want = jax.jit(lambda *a: kalman_outputs(jk, *a))(
        *[jnp.asarray(a) for a in arrays])
    got = kalman_outputs(kalman, *[torch.from_numpy(a) for a in arrays])
    assert len(got) == len(want) == 15
    tol = dict(rtol=1e-10, atol=1e-10)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **tol)
    # a batch of the chain and a perturbed copy equals each chain alone
    t = [torch.from_numpy(a) for a in arrays]
    A2 = torch.stack([t[1], 0.5 * t[1]])
    batched = kalman_outputs(kalman, t[0], A2, *t[2:])
    for c in range(2):
        single = kalman_outputs(kalman, t[0], A2[c], *t[2:])
        for g, s in zip(batched, single):
            np.testing.assert_allclose(g[c].numpy(), s.numpy(), **tol)


@pytest.mark.parametrize("name", ["optimal", "prior"])
def test_fused_window_reference_matches_jax_fused_kernel(name):
    """K1's plain version on the LGSSM bodies against the JAX kernel in
    interpret mode on shared draws; tolerances of the JAX kernel's bf16
    hi/lo gather: statistic rtol=atol=2e-3, loglik rtol 1e-4."""
    C, N, W = 2, 64, 8
    rng = np.random.default_rng(4)
    f32 = np.float32
    pvec = np.stack([rng.uniform(0.5, 0.95, C), np.ones(C),
                     rng.uniform(0.5, 2.0, C) ** -0.5,
                     rng.uniform(0.5, 2.0, C) ** -0.5], -1).astype(f32)
    x0 = (rng.standard_normal((C, 1, N)) * 2.0).astype(f32)
    normals = rng.standard_normal((C, W, 1, N)).astype(f32)
    ys = (2.0 * rng.standard_normal((C, W))).astype(f32)
    weights = rng.uniform(1.0, 3.0, (C, W)).astype(f32)
    weights[:, :2] = 0.0
    xi = rng.uniform(0.0, 1.0, (C, W)).astype(f32)
    out = fused_pf.fused_window(
        lgssm.get_fused(name),
        *[torch.from_numpy(a) for a in (pvec, x0, normals, ys, weights,
                                        xi)]).numpy()

    def fold(a):
        B = a.shape[-1] // 8
        f = np.swapaxes(a.reshape(a.shape[:-1] + (B, 8)), -1, -2)
        return f.reshape(a.shape[:-2] + (-1, B))
    ms, ll = fused_window_batched(
        jl.get_fused(name), jnp.asarray(pvec), jnp.asarray(fold(x0)),
        jnp.asarray(fold(normals)), jnp.asarray(ys), jnp.asarray(weights),
        jnp.asarray(xi), interpret=True)
    np.testing.assert_allclose(out[:, :4], np.asarray(ms), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(out[:, 4], np.asarray(ll), rtol=1e-4)


@pytest.mark.parametrize("name,rng_mode,ess", [
    ("optimal", "host", None), ("prior", "host", None),
    ("optimal", "kernel", None), ("optimal", "host", 0.5)])
def test_fused_score_matches_exact_kalman_gradient(name, rng_mode, ess):
    """The full-window fused score (T=16, N=256) over 80 chains in one call
    against the exact Kalman gradient, |z| < 5 in all four components (as
    tests/test_fused_pf.py and tests/test_ess_adaptive.py hold the JAX
    kernel)."""
    T, N, R = 16, 256, 80
    jp = jl.from_matrices(A=[[0.8]], C=[[1.0]], Q=[[0.5]], R=[[1.0]])
    ys, _ = jl.generate_data(jax.random.PRNGKey(0), jp, T)
    ys = torch.from_numpy(np.array(ys, np.float64))
    exact = lgssm.gradient_marginal_loglikelihood(
        lgssm.params_from_jax(jp, torch.float64), ys)
    exact_vec = np.array([float(getattr(exact, f).reshape(())) for f in
                          ("LRinv_vec", "LQinv_vec", "C", "A")])
    p32 = lgssm.params_from_jax(jp)
    params = lgssm.LGSSMParams(*[getattr(p32, f).expand(
        (R,) + getattr(p32, f).shape[1:]) for f in FIELDS])
    gen = torch.Generator().manual_seed(5)
    z0 = torch.randn((R, 1, N), generator=gen)
    xi = torch.rand((R, T), generator=gen)
    if rng_mode == "kernel":
        normals = None
        seeds = torch.randint(-2 ** 63, 2 ** 63 - 1, (R,), generator=gen)
    else:
        normals, seeds = torch.randn((R, T, 1, N), generator=gen), None
    stat, ll = fused_pf.fused_pf_score(
        lgssm.get_fused(name), params,
        ys[None, :, 0].float().expand(R, T), torch.ones((R, T)), z0,
        normals, xi, torch.zeros(R), torch.full((R,), 10.0),
        ess_threshold=ess, seeds=seeds)
    f = stat.double().numpy()
    assert bool(torch.isfinite(ll).all())
    z = (f.mean(0) - exact_vec) / (f.std(0) / np.sqrt(R) + 1e-9)
    assert np.all(np.abs(z) < 5), (f.mean(0), exact_vec, z)


@pytest.mark.parametrize("resampler", ["multinomial", "systematic"])
def test_lgssm_fit_scan_on_cpu(resampler):
    rng = np.random.default_rng(6)
    ys = rng.standard_normal(60).astype(np.float32)
    s = LGSSMSampler(observations=ys, device="cpu", seed=1)
    s.parameters = lgssm.from_scalars(0.5, 1.0, 2.0)
    trace, aux = s.fit_scan("SGLD", num_iters=3, num_chains=4, N=64,
                            subsequence_length=8, buffer_length=2,
                            resampler=resampler, return_aux=True)
    assert trace.A.shape == (4, 3, 1, 1) and aux.shape == (4, 3)
    for leaf in (trace.A, trace.C, trace.LQinv_vec, trace.LRinv_vec, aux):
        assert bool(torch.isfinite(leaf).all())
    assert bool((trace.C == 1.0).all())


def test_registry_has_the_scalar_lgssm_only():
    """The scalar entry is the one object with K1's bodies; the vector
    model (n = 2, m = 1) is its own entry, without them."""
    assert registry.get_model("lgssm") is registry.LGSSM
    assert registry.get_model("lgssm", n=1, m=1) is registry.LGSSM
    assert registry.LGSSM.get_fused is lgssm.get_fused
    vec = registry.get_model("lgssm", n=2, m=1)
    assert vec is not registry.LGSSM and vec.get_fused is None
    assert vec.name == "lgssm_2_1" and vec.get_kernel().state_dim == 2
    assert sgmcmc_tpu_torch.LGSSMSampler is LGSSMSampler
