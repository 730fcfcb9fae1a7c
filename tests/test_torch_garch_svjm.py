"""The port's GARCH and SVJM against the JAX package: the initial state of
the fused window (the ``init`` hook), the particle kernels, statistics,
priors and projections, the fused bodies, K1's plain version through
``fused_pf_score`` (JAX kernel in interpret mode), the unfused smoother,
``fit_scan`` on the CPU and the registry.

JAX runs in float64 where its functions allow (tests/conftest.py enables
x64) and jitted; the fused bodies and the smoothers compute in float32.
The draws JAX takes from its keys are rebuilt and fed to the port.  The
SVJM jump: the JAX package's unfused kernel draws ``uniform(kj) < pJ``,
the port's ``z_2 < ndtri(pJ)``; the port is fed ``z_2 = ndtri(u)`` of
JAX's uniform, so the two agree draw for draw (but on an exact tie).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgmcmc_tpu_torch
from sgmcmc_tpu.models import garch as jgarch
from sgmcmc_tpu.models import svjm as jsvjm
from sgmcmc_tpu.ops import buffered as jbuffered
from sgmcmc_tpu.ops.pallas.fused_pf import fused_window_batched
from sgmcmc_tpu_torch.inference.samplers import GARCHSampler, SVJMSampler
from sgmcmc_tpu_torch.models import garch, registry, svjm, svm
from sgmcmc_tpu_torch.ops import buffered
from sgmcmc_tpu_torch.ops.cuda import fused_pf

torch.set_num_threads(1)

S_FOLD = 8
F64 = dict(rtol=1e-12, atol=1e-12)
# (port module, JAX module, JAX constructor args of two chains)
MODELS = {
    "garch": (garch, jgarch, lambda dt: [
        jgarch.from_alpha_beta_gamma(0.1, 0.6, 0.2, 0.5, dtype=dt),
        jgarch.from_alpha_beta_gamma(0.3, 0.25, 0.5, 1.5, dtype=dt)]),
    "svjm": (svjm, jsvjm, lambda dt: [
        jsvjm.from_scalars(0.9, 0.5, 1.0, 0.1, 2.0, dtype=dt),
        jsvjm.from_scalars(-0.6, 1.3, 0.7, 0.3, 0.8, dtype=dt)]),
}


def stacked(ps):
    """Stack per-chain parameters (host leaves) along a chain axis."""
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *ps)


def port_params(mod, jps, dtype=torch.float32):
    return mod.params_from_jax(stacked(jps), dtype)


def observations(seed, C, W):
    """Observations and step weights [C, W] (two buffer steps)."""
    rng = np.random.default_rng(seed)
    ys = (np.exp(0.5 * rng.standard_normal((C, W)))
          * rng.standard_normal((C, W))).astype(np.float32)
    w = rng.uniform(1.0, 3.0, (C, W)).astype(np.float32)
    w[:, :2] = 0.0
    return ys, w


def fold(a):
    """[..., Z, N] natural particle order -> [..., Z*s, B] folded, particle
    j = s*p + q at (row q, lane p), the JAX kernel's layout."""
    B = a.shape[-1] // S_FOLD
    f = jnp.swapaxes(a.reshape(a.shape[:-1] + (B, S_FOLD)), -1, -2)
    return f.reshape(a.shape[:-2] + (-1, B))


@pytest.mark.parametrize("name", ["garch", "svjm", "svm"])
def test_initial_state_matches_jax_init(name):
    """The init repair: the fused window's x0 from shared normals equals
    the JAX bundle's (GARCH: D=2 from Z=1 normal, sigma2_0 = 0; SVJM: D=1
    from the first of Z=2); a model without init keeps the Gaussian
    default."""
    mod = {"garch": garch, "svjm": svjm, "svm": svm}[name]
    jmod = {"garch": jgarch, "svjm": jsvjm}.get(name)
    model = mod.FUSED
    rng = np.random.default_rng(0)
    z0 = rng.standard_normal((2, model.noise_dims, 16)).astype(np.float32)
    pm = np.array([0.0, 0.5], np.float32)
    pv = np.array([0.7, 2.0], np.float32)
    x0 = fused_pf.initial_state(model, torch.from_numpy(z0),
                                torch.from_numpy(pm), torch.from_numpy(pv))
    assert x0.shape == (2, model.n_state, 16) and x0.dtype == torch.float32
    if jmod is None:
        want = pm[:, None, None] + np.sqrt(pv)[:, None, None] * z0
    else:
        want = np.asarray(jax.jit(jax.vmap(
            lambda z, m, v: jnp.stack(jmod.FUSED.init(list(z), m, v))))(
                z0, pm, pv))
    np.testing.assert_allclose(x0.numpy(), want, rtol=1e-6, atol=1e-7)
    if name == "garch":
        assert bool((x0[:, 1] == 0).all())


# jitted JAX references compile faster without the backend's optimisation
FAST = dict(compiler_options={"xla_backend_optimization_level": 0})


@functools.lru_cache(maxsize=None)
def model_case(name):
    """Float64 inputs on two chains and, in one jitted JAX call, the
    kernels' outputs (with the normals and SVJM's jump uniforms drawn from
    their keys) and the statistic, prior and projection outputs."""
    N = 12
    jmod, make = MODELS[name][1:]
    jps = make(jnp.float64)
    rng = np.random.default_rng(1)
    D = 2 if name == "garch" else 1
    x_t, x_n = rng.standard_normal((2, 2, N, D))
    if name == "garch":
        x_t[..., 1], x_n[..., 1] = rng.uniform(0.2, 2.0, (2, 2, N))
    ys = rng.standard_normal((2, 1))
    # negative Cholesky factors and |A| > 1 for the projection
    raw = jax.tree_util.tree_map(lambda x: np.asarray(x) * -1.3,
                                 stacked(jps))
    kinds = ["prior", "optimal"] if name == "garch" else ["prior"]
    jprior = jmod.default_prior(dtype=jnp.float64)

    def kernels(jp, key, x, y):
        k0, kp = jax.random.split(key)
        out = [jmod.get_kernel(None).sample_x0(jp, k0, N, 0.3, 1.7)]
        if name == "garch":
            draws = [jax.random.normal(k0, (N,), x.dtype)[:, None],
                     jax.random.normal(kp, (N,), x.dtype)[:, None]]
        else:
            kj, kz = jax.random.split(kp)
            draws = [jax.random.normal(k0, (N, 1), x.dtype),
                     jnp.concatenate([
                         jax.random.normal(kz, (N, 1), x.dtype),
                         jax.random.uniform(kj, (N, 1), x.dtype)], -1)]
        for kind in kinds:
            kern = jmod.get_kernel(kind)
            prop = kern.propose(jp, kp, x, y)
            out += [prop, kern.reweight(jp, x, prop, y),
                    kern.prior_log_density(jp, x, prop)]
        out.append(jmod.get_kernel(None).prior_log_density_max(jp))
        return draws, out

    def statistics(jp, x, xn, y, jr):
        stat = jmod.grad_statistic(jp, x, xn, y, 0)
        out = [stat, jmod.unpack_grad(stat.mean(0)),
               jmod.stationary_variance(jp), jmod.logprior(jprior, jp),
               jmod.grad_logprior(jprior, jp), jmod.project_parameters(jr)]
        if name == "svjm":
            d = xn[:, 0] - jp.a * x[:, 0]
            out += [jmod._mixture_logpdf(jp, d),
                    jmod._jump_responsibility(jp, d)]
        return out

    def both(p, x, xn, y, r):
        keys = jax.random.split(jax.random.PRNGKey(0), 2)
        return (jax.vmap(kernels)(p, keys, x, y),
                jax.vmap(statistics)(p, x, xn, y, r))
    (draws, kern_out), stat_out = jax.jit(both, **FAST)(
        stacked(jps), x_t, x_n, ys, raw)
    return (jps, x_t, x_n, ys, raw, kinds, [np.asarray(d) for d in draws],
            [np.asarray(w) for w in kern_out], stat_out)


@pytest.mark.parametrize("name", ["garch", "svjm"])
def test_kernels_match_jax(name):
    """sample_x0, propose, reweight, the transition density and its
    maximum, on the draws of the JAX kernels' keys; float64, 1e-12."""
    mod = MODELS[name][0]
    jps, x_t, _, ys, _, kinds, (z0, z), want, _ = model_case(name)
    if name == "svjm":
        z = z.copy()
        z[..., 1] = torch.special.ndtri(torch.from_numpy(z[..., 1])).numpy()
    params = port_params(mod, jps, torch.float64)
    t = torch.from_numpy
    pm = torch.full((2,), 0.3, dtype=torch.float64)
    pv = torch.full((2,), 1.7, dtype=torch.float64)
    got = [mod.get_kernel(None).sample_x0(params, t(z0), pm, pv)]
    for kind in kinds:
        kern = mod.get_kernel(kind)
        prop = kern.propose(params, t(z), t(x_t), t(ys))
        got += [prop, kern.reweight(params, t(x_t), prop, t(ys)),
                kern.prior_log_density(params, t(x_t), prop)]
    got.append(mod.get_kernel(None).prior_log_density_max(params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.reshape(g.shape), **F64)


@pytest.mark.parametrize("name", ["garch", "svjm"])
def test_statistic_prior_and_projection_match_jax(name):
    """grad_statistic, unpack_grad, stationary_variance, logprior,
    grad_logprior and project_parameters (and SVJM's mixture density and
    jump responsibility) in float64; 1e-12, but the log prior to 1e-6
    relative: jax.scipy.special.betaln approximates log B(a, b) (5.5e-8
    off lgamma(a) + lgamma(b) - lgamma(a + b) at the default prior's
    a = 20, b = 20/9), which the port computes."""
    mod = MODELS[name][0]
    jps, x_t, x_n, ys, raw, _, _, _, want = model_case(name)
    params = port_params(mod, jps, torch.float64)
    t = torch.from_numpy
    prior = mod.default_prior(dtype=torch.float64)
    stat = mod.grad_statistic(params, t(x_t), t(x_n), t(ys), 0)
    got = [stat, mod.unpack_grad(stat.mean(1)),
           mod.stationary_variance(params), mod.logprior(prior, params),
           mod.grad_logprior(prior, params),
           mod.project_parameters(mod.params_from_jax(raw, torch.float64))]
    if name == "svjm":
        d = t(x_n[..., 0]) - params.a[:, None] * t(x_t[..., 0])
        got += [mod._mixture_logpdf(params, d),
                mod._jump_responsibility(params, d)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        tol = dict(rtol=1e-6, atol=0.0) if i == 3 else F64
        if isinstance(g, torch.Tensor):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
            continue
        for f in g.__dataclass_fields__:
            np.testing.assert_allclose(
                getattr(g, f).numpy().reshape(2, -1),
                np.asarray(getattr(w, f)).reshape(2, -1), **tol)


@pytest.mark.parametrize("name,kind", [("garch", "optimal"),
                                       ("garch", "prior"), ("svjm", None)])
def test_fused_bodies_match_jax(name, kind):
    """The plain fused bodies and pack_params against the JAX bundle on the
    same float32 inputs; rtol 1e-6 (two libraries' float32 exp, log and
    ndtri)."""
    mod, jmod, make = MODELS[name]
    jps = make(jnp.float32)
    jf, pf = jmod.get_fused(kind), mod.get_fused(kind)
    rng = np.random.default_rng(3)
    f32 = np.float32
    Z, D = pf.noise_dims, pf.n_state
    z = rng.standard_normal((Z, 2, 32)).astype(f32)
    x, xn = rng.standard_normal((2, D, 2, 32)).astype(f32)
    if name == "garch":
        x[1], xn[1] = rng.uniform(0.2, 2.0, (2, 2, 32)).astype(f32)
    y = rng.standard_normal((2, 1)).astype(f32)

    def bodies(f, pvec, z, x, xn, y):
        cols = [pvec[:, i:i + 1] for i in range(pvec.shape[1])]
        return (f.propose(cols, list(z), list(x), y),
                [f.reweight(cols, list(x), list(xn), y)],
                f.stat(cols, list(x), list(xn), y))

    def jax_side(p, *arrays):
        pvec = jax.vmap(jf.pack_params)(p)
        return pvec, bodies(jf, pvec, *arrays)
    pv, want = jax.jit(jax_side, **FAST)(stacked(jps), z, x, xn, y)
    pv = np.asarray(pv)
    got_pv = pf.pack_params(port_params(mod, jps))
    np.testing.assert_allclose(got_pv.numpy(), pv, rtol=1e-6)
    got = bodies(pf, *[torch.from_numpy(a) for a in (pv, z, x, xn, y)])
    for w_list, g_list in zip(want, got):
        assert len(w_list) == len(g_list)
        for w, g in zip(w_list, g_list):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("name,kind", [("garch", "optimal"),
                                       ("garch", "prior"), ("svjm", None)])
def test_fused_score_matches_jax_fused_kernel(name, kind):
    """fused_pf_score (x0 from the init hook, pack_params, K1's plain
    version) against the JAX bundle's init and pack_params and
    fused_window_batched in interpret mode, on shared numpy draws.
    Statistic rtol=atol=1e-4, loglik rtol 1e-5."""
    mod, jmod, make = MODELS[name]
    C, N, W = 2, 64, 12
    jps = make(jnp.float32)
    jf, model = jmod.get_fused(kind), mod.get_fused(kind)
    Z = model.noise_dims
    ys, w = observations(4, C, W)
    rng = np.random.default_rng(4)
    z0 = rng.standard_normal((C, Z, N)).astype(np.float32)
    normals = rng.standard_normal((C, W, Z, N)).astype(np.float32)
    xi = rng.uniform(0.0, 1.0, (C, W)).astype(np.float32)

    def jax_side(p, z0, normals, ys, w, xi):
        pv = jax.vmap(jmod.stationary_variance)(p).reshape(C)
        x0 = jax.vmap(lambda z, v: jnp.stack(jf.init(
            list(z), jnp.float32(0.0), v)))(z0, pv)
        ms, ll = fused_window_batched(jf, jax.vmap(jf.pack_params)(p),
                                      fold(x0), fold(normals), ys, w, xi,
                                      interpret=True)
        return pv, ms, ll
    pv, ms, ll = jax.jit(jax_side, **FAST)(stacked(jps), z0, normals, ys, w,
                                           xi)
    pv = np.asarray(pv)
    t = torch.from_numpy
    stat, got_ll = fused_pf.fused_pf_score(
        model, port_params(mod, jps), t(ys), t(w), t(z0), t(normals),
        t(xi), torch.zeros(C), t(pv))
    assert bool(torch.isfinite(stat).all() and torch.isfinite(got_ll).all())
    np.testing.assert_allclose(stat.numpy(), np.asarray(ms), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_ll.numpy(), np.asarray(ll), rtol=1e-5)


def unfused_draws(name, resampler, N, W, key):
    """The draws JAX's run_buffered_pf takes from ``key``: z0 [N], the
    resampling uniforms [W] or [W, N], the proposal normals [W, N] and
    (SVJM) the jump uniforms [W, N]."""
    key_init, key_steps = jax.random.split(key)
    z0 = jax.random.normal(key_init, (N,), jnp.float32)

    def step(k):
        kr, kp = jax.random.split(k)
        u = jax.random.uniform(
            kr, () if resampler == "systematic" else (N,), jnp.float32)
        if name == "garch":
            return u, jax.random.normal(kp, (N,), jnp.float32), u
        kj, kz = jax.random.split(kp)
        return (u, jax.random.normal(kz, (N,), jnp.float32),
                jax.random.uniform(kj, (N,), jnp.float32))
    return (z0, *jax.vmap(step)(jax.random.split(key_steps, W)))


@functools.lru_cache(maxsize=None)
def unfused_case(name, N=64, W=12):
    """JAX run_buffered_pf (Poyiadjis O(N), gather resampling) over two
    chains for both resamplers, and its draws, in one jitted call."""
    jmod, make = MODELS[name][1:]
    jps = make(jnp.float32)
    ys, w = observations(5, 2, W)

    def run(p, y, sw):
        keys = jax.random.split(jax.random.PRNGKey(5), 2)
        v = jax.vmap(jmod.stationary_variance)(p).reshape(2)
        out = {"pv": v}
        for res in ("multinomial", "systematic"):
            pf = jax.vmap(lambda k, p1, y1, sw1, v1: jbuffered.run_buffered_pf(
                jmod.get_kernel(None), jmod.grad_statistic, p1, y1[:, None],
                key=k, n_particles=N, statistic_dim=jmod.STATISTIC_DIM,
                step_weights=sw1, in_window=(sw1 > 0).astype(sw1.dtype),
                prior_mean=0.0, prior_var=v1, resampler=res,
                resample_mode="auto"))(keys, p, y, sw, v)
            out[res] = (pf.mean_statistic, pf.loglikelihood, jax.vmap(
                lambda k: unfused_draws(name, res, N, W, k))(keys))
        return out
    out = jax.jit(run, **FAST)(stacked(jps), ys, w)
    return jps, ys, w, np.asarray(out["pv"]), out


@pytest.mark.parametrize("resampler", ["multinomial", "systematic"])
@pytest.mark.parametrize("name", ["garch", "svjm"])
def test_unfused_smoother_matches_jax(name, resampler):
    """run_buffered_pf (Poyiadjis O(N), the default kernel) against the
    JAX package's on the draws rebuilt from its keys.  Statistic
    rtol=atol=1e-4, loglik rtol 1e-5 (float32 rounding; the two CDFs are
    accumulated in different orders)."""
    mod = MODELS[name][0]
    jps, ys, w, pv, out = unfused_case(name)
    want_stat, want_ll, draws = out[resampler]
    z0, u, z, u_jump = (torch.from_numpy(np.array(a)) for a in draws)
    z0, z = z0[:, None], z[:, :, None]
    if name == "svjm":    # the jump normal ndtri(u) of the jump uniform u
        z0 = torch.cat([z0, torch.zeros_like(z0)], 1)
        z = torch.cat([z, torch.special.ndtri(u_jump)[:, :, None]], 2)
    t = torch.from_numpy
    got = buffered.run_buffered_pf(
        mod.get_kernel(None), mod.grad_statistic, port_params(mod, jps),
        t(ys)[..., None], z0=z0, normals=z, u=u,
        statistic_dim=mod.STATISTIC_DIM, step_weights=t(w),
        in_window=(t(w) > 0).float(), prior_mean=torch.zeros(2),
        prior_var=t(pv), resampler=resampler)
    assert bool(torch.isfinite(got.mean_statistic).all())
    np.testing.assert_allclose(got.mean_statistic.numpy(),
                               np.asarray(want_stat), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.loglikelihood.numpy(),
                               np.asarray(want_ll), rtol=1e-5)


@pytest.mark.parametrize("name,kw", [
    ("garch", dict(resampler="multinomial")),
    ("garch", dict(resampler="systematic", kernel="prior")),
    ("svjm", dict(resampler="multinomial")),
    ("svjm", dict(resampler="systematic", rng="kernel"))])
def test_fit_scan_on_cpu(name, kw):
    """The public samplers on the CPU (the unfused route), from synthetic
    data of the JAX package's test truths."""
    gen = torch.Generator().manual_seed(6)
    if name == "garch":
        cls, truth = GARCHSampler, garch.from_alpha_beta_gamma(
            0.1, 0.6, 0.2, 0.5)
    else:
        cls, truth = SVJMSampler, svjm.from_scalars(0.9, 0.5, 1.0, 0.1, 2.0)
    ys, xs = registry.get_model(name).generate_data(gen, truth, 60)
    assert ys.shape == xs.shape == (60, 1)
    s = cls(observations=ys, device="cpu", seed=1)
    trace, aux = s.fit_scan("SGLD", num_iters=3, num_chains=4,
                            chain_init="prior", N=64, subsequence_length=8,
                            buffer_length=2, return_aux=True, **kw)
    assert aux.shape == (4, 3)
    for f in trace.__dataclass_fields__:
        leaf = getattr(trace, f)
        assert leaf.shape[:2] == (4, 3)
        assert bool(torch.isfinite(leaf).all())
    assert bool(torch.isfinite(aux).all())


def test_registry_entries_and_unported_kernels():
    """garch and svjm in the registry with the JAX package's (0,
    stationary variance) initial-state prior; the SVJM EP proposals have
    no fused bundle."""
    for name, mod, p in (
            ("garch", garch, garch.from_alpha_beta_gamma(0.1, 0.6, 0.2, 0.5)),
            ("svjm", svjm, svjm.from_scalars(0.9, 0.5, 1.0, 0.1, 2.0))):
        api = registry.get_model(name)
        assert api.name == name and api.get_fused(None) is mod.FUSED
        pm, pv = api.prior_mean_var(p)
        assert float(pm) == 0.0
        assert float(pv) == float(mod.stationary_variance(p))
    assert registry.get_model("garch").get_fused("prior") is garch.FUSED_PRIOR
    assert registry.get_model("svjm").get_fused("ep") is None
    assert svjm.get_kernel("ep") is svjm.EP_KERNEL
    assert svjm.get_kernel("ep_avg") is svjm.EP_AVG_KERNEL
    with pytest.raises(ValueError, match="Unrecognized"):
        svjm.get_kernel("laplace")
    assert sgmcmc_tpu_torch.GARCHSampler is GARCHSampler
    assert sgmcmc_tpu_torch.SVJMSampler is SVJMSampler
