"""The port's buffered-PF SGLD slice against the JAX package: one step on
injected draws, the score's mean over many seeds, the public fit_scan on
the CPU, and the port's independence from JAX."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgmcmc_tpu.inference import sgmcmc as jsg
from sgmcmc_tpu.models import svm as jsvm
from sgmcmc_tpu.ops import buffered as jbuffered
from sgmcmc_tpu.ops import subsequence as jsub
from sgmcmc_tpu.ops.pallas.fused_pf import fused_window_batched
from sgmcmc_tpu_torch.inference import sgmcmc
from sgmcmc_tpu_torch.inference.samplers import Sampler, SVMSampler
from sgmcmc_tpu_torch.models import registry, svm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAINS = [(0.8, 0.6, 1.1), (0.5, 1.2, 0.8)]
FIELDS = ("A", "LQinv_vec", "LRinv_vec")


def jax_data(T, seed=0):
    ys, _ = jsvm.generate_data(jax.random.PRNGKey(seed),
                               jsvm.from_scalars(0.9, 0.5, 1.0), T)
    return np.array(ys, np.float32)


def port_params(jps):
    ps = [svm.params_from_jax(p) for p in jps]
    return svm.SVMParams(*[torch.cat([getattr(p, f) for p in ps])
                           for f in FIELDS])


def score_fn(cfg, T):
    return sgmcmc.make_pf_score_fn(
        svm.KERNEL, svm.grad_statistic, 3, svm.unpack_grad, cfg, T,
        prior_mean_var_fn=registry.SVM.prior_mean_var,
        fused_model=svm.FUSED)


def fold(a):
    """[..., D, N] -> the JAX kernel's [..., D*s, B], j = s*p + q."""
    B = a.shape[-1] // 8
    f = np.swapaxes(a.reshape(a.shape[:-1] + (B, 8)), -1, -2)
    return f.reshape(a.shape[:-2] + (-1, B))


def test_sgld_step_matches_jax_composition():
    """One SGLD step on injected draws (window start, x0 normals, proposal
    normals, offsets, Langevin noise): the port (plain path on the CPU)
    against the same step composed from JAX functions around the fused
    kernel in interpret mode.  Tolerance 1e-3 (the JAX kernel's bf16
    hi/lo gather)."""
    T, S, B, N, eps = 40, 8, 2, 64, 0.1
    W = S + 2 * B
    C = len(CHAINS)
    ys = jax_data(T)
    rng = np.random.default_rng(0)
    start = np.array([5, 30])
    z0 = rng.standard_normal((C, 1, N)).astype(np.float32)
    normals = rng.standard_normal((C, W, 1, N)).astype(np.float32)
    xi = rng.uniform(0, 1, (C, W)).astype(np.float32)
    noise = {f: rng.standard_normal(s).astype(np.float32)
             for f, s in zip(FIELDS, [(C, 1, 1), (C, 1), (C, 1)])}
    jps = [jsvm.from_scalars(*s) for s in CHAINS]
    jprior = jsvm.default_prior()

    cfg = sgmcmc.PFScoreConfig(n_particles=N, subsequence_length=S,
                               buffer_length=B, smoother="poyiadjis_N",
                               resampler="systematic")
    prior = svm.default_prior()
    grad_fn = sgmcmc.make_noisy_grad_fn(
        score_fn(cfg, T), lambda p: svm.grad_logprior(prior, p), T)
    t = torch.from_numpy
    draws = sgmcmc.WindowDraws(t(start), t(z0), t(normals), t(xi))
    obs = t(ys)
    params = port_params(jps)
    grad, _ = grad_fn(None, params, obs, draws)
    new, ll = sgmcmc.sgld_step(None, params, obs, grad_fn, eps, T,
                               draws=draws, noise=svm.SVMParams(
                                   **{f: t(v) for f, v in noise.items()}))
    new = svm.project_parameters(new)

    for c, p in enumerate(jps):
        st = int(start[c])
        ws = int(np.clip(st - B, 0, T - W))
        sw, _ = jbuffered.window_weights(
            st - ws, st - ws + S, jsub.subsequence_weights(st, S, T), W)
        pv = jsvm.stationary_variance(p)
        x0 = np.array(0.0 + jnp.sqrt(pv) * z0[c])
        ms, jll = fused_window_batched(
            jsvm.FUSED, jsvm._fused_pack(p)[None].astype(jnp.float32),
            jnp.asarray(fold(x0))[None], jnp.asarray(fold(normals[c]))[None],
            jnp.asarray(ys[ws:ws + W, 0])[None],
            jnp.asarray(sw, jnp.float32)[None], jnp.asarray(xi[c])[None],
            interpret=True)
        jg = jsvm.unpack_grad(ms[0])
        jgp = jsvm.grad_logprior(jprior, p)
        jgrad = jax.tree_util.tree_map(lambda a, b: (a + b) / T, jg, jgp)
        jnew = jsvm.project_parameters(jax.tree_util.tree_map(
            lambda q, g, n: q + eps * g + np.sqrt(2 * eps) * (
                np.sqrt(1.0 / T) * n), p, jgrad,
            jsvm.SVMParams(**{f: v[c] for f, v in noise.items()})))
        for f in FIELDS:
            np.testing.assert_allclose(getattr(grad, f)[c].numpy(),
                                       getattr(jgrad, f), rtol=1e-3,
                                       atol=1e-3)
            np.testing.assert_allclose(getattr(new, f)[c].numpy(),
                                       getattr(jnew, f), rtol=1e-3,
                                       atol=1e-5)
        np.testing.assert_allclose(float(ll[c]), float(jll[0]), rtol=1e-3)


def test_score_mean_matches_jax_gather_path():
    """The score estimator's mean over R=60 independent evaluations (the
    port's 60 chains in one call; JAX over 60 keys) agrees within
    |delta| < 4 se + 1e-3."""
    T, S, B, N, R = 30, 8, 2, 64, 60
    ys = jax_data(T, seed=1)
    jp = jsvm.from_scalars(0.9, 0.5, 1.0)
    jcfg = jsg.PFScoreConfig(n_particles=N, subsequence_length=S,
                             buffer_length=B, smoother="poyiadjis_N",
                             resampler="systematic", resample_mode="gather")
    jscore = jsg.make_pf_score_fn(
        jsvm.KERNEL, jsvm.grad_statistic, 3, jsvm.unpack_grad, jcfg, T,
        prior_mean_var_fn=lambda p: (0.0, jsvm.stationary_variance(p)))
    keys = jax.random.split(jax.random.PRNGKey(3), R)
    jgrad, _ = jax.jit(jax.vmap(lambda k: jscore(k, jp, jnp.asarray(ys))))(
        keys)
    g = np.stack([np.asarray(getattr(jgrad, f)).reshape(R) for f in FIELDS],
                 1)

    cfg = sgmcmc.PFScoreConfig(n_particles=N, subsequence_length=S,
                               buffer_length=B, smoother="poyiadjis_N",
                               resampler="systematic")
    params = port_params([jp] * R)
    grad, ll = score_fn(cfg, T)(torch.Generator().manual_seed(4), params,
                                torch.from_numpy(ys))
    f_ = torch.stack([getattr(grad, f).reshape(R) for f in FIELDS],
                     1).numpy()
    assert bool(torch.isfinite(ll).all())
    se = np.sqrt(g.std(0) ** 2 + f_.std(0) ** 2) / np.sqrt(R)
    assert np.all(np.abs(g.mean(0) - f_.mean(0)) < 4 * se + 1e-3), \
        (g.mean(0), f_.mean(0), se)


def test_fit_scan_sgld_on_cpu():
    ys = jax_data(40, seed=2)
    s = SVMSampler(observations=ys, seed=0, device="cpu")
    s.parameters = svm.from_scalars(0.5, 1.0, 2.0)
    trace, aux = s.fit_scan(
        "SGLD", num_iters=3, epsilon=0.1, num_chains=4, record="all",
        return_aux=True, N=32, subsequence_length=8, buffer_length=2,
        pf="poyiadjis_N", resampler="systematic")
    assert trace.A.shape == (4, 3, 1, 1)
    assert trace.LQinv_vec.shape == (4, 3, 1)
    assert trace.LRinv_vec.shape == (4, 3, 1)
    assert aux.shape == (4, 3)
    for leaf in (trace.A, trace.LQinv_vec, trace.LRinv_vec, aux):
        assert bool(torch.isfinite(leaf).all())
    assert s.parameters.num_chains == 4
    # continuing the same chains with a thinned record
    trace2 = s.fit_scan("SGLD", num_iters=4, epsilon=0.1, num_chains=4,
                        record=2, N=32, subsequence_length=8,
                        buffer_length=2, pf="nemeth", resampler="systematic")
    assert trace2.A.shape == (4, 2, 1, 1)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Sampler("svm", observations=np.zeros((10, 1)), device="cuda")


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sgmcmc_tpu'] = None\n"
        "import sgmcmc_tpu_torch\n"
        "import sgmcmc_tpu_torch.inference.samplers\n"
        "for m in pkgutil.walk_packages(sgmcmc_tpu_torch.__path__,\n"
        "                               'sgmcmc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert sgmcmc_tpu_torch.SVMSampler is not None\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'jaxlib'))\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
