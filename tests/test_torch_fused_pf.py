"""The port's fused window (plain PyTorch version, through the wrapper on
CPU tensors) and its plain buffered PF against the JAX package.

Draws are made once with numpy and fed to both packages.  The JAX fused
kernel stores particles folded as [s, B] with particle j = s*p + q at
(row q, lane p); the port keeps j in natural order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgmcmc_tpu.models import svm as jsvm
from sgmcmc_tpu.ops import buffered as jbuffered
from sgmcmc_tpu.ops.pallas.fused_pf import fused_window_batched
from sgmcmc_tpu_torch.models import svm
from sgmcmc_tpu_torch.ops import buffered
from sgmcmc_tpu_torch.ops.cuda import fused_pf

torch.set_num_threads(1)

S_FOLD = 8


def fold(a):
    """[..., D, N] natural particle order -> [..., D*s, B] folded, particle
    j = s*p + q at (row q, lane p)."""
    B = a.shape[-1] // S_FOLD
    f = np.swapaxes(a.reshape(a.shape[:-1] + (B, S_FOLD)), -1, -2)
    return f.reshape(a.shape[:-2] + (-1, B))


def draws(seed, C, N, W):
    rng = np.random.default_rng(seed)
    pvec = np.stack([rng.uniform(0.5, 0.95, C),
                     rng.uniform(0.3, 1.5, C) ** -0.5,
                     rng.uniform(0.5, 2.0, C) ** -0.5], -1).astype(np.float32)
    x0 = rng.standard_normal((C, 1, N)).astype(np.float32) * 2.0
    normals = rng.standard_normal((C, W, 1, N)).astype(np.float32)
    ys = (np.exp(0.5 * rng.standard_normal((C, W)))
          * rng.standard_normal((C, W))).astype(np.float32)
    weights = rng.uniform(1.0, 3.0, (C, W)).astype(np.float32)
    weights[:, :2] = 0.0                     # buffer steps
    xi = rng.uniform(0.0, 1.0, (C, W)).astype(np.float32)
    return pvec, x0, normals, ys, weights, xi


def port_window(*arrays, lambduh):
    out = fused_pf.fused_window(svm.FUSED,
                                *[torch.from_numpy(a) for a in arrays],
                                lambduh=lambduh)
    return out.numpy()


@pytest.mark.parametrize("lambduh", [1.0, 0.95])
def test_reference_matches_jax_fused_kernel(lambduh):
    """Tolerance: the JAX kernel's bf16 hi/lo gather bound
    (tests/test_fused_pf.py), statistic 2e-3, loglik rtol 1e-4."""
    C, N, W = 2, 64, 16
    pvec, x0, normals, ys, weights, xi = draws(1, C, N, W)
    out = port_window(pvec, x0, normals, ys, weights, xi, lambduh=lambduh)
    ms, ll = fused_window_batched(
        jsvm.FUSED, jnp.asarray(pvec), jnp.asarray(fold(x0)),
        jnp.asarray(fold(normals)), jnp.asarray(ys), jnp.asarray(weights),
        jnp.asarray(xi), lambduh=lambduh, interpret=True)
    np.testing.assert_allclose(out[:, :3], np.asarray(ms), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(out[:, 3], np.asarray(ll), rtol=1e-4)


def jax_gather_run(params_row, ys, weights, key, N, lambduh, smoother):
    """JAX run_buffered_pf (gather mode, systematic) on one chain, and the
    draws it consumes rebuilt in the port's layout."""
    W = ys.shape[0]
    p = jsvm.from_scalars(float(params_row[0]), float(params_row[1]) ** -2,
                          float(params_row[2]) ** -2)
    pv = float(jsvm.stationary_variance(p))
    y = jnp.asarray(ys[:, None])
    w = jnp.asarray(weights)
    ref = jbuffered.run_buffered_pf(
        jsvm.KERNEL, jsvm.grad_statistic, p, y, key=key, n_particles=N,
        statistic_dim=3, smoother=smoother, step_weights=w,
        in_window=(w > 0).astype(w.dtype), prior_mean=0.0, prior_var=pv,
        resampler="systematic", resample_mode="gather", lambduh=lambduh)
    key_init, key_steps = jax.random.split(key)
    z0 = jax.random.normal(key_init, (N, 1), jnp.float32)
    x0 = np.array(0.0 + jnp.sqrt(pv) * z0)[:, 0]
    zs, xis = [], []
    for k in jax.random.split(key_steps, W):
        kr, kp = jax.random.split(k)
        xis.append(np.array(jax.random.uniform(kr, (), jnp.float32)))
        zs.append(np.array(jax.random.normal(kp, (N, 1), jnp.float32))[:, 0])
    port_pvec = np.array(jsvm._fused_pack(p), np.float32)
    return ref, port_pvec, x0[None], np.stack(zs)[:, None], np.stack(xis)


def port_paths(pvec, x0, normals, ys, weights, xi, lambduh, smoother):
    """(fused reference, run_buffered_pf) outputs [C, H+1] on one draw."""
    t = torch.from_numpy
    fused = port_window(pvec, x0, normals, ys, weights, xi,
                        lambduh=1.0 if smoother == "poyiadjis_N" else lambduh)
    params = svm.SVMParams(A=t(pvec[:, 0]).reshape(-1, 1, 1),
                           LQinv_vec=t(pvec[:, 1:2]),
                           LRinv_vec=t(pvec[:, 2:3]))
    w = t(weights)
    # x0 = 0 + sqrt(1) * x0 exactly: both paths start from the same x0
    out = buffered.run_buffered_pf(
        svm.KERNEL, svm.grad_statistic, params, t(ys)[..., None],
        z0=t(x0), normals=t(normals), u=t(xi), statistic_dim=3,
        smoother=smoother, step_weights=w, in_window=(w > 0).float(),
        prior_mean=torch.zeros(len(pvec)), prior_var=torch.ones(len(pvec)),
        resampler="systematic", lambduh=lambduh)
    plain = torch.cat([out.mean_statistic, out.loglikelihood[:, None]],
                      1).numpy()
    return fused, plain


@pytest.mark.parametrize("smoother,lambduh",
                         [("poyiadjis_N", 1.0), ("nemeth", 0.95)])
def test_port_matches_jax_gather_path(smoother, lambduh):
    """Both selections are exact float32 searches, so agreement is to
    rounding: statistic rtol=atol=1e-4, loglik rtol 1e-5.  The JAX gather
    path searches side='left' on cumsum(probs); the port side='right' on
    cumsum(w)/tot, which differ only on exact ties."""
    N, W = 64, 16
    pvec, _, _, ys, weights, _ = draws(2, 2, N, W)
    for c, seed in enumerate([0, 5]):
        ref, pv_c, x0, normals, xi = jax_gather_run(
            pvec[c], ys[c], weights[c], jax.random.PRNGKey(seed), N,
            lambduh, smoother)
        fused, plain = port_paths(pv_c[None], x0[None], normals[None],
                                  ys[c:c + 1], weights[c:c + 1], xi[None],
                                  lambduh, smoother)
        want_stat = np.asarray(ref.mean_statistic)
        want_ll = float(ref.loglikelihood)
        for got in (fused, plain):
            np.testing.assert_allclose(got[0, :3], want_stat, rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(got[0, 3], want_ll, rtol=1e-5)


def test_degenerate_weights_fall_back_to_uniform():
    """An observation so large that every log-weight is -inf: the CDF
    becomes uniform (ancestor i for particle i), the loglik -inf, and the
    statistic keeps the -inf of grad_LRinv; the other components agree
    with the JAX gather path."""
    N, W = 64, 12
    pvec, _, _, ys, weights, _ = draws(3, 1, N, W)
    ys[0, 5] = 1e30
    ref, pv_c, x0, normals, xi = jax_gather_run(
        pvec[0], ys[0], weights[0], jax.random.PRNGKey(7), N, 1.0,
        "poyiadjis_N")
    fused, plain = port_paths(pv_c[None], x0[None], normals[None], ys,
                              weights, xi[None], 1.0, "poyiadjis_N")
    want = np.asarray(ref.mean_statistic)
    assert float(ref.loglikelihood) == -np.inf
    assert want[0] == -np.inf
    for got in (fused, plain):
        assert got[0, 3] == -np.inf
        assert got[0, 0] == -np.inf
        np.testing.assert_allclose(got[0, 1:3], want[1:], rtol=1e-4,
                                   atol=1e-4)


def test_wrapper_rejects_malformed_inputs():
    pvec, x0, normals, ys, weights, xi = [
        torch.from_numpy(a) for a in draws(4, 2, 16, 4)]
    with pytest.raises(ValueError, match="normals"):
        fused_pf.fused_window(svm.FUSED, pvec, x0, normals[:, :3], ys,
                              weights, xi)
    with pytest.raises(TypeError, match="float32"):
        fused_pf.fused_window(svm.FUSED, pvec.double(), x0, normals, ys,
                              weights, xi)
    with pytest.raises(ValueError, match="contiguous"):
        fused_pf.fused_window(svm.FUSED, pvec, x0, normals,
                              ys.t().contiguous().t(), weights, xi)
