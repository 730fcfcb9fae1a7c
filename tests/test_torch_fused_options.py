"""The fused window's options in the port: the ESS gate (plain version
against the JAX package's fused kernel in interpret mode), in-kernel
normals (against the plain version fed the Philox normals), and the
sampler repairs that route them: ``rng`` reaches the score, ``kind`` is
honoured, and ESS-gated systematic configurations take the fused route.

Draws are made once with numpy and fed to both packages; the JAX kernel
stores particles folded as [s, B] with particle j = s*p + q at (row q,
lane p), the port in natural order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgmcmc_tpu.models import svm as jsvm
from sgmcmc_tpu.ops.pallas.fused_pf import fused_window_batched
from sgmcmc_tpu_torch.inference import samplers, sgmcmc
from sgmcmc_tpu_torch.models import svm
from sgmcmc_tpu_torch.ops.cuda import fused_pf, philox

torch.set_num_threads(1)


def fold(a):
    """[..., D, N] natural particle order -> [..., D*s, B], j = s*p + q."""
    B = a.shape[-1] // 8
    f = np.swapaxes(a.reshape(a.shape[:-1] + (B, 8)), -1, -2)
    return f.reshape(a.shape[:-2] + (-1, B))


def draws(seed, C, N, W):
    rng = np.random.default_rng(seed)
    pvec = np.stack([rng.uniform(0.5, 0.95, C),
                     rng.uniform(0.3, 1.5, C) ** -0.5,
                     rng.uniform(0.5, 2.0, C) ** -0.5], -1).astype(np.float32)
    x0 = rng.standard_normal((C, 1, N)).astype(np.float32) * 2.0
    normals = rng.standard_normal((C, W, 1, N)).astype(np.float32)
    # observations from small to large: informative steps collapse the
    # ESS, uninformative ones keep it high
    ys = (np.exp(rng.uniform(-2.0, 2.0, (C, W)))
          * rng.standard_normal((C, W))).astype(np.float32)
    weights = rng.uniform(1.0, 3.0, (C, W)).astype(np.float32)
    weights[:, :2] = 0.0
    xi = rng.uniform(0.0, 1.0, (C, W)).astype(np.float32)
    return pvec, x0, normals, ys, weights, xi


def port(arrays, **kw):
    return fused_pf.fused_window(
        svm.FUSED, *[torch.from_numpy(a) for a in arrays], **kw).numpy()


@pytest.mark.parametrize("lambduh", [1.0, 0.95])
def test_ess_gate_matches_jax_fused_kernel(lambduh):
    """Tolerances of the JAX kernel's bf16 hi/lo gather bound
    (tests/test_torch_fused_pf.py): statistic rtol=atol=2e-3, loglik rtol
    1e-4.  The gated window differs from the always-resampling one (some
    steps skip) and from the never-resampling one (some resample)."""
    C, N, W = 2, 64, 10
    arrays = draws(11, C, N, W)
    pvec, x0, normals, ys, weights, xi = arrays
    out = port(arrays, lambduh=lambduh, ess_threshold=0.5)
    ms, ll = fused_window_batched(
        jsvm.FUSED, jnp.asarray(pvec), jnp.asarray(fold(x0)),
        jnp.asarray(fold(normals)), jnp.asarray(ys), jnp.asarray(weights),
        jnp.asarray(xi), lambduh=lambduh, interpret=True, ess_threshold=0.5)
    np.testing.assert_allclose(out[:, :3], np.asarray(ms), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(out[:, 3], np.asarray(ll), rtol=1e-4)
    always = port(arrays, lambduh=lambduh)
    never = port(arrays, lambduh=lambduh, ess_threshold=0.0)
    for c in range(C):
        assert not np.allclose(out[c], always[c], rtol=1e-4, atol=1e-4)
        assert not np.allclose(out[c], never[c], rtol=1e-4, atol=1e-4)


def test_kernel_normals_equal_reference_fed_philox_normals():
    """fused_pf_score with seeds (normals made in the window, the CPU
    route of the kernel) equals the same call fed the Philox normals of
    stream 0, exactly."""
    C, N, W = 3, 32, 10
    _, _, _, ys, weights, xi = draws(12, C, N, W)
    params = svm.SVMParams(A=torch.full((C, 1, 1), 0.9),
                           LQinv_vec=torch.full((C, 1), 1.3),
                           LRinv_vec=torch.full((C, 1), 0.9))
    seeds = torch.tensor([3, -4, 2 ** 50])
    z0 = torch.randn((C, 1, N), generator=torch.Generator().manual_seed(0))
    t = torch.from_numpy
    args = (svm.FUSED, params, t(ys), t(weights), z0)
    tail = (t(xi), torch.zeros(C), torch.ones(C))
    got = fused_pf.fused_pf_score(*args, None, *tail, seeds=seeds)
    want = fused_pf.fused_pf_score(
        *args, philox.philox_normals_reference(seeds, W, 1, N), *tail)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="exactly one"):
        fused_pf.fused_pf_score(*args, None, *tail)


def cpu_sampler(seed=0):
    rng = np.random.default_rng(seed)
    ys = (np.exp(0.5 * rng.standard_normal(40))
          * rng.standard_normal(40)).astype(np.float32)
    s = samplers.SVMSampler(observations=ys, seed=seed, device="cpu")
    s.parameters = svm.from_scalars(0.5, 1.0, 2.0)
    return s


FIT = dict(num_iters=2, epsilon=0.1, num_chains=3, record="none",
           return_aux=True, N=32, subsequence_length=8, buffer_length=2,
           pf="poyiadjis_N", resampler="systematic")


def test_rng_reaches_the_score_config_and_a_bad_rng_raises():
    s = cpu_sampler()
    s.fit_scan("SGLD", rng="kernel", **FIT)
    assert [k[1].rng for k in s._cache if k[0] == "grad"] == ["kernel"]
    with pytest.raises(ValueError, match="rng"):
        s.fit_scan("SGLD", rng="hardware", **FIT)


def test_rng_kernel_changes_the_draws_on_the_fused_route(monkeypatch):
    """On the fused route (forced onto the CPU here, where the kernel's
    plain version runs) rng='kernel' draws one seed per chain row instead
    of the [R, W, Z, N] normals, its initial-state normals are the seeds'
    stream 1, and the fit differs from rng='host' on the same generator."""
    monkeypatch.setattr(sgmcmc.PFScore, "uses_fused",
                        lambda self, device: sgmcmc._fused_eligible(
                            self.config, self.fused_model))
    cfg = sgmcmc.PFScoreConfig(n_particles=16, subsequence_length=8,
                               buffer_length=2, resampler="systematic",
                               resample_mode="auto", rng="kernel")
    score = sgmcmc.make_pf_score_fn(svm.KERNEL, svm.grad_statistic, 3,
                                    svm.unpack_grad, cfg, 40,
                                    fused_model=svm.FUSED)
    d = score.draw(torch.Generator().manual_seed(1), 5, "cpu")
    assert d.normals is None and d.seeds.shape == (5,)
    assert torch.equal(d.z0, philox.philox_normals(
        d.seeds, 1, 1, 16, stream=philox.STREAM_INIT)[:, 0])
    out = {}
    for rng in ("host", "kernel"):
        _, aux = cpu_sampler(seed=2).fit_scan("SGLD", rng=rng, **FIT)
        assert bool(torch.isfinite(aux).all())
        out[rng] = aux
    assert not torch.equal(out["host"], out["kernel"])


@pytest.mark.parametrize("kind,exc", [("marginal", NotImplementedError),
                                      ("complete", NotImplementedError),
                                      ("exact", ValueError)])
def test_kind_other_than_pf_raises(kind, exc):
    s = cpu_sampler()
    with pytest.raises(exc, match="has no" if exc is NotImplementedError
                       else "kind"):
        s.fit_scan("SGLD", kind=kind, **FIT)
    _, aux = s.fit_scan("SGLD", kind="pf", **FIT)
    assert bool(torch.isfinite(aux).all())


def test_ess_gated_systematic_configs_take_the_fused_route():
    def eligible(**kw):
        return sgmcmc._fused_eligible(
            sgmcmc.PFScoreConfig(resample_mode="auto", **kw), svm.FUSED)
    assert eligible(resampler="systematic", ess_threshold=0.5)
    assert eligible(resampler="systematic", smoother="nemeth",
                    ess_threshold=0.3)
    assert not eligible(resampler="multinomial", ess_threshold=0.5)
    assert not eligible(resampler="systematic", smoother="poyiadjis_N2")
