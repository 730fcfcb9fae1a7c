"""The port's route rule and keywords against the JAX package's fit_scan:
which configurations take the fused window kernel on a CUDA device
(decided without a card: the shared-memory query is replaced), the
sharded-fit keywords, which the port does not have yet and must not drop,
and ``is_scaled``."""
import numpy as np
import pytest
import torch

from sgmcmc_tpu_torch.inference import samplers, sgmcmc
from sgmcmc_tpu_torch.models import lgssm, registry, svm
from sgmcmc_tpu_torch.ops.cuda import fused_pf

torch.set_num_threads(1)

# the LGSSM body's largest N at W=60 on the card (PERF.md section 6)
LGSSM_N_MAX = 4834


@pytest.fixture
def smem_calls(monkeypatch):
    """Replace the library's shared-memory query with K1's LGSSM limit and
    record its calls."""
    calls = []

    def fits(body, W, N, valid_gate=False):
        calls.append((body, W, N, valid_gate))
        return N <= LGSSM_N_MAX
    monkeypatch.setattr(fused_pf, "fits_shared_memory", fits)
    return calls


def lgssm_score(resample_mode="auto", **kw):
    cfg = sgmcmc.PFScoreConfig(resampler="systematic", subsequence_length=40,
                               buffer_length=10, resample_mode=resample_mode,
                               **kw)
    api = registry.LGSSM
    return sgmcmc.make_pf_score_fn(
        api.get_kernel(None), api.grad_statistic, api.grad_statistic_dim,
        api.unpack_grad, cfg, 1000, prior_mean_var_fn=api.prior_mean_var,
        fused_model=api.get_fused(None))


@pytest.mark.parametrize("N,fused", [(8192, False), (LGSSM_N_MAX + 1, False),
                                     (LGSSM_N_MAX, True), (1024, True)])
def test_particle_counts_beyond_shared_memory_take_the_unfused_route(
        smem_calls, N, fused):
    score = lgssm_score(n_particles=N)
    assert score.uses_fused("cuda") is fused
    assert smem_calls == [("lgssm_optimal", 60, N, False)]
    assert not score.uses_fused("cpu")


def test_seq_score_asks_with_its_valid_gate(smem_calls):
    api = registry.SVM
    cfg = sgmcmc.PFScoreConfig(n_particles=8192, resampler="systematic",
                               resample_mode="auto", subsequence_length=-1)
    score = sgmcmc.make_seq_pf_score_fn(
        api.get_kernel(None), api.grad_statistic, api.grad_statistic_dim,
        api.unpack_grad, cfg, [30, 50], fused_model=svm.FUSED)
    assert not score.uses_fused("cuda")
    assert smem_calls == [("svm", 50, 8192, True)]


@pytest.mark.parametrize("mode,fused", [
    ("auto", True), ("pallas", True), ("pallas2", True), ("fused", True),
    ("gather", False), ("xla", False)])
def test_resample_mode_rule(smem_calls, mode, fused):
    """The JAX package's resample modes: only auto / pallas / pallas2 /
    fused may take the fused kernel; any N may (N=1000 is no multiple of
    8, the TPU's constraint, which the port does not copy)."""
    for N in (1000, 1024):
        assert lgssm_score(n_particles=N,
                           resample_mode=mode).uses_fused("cuda") is fused
    # an ineligible configuration never asks the library
    assert len(smem_calls) == (2 if fused else 0)
    # JAX's dataclass default keeps a score off the fused kernel; the
    # samplers' default, as in JAX's fit_scan, is "auto"
    assert sgmcmc.PFScoreConfig().resample_mode == "gather"
    s = samplers.SVMSampler(observations=np.zeros(30, np.float32),
                            device="cpu")
    assert s._score_config().resample_mode == "auto"


@pytest.mark.parametrize("kw", [dict(mesh=object()),
                                dict(n_particle_devices=2),
                                dict(island_fused=True)])
def test_sharded_fit_keywords_raise(kw):
    """``mesh=`` and ``n_particle_devices=`` route fit_scan to the
    distributed fit, whose contract errors come before any mesh is read or
    made: SGLD only, the particle filter's score only, and a P that
    divides the world (none here: it names torchrun).  ``island_fused``
    alone selects nothing, as in the JAX package's fit_scan."""
    s = samplers.SVMSampler(observations=np.zeros(30, np.float32),
                            device="cpu")
    if "island_fused" in kw:
        trace = s.fit_scan("SGLD", num_iters=1, N=16, **kw)
        assert bool(torch.isfinite(trace.A).all())
        return
    with pytest.raises(NotImplementedError, match="SGLD"):
        s.fit_scan("SGD", num_iters=1, N=16, **kw)
    with pytest.raises(NotImplementedError, match="kind='pf'"):
        s.fit_scan("SGLD", num_iters=1, N=16, kind="marginal", **kw)
    if "n_particle_devices" in kw:
        with pytest.raises(ValueError, match="torchrun"):
            s.fit_scan("SGLD", num_iters=1, N=16, **kw)
    assert s._cache == {}


@pytest.mark.parametrize("kind", ["pf", "marginal"])
def test_is_scaled_false_gives_T_times_the_scaled_gradient(kind):
    """The same draws (generators of one seed) through the scaled and the
    unscaled gradient: the unscaled one is T times the scaled one, and
    each has its own cache entry."""
    T = 40
    ys = np.random.default_rng(0).standard_normal(T).astype(np.float32)
    s = samplers.LGSSMSampler(observations=ys, device="cpu")
    s.parameters = lgssm.from_scalars(0.7, 0.6, 1.2)
    kw = dict(kind=kind, subsequence_length=8, buffer_length=2, N=32)
    out = {}
    for scaled in (True, False):
        fn = s._grad_fn(is_scaled=scaled, **kw)
        out[scaled] = fn(torch.Generator().manual_seed(3), s.parameters,
                         s.observations)
    assert s._grad_fn(is_scaled=False, **kw) is not s._grad_fn(**kw)
    assert torch.equal(out[True][1], out[False][1])
    for f in ("A", "C", "LQinv_vec", "LRinv_vec"):
        np.testing.assert_allclose(getattr(out[False][0], f).numpy(),
                                   T * getattr(out[True][0], f).numpy(),
                                   rtol=1e-6, atol=1e-7)
    trace = s.fit_scan("SGLD", num_iters=2, is_scaled=False, **kw)
    assert bool(torch.isfinite(trace.A).all())
