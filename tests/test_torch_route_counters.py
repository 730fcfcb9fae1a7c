"""The port's route counters: window steps taken by the PyTorch step
(``run_buffered_pf.pytorch_steps``) and the fused window's launches by
body and normals source (``fused_pf.fused_window_by_body``)."""
import pytest
import torch

from sgmcmc_tpu_torch.inference.samplers import SVJMSampler, SVMSampler
from sgmcmc_tpu_torch.models import garch, lgssm, svjm, svm
from sgmcmc_tpu_torch.ops import buffered
from sgmcmc_tpu_torch.ops.cuda import fused_pf

torch.set_num_threads(1)


@pytest.mark.parametrize("cls,pf", [(SVJMSampler, "poyiadjis_N"),
                                    (SVMSampler, "poyiadjis_N"),
                                    (SVJMSampler, "paris")])
def test_pytorch_step_counter_advances_once_a_window_step(cls, pf):
    """On the CPU every window step of every iteration takes the PyTorch
    step: iterations x W of them, W = S + 2B."""
    ys = torch.randn(80, generator=torch.Generator().manual_seed(0))
    s = cls(observations=ys, device="cpu", seed=1)
    before = buffered.run_buffered_pf.pytorch_steps
    s.fit_scan("SGLD", num_iters=3, num_chains=2, N=16,
               subsequence_length=8, buffer_length=2, pf=pf,
               resampler="multinomial")
    assert buffered.run_buffered_pf.pytorch_steps - before == 3 * (8 + 2 * 2)


def test_pytorch_step_counter_counts_a_direct_window():
    C, W, N = 3, 7, 11
    g = torch.Generator().manual_seed(2)
    params = svjm.from_scalars(0.9, 0.5, 1.0, 0.05, 2.0)
    params = svjm.SVJMParams(**{k: getattr(params, k).expand(
        (C,) + getattr(params, k).shape[1:]) for k in
        ("A", "LQinv_vec", "LRinv_vec", "logit_pJ", "LQJinv_vec")})
    before = buffered.run_buffered_pf.pytorch_steps
    out = buffered.run_buffered_pf(
        svjm.KERNEL, svjm.grad_statistic, params,
        torch.randn((C, W, 1), generator=g),
        z0=torch.randn((C, 2, N), generator=g),
        normals=torch.randn((C, W, 2, N), generator=g),
        u=torch.rand((C, W, N), generator=g),
        statistic_dim=svjm.STATISTIC_DIM)
    assert buffered.run_buffered_pf.pytorch_steps - before == W
    assert bool(torch.isfinite(out.mean_statistic).all())


BODIES = [svm.FUSED, svjm.FUSED, garch.FUSED, garch.FUSED_PRIOR,
          lgssm.FUSED, lgssm.FUSED_PRIOR]


@pytest.mark.parametrize("in_kernel", [True, False])
@pytest.mark.parametrize("model", BODIES, ids=lambda m: m.body)
def test_k1_counter_key_names_body_and_normals_source(model, in_kernel):
    """Each model's fused body has a counter named after it and the
    normals' source, starting at a count; a launch advances the total and
    that counter alone."""
    key = fused_pf.launch_key(model.body, in_kernel)
    assert key == model.body + ("_kernel" if in_kernel else "_host")
    counts = vars(fused_pf.fused_window_by_body)
    assert len(counts) == 2 * len(fused_pf._BODIES) and key in counts
    before, total = dict(counts), fused_pf.fused_window.launches
    fused_pf._count_launch(model.body, in_kernel)
    assert fused_pf.fused_window.launches == total + 1
    after = vars(fused_pf.fused_window_by_body)
    assert {k for k in after if after[k] != before[k]} == {key}
    assert after[key] == before[key] + 1


def test_plain_fused_window_counts_no_launch(monkeypatch):
    """The fused window's plain version (CPU tensors) launches nothing."""
    from sgmcmc_tpu_torch.inference import sgmcmc
    monkeypatch.setattr(sgmcmc.PFScore, "uses_fused",
                        lambda self, device: True)
    ys = torch.randn(80, generator=torch.Generator().manual_seed(3))
    s = SVJMSampler(observations=ys, device="cpu", seed=1)
    before = dict(vars(fused_pf.fused_window_by_body))
    total, steps = (fused_pf.fused_window.launches,
                    buffered.run_buffered_pf.pytorch_steps)
    s.fit_scan("SGLD", num_iters=2, num_chains=2, N=16,
               subsequence_length=8, buffer_length=2,
               resampler="systematic", rng="kernel")
    assert vars(fused_pf.fused_window_by_body) == before
    assert fused_pf.fused_window.launches == total
    assert buffered.run_buffered_pf.pytorch_steps == steps
