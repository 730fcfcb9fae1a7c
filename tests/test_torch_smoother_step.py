"""The unfused Poyiadjis O(N) smoother's step kernel route: its plain
version (``smoother_step_reference``) against the PyTorch step of
``ops/smoothers.py``, and the route rule of ``run_buffered_pf``.

The carry, the log-weights and the next step's CDF must equal the PyTorch
step's bit for bit (same operations, same order); the log-likelihood sums
in another order, so it is held to 1e-6.  The CUDA kernel itself is held
to the PyTorch step on the card (``chip_smoke.py``, phase 29).
"""
import pytest
import torch

from sgmcmc_tpu_torch.models import garch, svm
from sgmcmc_tpu_torch.ops import buffered
from sgmcmc_tpu_torch.ops.cuda import resample
from sgmcmc_tpu_torch.ops.cuda.smoother_step import smoother_step
from sgmcmc_tpu_torch.ops.smoothers import (PFCarry, PFStepInput,
                                            make_nemeth_step)

torch.set_num_threads(1)

C, N, W = 16, 64, 8
MODELS = {
    "svm": (svm.KERNEL, svm.grad_statistic, svm.FUSED, svm.STATISTIC_DIM),
    "garch_optimal": (garch.OPTIMAL_KERNEL, garch.grad_statistic,
                      garch.FUSED, garch.STATISTIC_DIM),
    "garch_prior": (garch.PRIOR_KERNEL, garch.grad_statistic,
                    garch.FUSED_PRIOR, garch.STATISTIC_DIM),
}


def chain_params(body, gen):
    u = torch.rand((C, 4), generator=gen)
    if body == "svm":
        return svm.SVMParams(A=(0.5 + 0.45 * u[:, 0]).reshape(C, 1, 1),
                             LQinv_vec=(0.3 + 1.2 * u[:, 1:2]) ** -0.5,
                             LRinv_vec=(0.5 + 1.5 * u[:, 2:3]) ** -0.5)
    return garch.GARCHParams(log_mu=torch.log(0.2 + 0.3 * u[:, 0:1]),
                             logit_phi=torch.logit(0.5 + 0.4 * u[:, 1:2]),
                             logit_lambduh=torch.logit(0.2 + 0.6 * u[:, 2:3]),
                             LRinv_vec=(0.3 + 0.7 * u[:, 3:4]) ** -0.5)


def inputs(body, resampler, seed=0):
    """Parameters, observations [C, W, 1], draws and step weights of a
    buffered window (zero weight on the first and last steps of some
    chains, a weight of 2.5 inside)."""
    gen = torch.Generator().manual_seed(seed)
    params = chain_params(body, gen)
    obs = 0.8 * torch.randn((C, W, 1), generator=gen)
    z0 = torch.randn((C, 1, N), generator=gen)
    normals = torch.randn((C, W, 1, N), generator=gen)
    u = torch.rand((C, W) if resampler == "systematic" else (C, W, N),
                   generator=gen)
    in_window = torch.ones((C, W))
    in_window[: C // 2, 0] = 0.0
    in_window[C // 4:, -1] = 0.0
    step_w = 2.5 * in_window
    return params, obs, z0, normals, u, step_w, in_window


def check_steps(body, resampler, degenerate=False):
    """Step by step on one window: resample-apply on the carry buffer at
    the last CDF, then the step's plain version, against
    ``make_nemeth_step(..., 1.0)``.  ``degenerate`` puts an observation of
    1e30 at the last step, whose log-weights are then all -inf (the
    uniform CDF) in half the chains."""
    kernel, stat_fn, model, H = MODELS[body]
    params, obs, z0, normals, u, step_w, in_w = inputs(body, resampler)
    if degenerate:
        obs[: C // 2, -1] = 1e30
    D = kernel.state_dim
    x0 = buffered._initial_particles(kernel, params, z0, 0.0, 1.0,
                                     torch.float32, obs.device)
    step = make_nemeth_step(kernel, stat_fn, 1.0, resampler)
    carry = PFCarry(x0, torch.zeros((C, N)), torch.zeros((C, N, H)),
                    torch.zeros((C,)))
    buf = torch.cat([x0, torch.zeros((C, N, H))], -1)
    log_w, loglik = torch.zeros((C, N)), torch.zeros((C,))
    cdf = resample.weights_cdf(log_w)
    pvec = model.pack_params(params).contiguous()
    for t in range(W):
        carry = step(params, carry, PFStepInput(
            z=normals[:, t].transpose(1, 2), u=u[:, t], y=obs[:, t],
            weight=step_w[:, t], in_window=in_w[:, t], t=t))
        pos = resample.resample_positions(resampler, u[:, t], N)
        rows = resample.resample_apply(pos.contiguous(), cdf, buf)
        smoother_step(model, pvec, rows, normals[:, t], obs[:, t, 0],
                      step_w[:, t], in_w[:, t], buf, log_w, cdf, loglik)
        for got, want in ((buf[..., :D], carry.particles),
                          (buf[..., D:], carry.statistics),
                          (log_w, carry.log_weights),
                          (cdf, resample.weights_cdf(carry.log_weights))):
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       equal_nan=True)
        torch.testing.assert_close(loglik, carry.loglik, rtol=1e-6,
                                   atol=1e-6, equal_nan=True)
    return log_w


@pytest.mark.parametrize("resampler", ["multinomial", "stratified"])
@pytest.mark.parametrize("body", sorted(MODELS))
def test_reference_step_equals_pytorch_step(body, resampler):
    """Carry, log-weights and CDF bit for bit at every step of a window."""
    check_steps(body, resampler)


@pytest.mark.parametrize("body", sorted(MODELS))
def test_reference_step_degenerate_weights(body):
    """Weights that are all zero fall back to the uniform CDF as the
    PyTorch step's do."""
    log_w = check_steps(body, "multinomial", degenerate=True)
    assert bool((log_w[: C // 2] == -float("inf")).all())


def window_args(body, resampler, **kw):
    """run_buffered_pf's positional and keyword arguments on one window."""
    kernel, stat_fn, model, H = MODELS[body]
    params, obs, z0, normals, u, step_w, in_w = inputs(body, resampler)
    common = dict(z0=z0, normals=normals, u=u, statistic_dim=H,
                  step_weights=step_w, in_window=in_w, resampler=resampler)
    common.update(kw)
    return (kernel, stat_fn, params, obs), common


@pytest.mark.parametrize("resampler", ["multinomial", "systematic"])
def test_route_equals_pytorch_window(resampler):
    """The whole window on the step kernel's route (GARCH optimal, its
    plain version on the CPU) equals the PyTorch smoother's: carry and
    mean statistic bit for bit, the log-likelihood to 1e-6."""
    (kernel, stat_fn, params, obs), common = window_args("garch_optimal",
                                                         resampler)
    want = buffered.run_buffered_pf(kernel, stat_fn, params, obs, **common)
    got = buffered.run_step_kernel(MODELS["garch_optimal"][2], kernel,
                                   params, obs, **common)
    for name in ("particles", "log_weights", "statistics",
                 "mean_statistic"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    torch.testing.assert_close(got.loglikelihood, want.loglikelihood,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["cpu", "ess_gate", "step_valid",
                                  "nemeth"])
def test_fallback_returns_pytorch_path(monkeypatch, case):
    """Where the step kernel does not apply (CPU tensors, and on any device
    the ESS gate, ``step_valid`` or another smoother), ``fused_model``
    changes nothing: the same PyTorch steps, the same outputs."""
    kw = {"cpu": {},
          "ess_gate": dict(ess_threshold=0.5),
          "step_valid": dict(step_valid=(torch.arange(W) < W - 2).float()
                             .expand(C, W).contiguous()),
          "nemeth": dict(smoother="nemeth", lambduh=0.9)}[case]
    args, common = window_args("garch_optimal", "multinomial", **kw)
    calls = []
    monkeypatch.setattr(buffered, "run_step_kernel",
                        lambda *a, **k: calls.append(1))
    want = buffered.run_buffered_pf(*args, **common)
    got = buffered.run_buffered_pf(*args, fused_model=MODELS[
        "garch_optimal"][2], **common)
    assert not calls
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_step_input_checks():
    """Rows of the wrong width are refused."""
    rows = torch.zeros((2, 4, 5))
    with pytest.raises(ValueError, match="rows of 5 floats"):
        smoother_step(garch.FUSED, torch.zeros((2, 4)), rows,
                      torch.zeros((2, 1, 4)), *torch.zeros((3, 2)),
                      rows.clone(), torch.zeros((2, 4)),
                      torch.zeros((2, 4)), torch.zeros(2))
