"""Whole runs of the harness on the CPU at a small size: the look for a
card skipped, the port on its CPU routes.  A sound run is correct; the
control in the program's place and each fault planted in the timed path
are not; the command itself fails where there is no card."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import check, main, spec
from benchmark.tests.small import cpu_route, small_cell
from sgmcmc_tpu_torch.inference import sgmcmc
from sgmcmc_tpu_torch.ops import smoothers
from sgmcmc_tpu_torch.parallel import training

ONE_CARD = ["svm_k1", "garch_unfused", "garch_k1", "svm_unfused",
            "svm_paris100"]


def _run(cell, traced=False, seed=2 ** 31 + 77):
    with cpu_route(cell):
        return main.run_cell(cell, seed, 0.5, traced, time.time(), "cpu",
                             "gloo")


@pytest.mark.parametrize("name", ONE_CARD)
def test_sound_run_is_correct(name):
    cell = small_cell(name)
    out, metrics, correct, checks, _ = _run(cell)
    assert correct, checks
    assert out.attempted >= 1 and out.failed == 0
    assert {"steps_per_s", "setup_s"} <= set(metrics)
    assert list(checks)[:5] == list(check.NUMBERS)


def test_traced_run_reads_its_metrics_and_is_correct():
    cell = small_cell("garch_k1")
    out, metrics, correct, checks, _ = _run(cell, traced=True)
    assert correct, checks
    assert out.run.traces and out.run.traces[0].calls == 1
    # no device in this process: nothing for the device's readers
    assert "device_idle_pct" not in metrics and "k1_roofline" not in metrics


@pytest.mark.parametrize("name", ONE_CARD)
def test_control_in_the_programs_place_is_not_correct(name):
    """The reference in bfloat16 (the precision below the configuration's
    float32) put in the port's place fails the check."""
    cell = small_cell(name)
    out, _, _, _, _ = _run(cell)
    ref = spec.reference_model(cell.config["reference"])
    obs, first, last = out.check_inputs
    args = (ref, cell.config, cell.workload, obs, first, last)
    values = check.in_place(ref.LEAVES, last, check.reference_outputs(*args),
                            check.reference_outputs(*args,
                                                    dtype=torch.bfloat16))
    correct, _ = check.verdict(values, cell.workload["limits"])
    assert not correct, values


@pytest.mark.parametrize("name", ONE_CARD)
def test_sound_reorder_in_the_programs_place_is_correct(name):
    """The reference in another summation order (a sound program) put in
    the port's place passes: the check follows the program's own steps,
    so a rounding does not flip the resampling of the steps after it."""
    cell = small_cell(name)
    out, _, _, _, _ = _run(cell)
    ref = spec.reference_model(cell.config["reference"])
    obs, first, last = out.check_inputs
    args = (ref, cell.config, cell.workload, obs, first, last)
    values = check.in_place(ref.LEAVES, last, check.reference_outputs(*args),
                            check.reference_outputs(*args, fault="reorder"))
    correct, _ = check.verdict(values, cell.workload["limits"])
    assert correct, values


def _unchanged(monkeypatch):
    real = sgmcmc.sgld_step

    def step(gen, params, obs, grad_fn, eps, T, **kw):
        _, ll = real(gen, params, obs, grad_fn, eps, T, **kw)
        return params, ll
    monkeypatch.setattr(sgmcmc, "sgld_step", step)


def _half_batch(monkeypatch):
    """Each filter keeps half of its particles; the mean over the rest."""
    fused, unfused = sgmcmc.fused_pf_score, sgmcmc.run_buffered_pf

    def fused_half(model, params, window, step_w, z0, normals, *rest):
        n = z0.shape[-1] // 2
        return fused(model, params, window, step_w, z0[..., :n],
                     None if normals is None else normals[..., :n], *rest)

    def unfused_half(*a, z0, normals, u, v=None, **kw):
        n = z0.shape[-1] // 2
        return unfused(*a, z0=z0[..., :n], normals=normals[..., :n],
                       u=u[..., :n] if u.dim() == 3 else u,
                       v=None if v is None else v[:, :, :n], **kw)
    monkeypatch.setattr(sgmcmc, "fused_pf_score", fused_half)
    monkeypatch.setattr(sgmcmc, "run_buffered_pf", unfused_half)


def _altered(monkeypatch):
    """One chain's log-likelihoods altered where the fit produces them."""
    real = sgmcmc.fit

    def fit(*a, **kw):
        params, trace, aux = real(*a, **kw)
        aux = aux.clone()
        aux[0] = aux[0] * (1.0 + 1e-3)
        return params, trace, aux
    monkeypatch.setattr(sgmcmc, "fit", fit)


def _half_chains(monkeypatch):
    """Half of the chains left where they were by every step."""
    real = sgmcmc.sgld_step

    def step(gen, params, obs, grad_fn, eps, T, **kw):
        new, ll = real(gen, params, obs, grad_fn, eps, T, **kw)

        def keep(a, b):
            a = a.clone()
            a[: a.shape[0] // 2] = b[: b.shape[0] // 2]
            return a
        return type(new)(**{k: keep(getattr(new, k), getattr(params, k))
                            for k in _fields(new)}), ll
    monkeypatch.setattr(sgmcmc, "sgld_step", step)


def _fields(params):
    import dataclasses
    return [f.name for f in dataclasses.fields(params)]


@pytest.mark.parametrize("name", ONE_CARD)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered,
                                   _half_chains])
def test_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = small_cell(name)
    fault(monkeypatch)
    _, _, correct, checks, _ = _run(cell)
    assert not correct, {k: v["value"] for k, v in checks.items()}


def _one_backward(monkeypatch):
    """PaRIS takes one backward draw a particle (the first, repeated) in
    place of n_tilde."""
    real = smoothers._backward_indices

    def one(*a, **kw):
        J = real(*a, **kw)
        return J[..., :1].expand_as(J)
    monkeypatch.setattr(smoothers, "_backward_indices", one)


def _uniform_backward(monkeypatch):
    """PaRIS's backward indices drawn uniformly, ignoring the backward
    weights."""
    def uniform(kernel, params, particles, log_weights, new_particles, v,
                bw_chunk):
        n = log_weights.shape[-1]
        return (v * n).long().clamp(max=n - 1)
    monkeypatch.setattr(smoothers, "_backward_indices", uniform)


@pytest.mark.parametrize("fault", [_one_backward, _uniform_backward])
def test_paris_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    cell = small_cell("svm_paris100")
    fault(monkeypatch)
    _, _, correct, checks, _ = _run(cell)
    assert not correct, {k: v["value"] for k, v in checks.items()}


def test_island_cell_on_two_cpu_ranks(monkeypatch):
    """The island route over gloo at two ranks: sound, then with one
    chain's answers altered, then with half of the chains left
    unstepped, then with rank 0's exchange left out (it takes part in the
    collective but keeps its own island's statistic)."""
    cell = small_cell("svm_island_4chip", chains=4, T=120, N=32, ranks=2)
    _, _, correct, checks, _ = _run(cell)
    assert correct, checks
    for fault in (_altered, _half_chains):
        with monkeypatch.context() as m:
            fault(m)
            _, _, correct, checks, _ = _run(cell)
            assert not correct, {k: v["value"] for k, v in checks.items()}
    real = training.sharding.all_reduce

    def own_only(x, op, group):
        real(x.clone(), op, group)
        return x * 2
    monkeypatch.setattr(training.sharding, "all_reduce", own_only)
    _, _, correct, checks, _ = _run(cell)
    assert not correct, {k: v["value"] for k, v in checks.items()}


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "svm_k1",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_command_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _command(spec.ROOT, env)
    assert r.returncode != 0
    assert not r.stdout.strip()


def test_command_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _command(tmp_path)
    assert r.returncode != 0
    assert not r.stdout.strip()


@pytest.mark.card
def test_command_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = _command(spec.ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
