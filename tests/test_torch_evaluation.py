"""The port's evaluation layer against the JAX package: the IMQ KSD, the
convergence diagnostics and KS tests, the metric and sample functions, the
evaluators (rows on traces carried across with ``params_from_jax``), the
trace averages, checkpoint and trace files, plotting, ``fit_evaluate`` and
the profiling helpers.

Both sides get the same numpy inputs.  The NumPy-level code (convergence,
KS, evaluator rows, averages) is held exactly; the KSD, which the port
computes in torch (float64) and JAX in XLA, at rtol 1e-10; the LGSSM's
exact log-likelihood (float64 Kalman filter on both sides) at rtol 1e-10.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgmcmc_tpu_torch
from sgmcmc_tpu.evaluation import evaluator as jev
from sgmcmc_tpu.inference import samplers as jsamplers
from sgmcmc_tpu.metrics import convergence as jconv
from sgmcmc_tpu.metrics import ks_test as jks
from sgmcmc_tpu.metrics import ksd as jksd
from sgmcmc_tpu.metrics import metric_functions as jmf
from sgmcmc_tpu.models import lgssm as jl
from sgmcmc_tpu_torch.evaluation import evaluator as ev
from sgmcmc_tpu_torch.inference import samplers
from sgmcmc_tpu_torch.io import checkpoint
from sgmcmc_tpu_torch.metrics import convergence, ks_test, ksd
from sgmcmc_tpu_torch.metrics import metric_functions as mf
from sgmcmc_tpu_torch.models import lgssm
from sgmcmc_tpu_torch.utils import profiling

torch.set_num_threads(1)

FIELDS = ("A", "C", "LQinv_vec", "LRinv_vec")
TRUTH = (0.8, 0.5, 1.3)         # (A, Q, R), C = 1


def jax_trace(k=7, seed=0):
    """k JAX LGSSM parameters (float64) around TRUTH."""
    rng = np.random.default_rng(seed)
    a, q, r = TRUTH
    return [jl.from_matrices(A=[[a + 0.1 * rng.standard_normal()]],
                             C=[[1.0]], Q=[[q * np.exp(0.1 * z1)]],
                             R=[[r * np.exp(0.1 * z2)]])
            for z1, z2 in rng.standard_normal((k, 2))]


def port_trace(jtrace):
    return [lgssm.params_from_jax(p, torch.float64) for p in jtrace]


def series(T=30):
    return lgssm.generate_data(torch.Generator().manual_seed(3),
                               lgssm.from_scalars(*TRUTH,
                                                  dtype=torch.float64), T)[0]


@pytest.mark.parametrize("block", [64, 128, 1000])
def test_ksd_matches_jax_and_block_size(block):
    """IMQ KSD of 300 samples in 3 dimensions: equal to JAX's at every
    block size (64 and 128 pad the last block), and to the unblocked
    value."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 3))
    g = -x + 0.3 * rng.standard_normal((300, 3))
    want = float(jksd.imq_ksd(jnp.asarray(x), jnp.asarray(g), 1.0, 0.5,
                              block))
    got = ksd.imq_ksd(x, g, 1.0, 0.5, block, device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(float(got), want, rtol=1e-10)
    np.testing.assert_allclose(
        float(got), float(ksd.imq_ksd(x, g, max_block_size=300,
                                      device="cpu")), rtol=1e-10)


def test_compute_ksd_over_a_trace_matches_jax():
    jtrace = jax_trace(12)
    jgrads = [jax.tree_util.tree_map(lambda v: -v, p) for p in jtrace]
    want = jksd.compute_ksd(jtrace, jgrads, ["A", "LQinv_vec"],
                            max_block_size=5)
    got = ksd.compute_ksd(port_trace(jtrace), port_trace(jgrads),
                          ["A", "LQinv_vec"], max_block_size=5, device="cpu")
    # the same trace as numpy leaves (as load_trace gives it back)
    got_np = ksd.compute_ksd(
        [checkpoint.tree_to_numpy(p) for p in port_trace(jtrace)],
        [checkpoint.tree_to_numpy(p) for p in port_trace(jgrads)],
        ["A", "LQinv_vec"], max_block_size=5, device="cpu")
    assert set(got) == set(want) == set(got_np)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10)
        assert got_np[k] == got[k]


def test_ksd_runs_on_the_card_unless_asked_for_the_cpu():
    """imq_ksd / compute_ksd default to the card, as the samplers do:
    without a CUDA device they raise unless device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = np.zeros((4, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ksd.imq_ksd(x, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ksd.compute_ksd(port_trace(jax_trace(3)), port_trace(jax_trace(3)),
                        ["A"])


def test_convergence_matches_jax_exactly():
    """Every estimator on identical numpy chains (AR(1) chains, one
    shifted), bit for bit; the summary of a stacked trace (port
    dataclass against JAX parameters) row for row."""
    rng = np.random.default_rng(1)
    C, N = 4, 400
    x = np.zeros((C, N))
    for i in range(1, N):
        x[:, i] = 0.7 * x[:, i - 1] + rng.standard_normal(C)
    x[0] += 0.5
    for name in ("split_rhat", "rhat_rank", "ess", "ess_bulk", "ess_tail",
                 "iact", "mean_se"):
        for arg in (x, x[1]):
            assert getattr(convergence, name)(arg) == \
                getattr(jconv, name)(arg), name
    jstack = jl.LGSSMParams(
        A=x[:, :, None, None], C=np.ones((C, N, 1, 1)),
        LQinv_vec=np.exp(0.1 * x)[:, :, None],
        LRinv_vec=rng.standard_normal((C, N, 1)))
    pstack = lgssm.LGSSMParams(*[torch.from_numpy(np.asarray(
        getattr(jstack, f))) for f in FIELDS])
    want = jconv.convergence_summary(jstack)
    got = convergence.convergence_summary(pstack)
    assert [r["variable"] for r in got] == [r["variable"] for r in want]
    assert got == want
    assert convergence.convergence_summary({"a": x}) == \
        jconv.convergence_summary({"a": x})


def test_ks_test_traces_match_jax():
    jtrace, jref = jax_trace(30, 1), jax_trace(40, 2)
    want = jks.ks_test_traces(jtrace, jref, ["A", "LQinv_vec"])
    got = ks_test.ks_test_traces(port_trace(jtrace), port_trace(jref),
                                 ["A", "LQinv_vec"])
    assert got == want


def jax_lgssm_sampler(ys, params):
    """The JAX sampler on the port sampler's float32 observations."""
    s = jsamplers.LGSSMSampler(observations=np.asarray(
        ys, np.float32).astype(np.float64), seed=0)
    s.parameters = params
    return s


def test_offline_evaluator_rows_match_jax():
    """The OfflineEvaluator over a JAX trace and over the same trace
    carried across: parameter errors, parameter samples and the exact
    log-likelihood, in the same bisection order; then the trace averages."""
    ys = series()
    jtrace = jax_trace(9)
    truth_j = jl.from_matrices(A=[[0.8]], C=[[1.0]], Q=[[0.5]], R=[[1.3]])
    truth_p = lgssm.params_from_jax(truth_j, torch.float64)

    def fns(module, truth):
        return (
            [module.metric_function_parameters(truth, ["A", "LQinv_vec"],
                                               "mse"),
             module.metric_function_from_sampler("exact_loglikelihood")],
            [module.sample_function_parameters(["A", "LRinv_vec"])])
    jm, js = fns(jmf, truth_j)
    je = jev.OfflineEvaluator(jax_lgssm_sampler(ys, jtrace[0]), jtrace,
                              parameters_times=range(9), metric_functions=jm,
                              sample_functions=js)
    je.evaluate(num_to_eval=5)
    pm, ps = fns(mf, truth_p)
    pe = ev.OfflineEvaluator(samplers.LGSSMSampler(ys, device="cpu"),
                             port_trace(jtrace), parameters_times=range(9),
                             metric_functions=pm, sample_functions=ps)
    assert pe.evaluate(num_to_eval=5) == 5
    assert list(pe.eval_flag) == list(je.eval_flag)
    want = je.get_metrics().to_dict("records")
    got = pe.metric_rows
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("iteration", "metric", "variable",
                                  "time")} == \
            {k: w[k] for k in ("iteration", "metric", "variable", "time")}
        np.testing.assert_allclose(g["value"], w["value"], rtol=1e-10,
                                   err_msg=g["metric"])
    assert pe.sample_rows == je.get_samples().to_dict("records")
    assert pe.get_metrics().shape == je.get_metrics().shape
    for fn in ("average_parameters_list", "half_average_parameters_list"):
        kw = dict(burnin=2) if fn == "average_parameters_list" else {}
        want = getattr(jev, fn)(jtrace, **kw)
        got = getattr(ev, fn)(port_trace(jtrace), **kw)
        for g, w in zip(got, want):
            for f in FIELDS:
                np.testing.assert_allclose(
                    getattr(g, f).numpy().reshape(-1),
                    np.asarray(getattr(w, f)).reshape(-1), rtol=1e-12)


def test_sampler_evaluator_and_fit_evaluate_on_cpu():
    """The online evaluator: steps timed, rows kept as dicts (no DataFrame
    built unless read), save / load of its state; fit_evaluate with the
    sampler's and the evaluation's clocks apart."""
    ys = series(40)
    s = samplers.LGSSMSampler(ys, device="cpu", seed=1)
    truth = lgssm.from_scalars(*TRUTH)
    e = ev.SamplerEvaluator(
        s, metric_functions=[mf.metric_function_parameters(truth, ["A"])],
        sample_functions=[mf.sample_function_parameters(["A"])])
    e.evaluate_sampler_step(["sample_sgld", "project_parameters"],
                            [dict(epsilon=0.01, N=16, subsequence_length=8,
                                  buffer_length=2), {}])
    assert e._metrics_df is None
    assert [r["metric"] for r in e.metric_rows] == ["A_logmse", "A_logmse",
                                                    "runtime"]
    state = e.save_state()
    e2 = ev.SamplerEvaluator(s, init_state=state)
    assert e2.iteration == 1 and e2.metric_rows == e.metric_rows
    assert "runtime" in set(e.get_metrics()["metric"])
    fe = s.fit_evaluate(
        "SGLD", max_time=0.3, epsilon=0.01, eval_freq=0.1,
        metric_functions=[mf.noisy_logjoint_loglike_metric(
            kind="marginal")],
        sample_functions=[mf.sample_function_parameters(["A"])],
        subsequence_length=8, buffer_length=2, kind="marginal")
    rows = fe.metric_rows
    assert fe.iteration >= 1 and fe.elapsed_time >= 0.3
    assert rows[-1]["iteration"] == fe.iteration
    assert rows[-1]["time"] == fe.elapsed_time
    assert {r["metric"] for r in rows} == {"logjoint", "loglikelihood"}
    assert all(np.isfinite(r["value"]) for r in rows)


def test_metric_compare_and_predictive_metrics():
    """metric_compare_x (the LGSSM's exact smoothed means, float64)
    against the JAX package's; the predictive metric's rows; z metrics on
    the JAX package's permutation logic, and metric_compare_z pointing at
    the HMM family's slice."""
    ys = series()
    jp = jl.from_matrices(A=[[0.8]], C=[[1.0]], Q=[[0.5]], R=[[1.3]])
    true_x = np.random.default_rng(4).standard_normal((30, 1))
    want = jmf.metric_compare_x(true_x)(jax_lgssm_sampler(ys, jp))
    s = samplers.LGSSMSampler(ys, device="cpu", parameters=(
        lgssm.params_from_jax(jp, torch.float64)))
    got = mf.metric_compare_x(true_x)(s)
    assert got["metric"] == want["metric"] == "x_rmse"
    np.testing.assert_allclose(got["value"], want["value"], rtol=1e-10)
    # the particle filter's predictive rows on float32 parameters (the
    # resample-apply kernel's type)
    s32 = samplers.LGSSMSampler(ys, device="cpu",
                                parameters=lgssm.params_from_jax(jp))
    rows = mf.noisy_predictive_logjoint_loglike_metric(2, kind="pf",
                                                       N=16)(s32)
    assert [r["metric"] for r in rows] == [f"{k}_pred_loglikelihood"
                                           for k in range(3)]
    rows = mf.noisy_predictive_logjoint_loglike_metric(1)(s)
    np.testing.assert_allclose(rows[0]["value"], float(
        s.predictive_loglikelihood(kind="marginal", lag=1)), rtol=1e-12)
    probs = np.random.default_rng(5).dirichlet(np.ones(3), 40)
    true_z = np.random.default_rng(6).integers(0, 3, 40)
    fake = type("S", (), dict(
        model=type("M", (), dict(name="fake",
                                 latent_var_distr=lambda p, o: probs)),
        parameters=None, observations=None))()
    want_z = jmf.metric_compare_z(true_z)(fake)
    got_z = mf.z_metric_rows(true_z, probs)
    assert [r["metric"] for r in got_z] == [r["metric"] for r in want_z]
    for g, w in zip(got_z, want_z):
        np.testing.assert_allclose(g["value"], w["value"], rtol=1e-12)
    with pytest.raises(NotImplementedError, match="slice 12"):
        mf.metric_compare_z(true_z)(s)


def test_checkpoint_and_trace_round_trips(tmp_path):
    """Checkpoint (parameters as NumPy, the generator's state) and trace
    files round-trip; stack / unstack invert each other; CSV write."""
    trace = port_trace(jax_trace(4))
    gen = torch.Generator().manual_seed(9)
    path = str(tmp_path / "ck" / "state.pkl")
    checkpoint.save_checkpoint(path, parameters=trace[1],
                               generator_state=gen.get_state(), iteration=7,
                               extra={"note": 1})
    ck = checkpoint.load_checkpoint(path)
    assert ck["iteration"] == 7 and ck["extra"] == {"note": 1}
    assert isinstance(ck["parameters"].A, np.ndarray)
    back = checkpoint.tree_to_torch(ck["parameters"])
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(trace[1], f))
    g2 = torch.Generator()
    g2.set_state(torch.from_numpy(ck["generator_state"]))
    assert torch.equal(torch.rand(5, generator=g2), torch.rand(5,
                                                               generator=gen))
    stacked = checkpoint.stack_trace(trace)
    assert stacked.A.shape == (4, 1, 1, 1)
    for a, b in zip(checkpoint.unstack_trace(stacked), trace):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f),
                                          getattr(b, f).numpy())
    tpath = str(tmp_path / "trace.pkl")
    checkpoint.save_trace(tpath, trace, times=[0.0, 1.0, 2.0, 3.0],
                          extra={"chain_parameters": stacked})
    tr = checkpoint.load_trace(tpath)
    assert tr["times"] == [0.0, 1.0, 2.0, 3.0]
    assert len(tr["parameters_list"]) == 4 and "chain_parameters" in tr
    e = ev.BaseEvaluator()
    e._metric_rows.append(dict(iteration=0, metric="m", variable="v",
                               value=1.5))
    csv = str(tmp_path / "m.csv")
    checkpoint.save_dataframe(csv, e.metrics)
    assert open(csv).read().splitlines() == ["iteration,metric,variable,"
                                             "value", "0,m,v,1.5"]
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_plotting_writes_its_files(tmp_path):
    from sgmcmc_tpu_torch.evaluation import plotting
    ys = series(20)
    s = samplers.LGSSMSampler(ys, device="cpu", seed=1)
    e = ev.SamplerEvaluator(
        s, metric_functions=[mf.metric_function_parameters(
            lgssm.from_scalars(*TRUTH), ["A"])],
        sample_functions=[mf.sample_function_parameters(["A"])])
    for _ in range(3):
        e.evaluate_sampler_step("sample_sgld", [dict(
            epsilon=0.01, N=8, subsequence_length=6, buffer_length=1)])
    files = ["metrics.png", "trace.png", "compare.png", "fit.png",
             "svm_fit.png"]
    paths = [str(tmp_path / f) for f in files]
    plotting.plot_metrics(e.get_metrics(), path=paths[0])
    plotting.plot_trace_plot(e.get_samples(), path=paths[1])
    plotting.compare_metrics({"a": e}, "A_logmse", path=paths[2])
    plotting.plot_data_fit(ys.numpy(), np.zeros(20), np.ones(20),
                           path=paths[3])
    plotting.plot_svm_data_fit(ys.numpy(), sampler=s, N=8, path=paths[4])
    for p in paths:
        assert os.path.getsize(p) > 0, p


def test_profiling_helpers(tmp_path):
    t = profiling.Timer()
    for _ in range(2):
        with t.section("a"):
            profiling.sync(torch.ones(3))
    assert t.counts == {"a": 2} and t.rows()[0]["variable"] == "a"
    p = lgssm.from_scalars(*TRUTH)
    assert profiling.sync(p) == pytest.approx(0.8)
    assert profiling.sync({"x": [1, torch.tensor([2.0])]}) == 2.0
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64).cumsum(0)
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert len(prof.key_averages()) > 0


def test_root_exports_and_no_framework_imports():
    """The root exports of the JAX package that the port now has; the
    evaluation layer's modules import neither JAX nor (at import)
    pandas / matplotlib."""
    for name in ("ModelAPI", "get_model", "sampler_for_model",
                 "BaseEvaluator", "SamplerEvaluator", "OfflineEvaluator"):
        assert name in sgmcmc_tpu_torch.__all__
        assert getattr(sgmcmc_tpu_torch, name) is not None
    root = os.path.dirname(sgmcmc_tpu_torch.__file__)
    for sub in ("metrics", "evaluation", "io", "utils"):
        for fn in os.listdir(os.path.join(root, sub)):
            if not fn.endswith(".py"):
                continue
            src = open(os.path.join(root, sub, fn)).read()
            assert "import jax" not in src and "sgmcmc_tpu." not in src, fn
            if fn != "plotting.py":
                assert "import matplotlib" not in src, fn
                assert "\nimport pandas" not in src, fn
    assert dataclasses.is_dataclass(ev.ravel_params(
        lgssm.from_scalars(*TRUTH))[1](np.zeros(4)))
