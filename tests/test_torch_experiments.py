"""The port's experiments layer against the JAX package: the option grids,
the script builder, the natural-coordinate gradients, the evaluation
lists of a trace, the convergence and KS rows, the pandas-free tables
(``options.csv``, ``aggregated.csv`` against pandas and JAX's own
``do_process_out``), the pickles' modules, the gradient-error figure's
truth and sweep, and the driver's pipeline, resume and refusals.

Both sides get the same numpy inputs.  The numpy-level code is held
exactly (convert_gradient at 1e-12); the LGSSM truth, float64 messages in
the port against JAX's float32 calls, at rtol 1e-5; the PF sweep in law
(|z| < 5).  The driver runs on the CPU (``--device cpu``) with
``max_num_iters``, never on a wall-clock budget.
"""
import dataclasses
import os
import pickletools
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from sgmcmc_tpu.experiments import config as jcfg
from sgmcmc_tpu.experiments import driver as jd
from sgmcmc_tpu.experiments import script_builder as jsb
from sgmcmc_tpu.io import checkpoint as jckpt
from sgmcmc_tpu.metrics import convergence as jconv
from sgmcmc_tpu.models import garch as jgarch
from sgmcmc_tpu.models import lgssm as jl
from sgmcmc_tpu.models import svjm as jsvjm
from sgmcmc_tpu.models import svm as jsvm
from sgmcmc_tpu.ops import kalman as jk
from sgmcmc_tpu.ops.subsequence import subsequence_weights as jweights
from sgmcmc_tpu_torch.experiments import config as cfg
from sgmcmc_tpu_torch.experiments import driver
from sgmcmc_tpu_torch.experiments import gradient_error_figs as figs
from sgmcmc_tpu_torch.experiments import script_builder as sb
from sgmcmc_tpu_torch.inference import samplers
from sgmcmc_tpu_torch.io import checkpoint as ckpt
from sgmcmc_tpu_torch.io import tables
from sgmcmc_tpu_torch.metrics import convergence
from sgmcmc_tpu_torch.models import (arphmm, garch, gauss_hmm, lgssm, slds,
                                     svjm, svm)

torch.set_num_threads(1)

MODELS = ("svm", "svjm", "garch", "lgssm", "gauss_hmm", "arphmm", "slds")
# a small grid over the default one's names: 3 iterations of one step
SMALL = dict(max_num_iters=3, steps_per_iteration=1, N=32,
             subsequence_length=10, buffer_length=2)


def args_for(path, model="svm", *extra):
    return driver.build_parser().parse_args(
        ["--path", str(path), "--model", model, "--device", "cpu", "--T",
         "60", "--T_test", "40", "--eval_N", "32", "--num_to_eval", "2",
         "--eval_predictive", "2", "--ksd_N", "32", "--max_ksd_samples",
         "6", *extra])


def small_grid(model, names=None):
    return [dict(o, **SMALL) for o in driver.default_sampler_grid(model)
            if names is None or o["name"] in names]


# --------------------------------------------------------------------------
# configuration and scripts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_default_sampler_grid_matches_jax(model):
    assert driver.default_sampler_grid(model) == \
        jd.default_sampler_grid(model)


def test_config_matches_jax():
    assert cfg.DEFAULT_OPTIONS == jcfg.DEFAULT_OPTIONS
    grid = [dict(a=[1, 2], b=["x"]), dict(c=[0.5, 0.25], a=[3])]
    assert cfg.parameter_grid(grid) == jcfg.parameter_grid(grid)
    lists = ([dict(a=1), dict(a=2)], [dict(b=3), dict(b=4, a=5)])
    assert cfg.dict_product(*lists) == jcfg.dict_product(*lists)
    for o in (dict(N=64, pf="paris"), dict(kind="marginal", rng="kernel",
                                            Ntilde=4, bw_chunk=128,
                                            lambduh=0.9, latent_draws=2,
                                            latent_burnin=3,
                                            latent_thinning=1)):
        assert cfg.with_defaults(o) == jcfg.with_defaults(o)
        assert cfg.sampler_kwargs(cfg.with_defaults(o)) == \
            jcfg.sampler_kwargs(jcfg.with_defaults(o))


def test_script_builder_matches_jax(tmp_path):
    """The same script text for the same argument dicts, the driver's
    invocation apart; the port's scripts run its driver as a module."""
    arg_dicts = [dict(path="/x y", model="svm", experiment_id=i, fit=True,
                      eval="half_avg_test", flag=False, seeds=[1, 2])
                 for i in range(3)]
    out = {}
    for name, mod, target in (("jax", jsb, "/repo/driver.py"),
                              ("port", sb, driver.DRIVER_MODULE)):
        d = tmp_path / name
        scripts = mod.script_builder("fit", target, arg_dicts, str(d),
                                     script_splits=2, project_root="/r",
                                     conda_env_name="env")
        scripts.append(mod.chain_scripts("run_all", scripts, str(d)))
        out[name] = [open(s).read().replace(str(d), "D") for s in scripts]
    port = [t.replace(f"python -m {driver.DRIVER_MODULE} ",
                      "python /repo/driver.py ") for t in out["port"]]
    assert port == out["jax"]
    assert f"python -m {driver.DRIVER_MODULE} --path '/x y'" in \
        out["port"][0]
    # the driver's own scripts
    args = args_for(tmp_path / "exp")
    written = driver.do_make_scripts(args, [dict(experiment_id=0)])
    text = open(written[0]).read()
    assert f"python -m {driver.DRIVER_MODULE} --path" in text
    assert "--device cpu" in text


# --------------------------------------------------------------------------
# natural coordinates, evaluation lists, convergence, KS
# --------------------------------------------------------------------------

def jax_params(model, rng):
    if model == "svm":
        p = jsvm.from_scalars(0.8, 0.6, 1.3, dtype=jnp.float64)
    elif model == "svjm":
        p = jsvjm.from_scalars(0.8, 0.6, 1.3, pJ=0.1, QJ=2.0,
                               dtype=jnp.float64)
    elif model == "garch":
        p = jgarch.from_alpha_beta_gamma(0.1, 0.4, 0.3, 0.5,
                                         dtype=jnp.float64)
    elif model == "lgssm":
        p = jl.from_matrices(A=[[0.8]], C=[[1.0]], Q=[[0.6]], R=[[1.3]],
                             dtype=jnp.float64)
    else:
        p = jd._make_true_params(model, dtype=jnp.float64)
    fields = [f.name for f in dataclasses.fields(p)]
    perturbed = p.replace(**{f: np.asarray(getattr(p, f), np.float64)
                             * np.exp(0.1 * rng.standard_normal())
                             for f in fields})
    grad = p.replace(**{f: rng.standard_normal(np.shape(getattr(p, f)))
                        for f in fields})
    return perturbed, grad


PORT_CLASSES = dict(svm=svm.SVMParams, svjm=svjm.SVJMParams,
                    garch=garch.GARCHParams, lgssm=lgssm.LGSSMParams,
                    gauss_hmm=gauss_hmm.GaussHMMParams,
                    arphmm=arphmm.ARPHMMParams, slds=slds.SLDSParams)


def to_port(model, p):
    """A JAX one-chain parameter object as the port's (numpy leaves with
    the chain axis)."""
    return PORT_CLASSES[model](**{
        f.name: np.asarray(getattr(p, f.name), np.float64)[None]
        for f in dataclasses.fields(p)})


@pytest.mark.parametrize("model", MODELS)
def test_convert_gradient_matches_jax(model):
    rng = np.random.default_rng(MODELS.index(model))
    p, g = jax_params(model, rng)
    want_v, want_g = jd.convert_gradient(model, p, g)
    got_v, got_g = driver.convert_gradient(model, to_port(model, p),
                                           to_port(model, g))
    for var in driver.KSD_VARIABLES[model]:
        np.testing.assert_allclose(getattr(got_v, var),
                                   getattr(want_v, var), rtol=1e-12)
        np.testing.assert_allclose(getattr(got_g, var),
                                   getattr(want_g, var), rtol=1e-12)


def stacked_traces(C=3, n=7, seed=0):
    """The same multichain SVM trace as JAX's and the port's trace dicts
    (chain 0's list, the times and the stacked [C, n, ...] trace)."""
    rng = np.random.default_rng(seed)
    A = 0.5 + 0.1 * rng.standard_normal((C, n, 1, 1))
    LQ = 1.0 + 0.1 * rng.random((C, n, 1))
    LR = 1.0 + 0.1 * rng.random((C, n, 1))
    times = [0.0] + sorted(rng.random(n).tolist())
    j_stacked = jsvm.SVMParams(A=A, LQinv_vec=LQ, LRinv_vec=LR)
    p_stacked = svm.SVMParams(A=A, LQinv_vec=LQ, LRinv_vec=LR)
    j_list = [jsvm.SVMParams(A=A[0, i], LQinv_vec=LQ[0, i],
                             LRinv_vec=LR[0, i]) for i in range(n)]
    p_list = [svm.SVMParams(A=A[0, i][None], LQinv_vec=LQ[0, i][None],
                            LRinv_vec=LR[0, i][None]) for i in range(n)]
    return (dict(parameters_list=j_list, times=times,
                 chain_parameters=j_stacked, num_chains=C),
            dict(parameters_list=p_list, times=times,
                 chain_parameters=p_stacked, num_chains=C))


def flat(params_list):
    return np.stack([np.concatenate([np.ravel(np.asarray(getattr(p, f)))
                                     for f in ("A", "LQinv_vec",
                                               "LRinv_vec")])
                     for p in params_list]) if params_list else np.zeros(0)


@pytest.mark.parametrize("mode,half_avg,burn", [
    ("0", False, None), ("0", True, None), ("0", False, 1 / 3),
    ("pooled", False, None), ("pooled", True, None),
    ("pooled", False, 1 / 3), ("pooled", True, 1 / 3)])
def test_eval_params_list_matches_jax(mode, half_avg, burn):
    jtrace, ptrace = stacked_traces()
    args = types.SimpleNamespace(eval_chains=mode)
    want, want_t = jd._eval_params_list(args, jtrace, half_avg, burn)
    got, got_t = driver._eval_params_list(args, ptrace, half_avg, burn)
    np.testing.assert_allclose(flat(got), flat(want), rtol=1e-15)
    assert list(got_t) == list(want_t)
    assert all(p.A.shape == (1, 1, 1) for p in got)


def test_pooled_eval_with_nothing_left_adds_no_times():
    """``sgmcmc_tpu/experiments/driver.py:684`` takes
    ``chain_times[-len(lst):]``: for a chain with no sample left, -0, so
    every time.  The port adds no times for it."""
    jtrace, ptrace = stacked_traces(C=2, n=5)
    args = types.SimpleNamespace(eval_chains="pooled")
    j_list, j_times = jd._eval_params_list(args, jtrace, burn_frac=1.0)
    p_list, p_times = driver._eval_params_list(args, ptrace, burn_frac=1.0)
    assert j_list == [] and len(j_times) == 2 * 5       # the fault
    assert p_list == [] and list(p_times) == []


def test_convergence_rows_match_jax():
    """The single-chain fit's rows: the trace stacked [1, n, ...] as the
    JAX driver stacks it, the same coordinate names and numbers."""
    jtrace, ptrace = stacked_traces(C=1, n=24, seed=3)
    want = jconv.convergence_summary(jax.tree_util.tree_map(
        lambda *xs: np.stack(xs)[None], *jtrace["parameters_list"]),
        burn_frac=0.5)
    got = convergence.convergence_summary(
        driver._stack_one_chain(ptrace["parameters_list"]), burn_frac=0.5)
    assert [r["variable"] for r in got] == [r["variable"] for r in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(w[k], str):
                assert g[k] == w[k]
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-12)


def test_ks_test_matches_jax(tmp_path):
    """do_eval_ks_test on the same LGSSM traces: the same kstest.csv."""
    rng = np.random.default_rng(5)

    def trace(n):
        return [(0.7 + 0.1 * z1, 1.0, 0.6 * np.exp(0.1 * z2),
                 1.2 * np.exp(0.1 * z3))
                for z1, z2, z3 in rng.standard_normal((n, 3))]
    traces = {0: trace(30), 1: trace(24)}
    opts = [dict(experiment_id=0, iter_type="Gibbs", model="lgssm"),
            dict(experiment_id=1, iter_type="SGLD", model="lgssm")]
    for side, mod, make in (
            ("jax", jckpt, lambda a, c, q, r: jl.from_matrices(
                A=[[a]], C=[[c]], Q=[[q]], R=[[r]], dtype=jnp.float64)),
            ("port", ckpt, lambda a, c, q, r: ckpt.tree_to_numpy(
                lgssm.from_matrices(a, c, q, r, dtype=torch.float64)))):
        for i, tr in traces.items():
            mod.save_trace(str(tmp_path / side / "out" / "fit"
                               / f"{i}_parameters.p"),
                           [make(*v) for v in tr])
    args = types.SimpleNamespace(path=str(tmp_path / "jax"))
    jd.do_eval_ks_test(args, opts[1], opts)
    driver.do_eval_ks_test(types.SimpleNamespace(path=str(tmp_path / "port")),
                           opts[1], opts)
    name = os.path.join("out", "trace_eval", "1_kstest.csv")
    assert open(tmp_path / "port" / name).read() == \
        open(tmp_path / "jax" / name).read()


# --------------------------------------------------------------------------
# tables without pandas
# --------------------------------------------------------------------------

def test_tables_write_what_pandas_writes(tmp_path):
    rows = [dict(a=1, b=0.1, c="x,y", d=True, e=None, f=np.float64(1e-5)),
            dict(a=2, b=1 / 3, c='say "z"', d=False, g=np.int64(3)),
            dict(a=3, b=float("nan"), c=None, d=True, f=float("inf"))]
    assert tables.to_csv_text(tables.from_rows(rows)) == \
        pd.DataFrame(rows).to_csv(index=False)
    # read back as pd.read_csv reads (its parser keeps 17 digits, leading
    # zeros counted: 0.009986823000417644 reads as 0.0099868230004176)
    path = str(tmp_path / "t.csv")
    tables.write_csv(path, [dict(v=0.009986823000417644, w=7),
                            dict(v=2.5e-300, w=None)])
    want = pd.read_csv(path).to_csv(index=False)
    assert tables.to_csv_text(tables.read_csv(path)) == want
    assert "0.0099868230004176," in want


# --------------------------------------------------------------------------
# gradient-error figure
# --------------------------------------------------------------------------

def test_lgssm_truth_matches_jax():
    """The exact buffered truth against the JAX figure's Kalman calls
    (``gradient_error_figs.py:71-87``) on the same ys."""
    T, L = 100, 16
    params, ys = figs.make_observations("lgssm", T, 0, "cpu")
    got = figs.ground_truth("lgssm", params, ys, L)
    start = (T - L) // 2
    p = jd._make_true_params("lgssm", dtype=jnp.float32)

    @jax.jit
    def truth(p, y):
        w = jweights(start, L, T, "uniform", y.dtype)
        f = jk.forward_message(y[:start], p.A, p.C, p.LQinv, p.LRinv,
                               jl.default_forward_message(p))
        b = jk.backward_message(y[start + L:], p.A, p.C, p.LQinv, p.LRinv,
                                jl.default_backward_message(p))
        return jl.gradient_marginal_loglikelihood(
            p, y[start:start + L], forward_msg=f, backward_msg=b, weights=w)
    g = truth(p, jnp.asarray(ys.numpy()))
    want = np.concatenate([np.asarray(g.LRinv_vec), np.asarray(g.LQinv_vec),
                           np.asarray(g.C).ravel(), np.asarray(g.A).ravel()])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pf_sweep_against_the_lgssm_truth(tmp_path):
    """A buffer over the whole series: the PF gradient's mean within
    |z| < 5 of the exact truth; the CSV written without pandas."""
    T, L, reps = 40, 8, 64
    params, ys = figs.make_observations("lgssm", T, 1, "cpu")
    truth = figs.ground_truth("lgssm", params, ys, L)
    rows = figs.sweep("lgssm", params, ys, L, truth, buffer_sizes=(T,),
                      particle_counts=(256,), reps=reps,
                      generator=torch.Generator().manual_seed(2))
    z = [r["abs_bias"] / np.sqrt(r["variance"] / reps) for r in rows]
    assert len(rows) == 4 and max(z) < 5, z
    tables.write_csv(str(tmp_path / "g.csv"), rows)
    assert open(tmp_path / "g.csv").read() == \
        pd.DataFrame(rows).to_csv(index=False)


# --------------------------------------------------------------------------
# the pipeline, resume and refusals
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def svm_experiment(tmp_path_factory):
    """setup -> every fit -> a multichain fit -> eval -> ksd -> a KSD run
    of 10 passes over its 3 samples, then the same run interrupted after
    its checkpoint at 20 scores (its state kept) on the SVM, on the CPU."""
    root = tmp_path_factory.mktemp("svm_experiment")
    args = args_for(root)
    opts = driver.do_setup(args, small_grid("svm"))
    for o in opts:
        driver.do_fit(args, o)
    args.num_chains = 3
    driver.do_fit(args, dict(opts[2], checkpoint_num_iters=2))
    args.num_chains = 1
    driver.do_eval(args, opts[0], "half_avg_test")
    ksd = driver.do_eval_ksd(args, opts[1])
    passes = types.SimpleNamespace(**vars(args))
    passes.ksd_passes = 10
    full = driver.do_eval_ksd(passes, opts[1])
    real, calls = driver.score_block, []

    def failing(sampler, params_list, **kw):
        calls.append(len(params_list))
        if sum(calls) > 20:
            raise RuntimeError("interrupted")
        return real(sampler, params_list, **kw)
    driver.score_block = failing
    try:
        with pytest.raises(RuntimeError):
            driver.do_eval_ksd(passes, opts[1])
    finally:
        driver.score_block = real
    return types.SimpleNamespace(root=root, args=args, opts=opts, ksd=ksd,
                                 passes=passes, full=full, calls=calls)


def test_svm_pipeline_outputs(svm_experiment):
    e = svm_experiment
    out = os.path.join(e.root, "out")
    assert len(e.opts) == 8 and all(np.isfinite(list(e.ksd.values())))
    for o in e.opts:
        tr = ckpt.load_trace(os.path.join(
            out, "fit", f"{o['experiment_id']}_parameters.p"))
        assert len(tr["parameters_list"]) == 4
        assert np.isfinite(flat(tr["parameters_list"])).all()
    mc = ckpt.load_trace(os.path.join(out, "fit", "2_parameters.p"))
    assert mc["chain_parameters"].A.shape == (3, 3, 1, 1)
    assert os.path.exists(os.path.join(out, "eval",
                                       "0_half_avg_test_metrics.csv"))


def test_process_out_matches_jax(svm_experiment):
    """JAX's own do_process_out on a copy of the port's experiment
    directory writes the same aggregated.csv as the port's; options.csv
    is JAX's (``driver.py:285``)."""
    e = svm_experiment
    agg = driver.do_process_out(e.args, e.opts)
    copy = str(e.root) + "_jax"
    shutil.copytree(e.root, copy)
    jd.do_process_out(types.SimpleNamespace(path=copy), e.opts)
    name = os.path.join("processed", "aggregated.csv")
    got = open(os.path.join(e.root, name)).read()
    assert len(agg) > 0 and got == open(os.path.join(copy, name)).read()
    jckpt.save_dataframe(os.path.join(copy, "options.csv"),
                         pd.DataFrame(e.opts))
    assert open(os.path.join(e.root, "in", "options.csv")).read() == \
        open(os.path.join(copy, "options.csv")).read()


_PUTS = ("BINPUT", "LONG_BINPUT", "PUT")
_GETS = ("BINGET", "LONG_BINGET", "GET")


def pickle_modules(path) -> set:
    """The modules a pickle's globals name (pickletools; the memo followed
    for STACK_GLOBAL's module and name)."""
    mods, pushed, memo = set(), [None, None], {}
    with open(path, "rb") as f:
        for op, arg, _ in pickletools.genops(f.read()):
            if op.name == "MEMOIZE":
                memo[len(memo)] = pushed[-1]
                continue
            if op.name in _PUTS:
                memo[arg] = pushed[-1]
                continue
            if op.name == "GLOBAL":
                mods.add(arg.split(" ")[0])
            if op.name == "STACK_GLOBAL":
                mods.add(pushed[-2])
            pushed.append(arg if "UNICODE" in op.name else
                          memo.get(arg) if op.name in _GETS else None)
    return mods


def test_pickles_name_no_jax_module(svm_experiment):
    """Every pickle of the experiment (data, inits, options, fit states,
    traces; the KSD state of an interrupted run) names numpy, builtins and
    the port's modules only."""
    e = svm_experiment
    found = {}
    for d, _, files in os.walk(e.root):
        for f in files:
            if f.endswith(".p"):
                found[f] = pickle_modules(os.path.join(d, f))
    names = set(found)
    assert {"data.p", "options.p", "init_prior.p", "init_truth.p",
            "0_parameters.p", "fit_0_state.p", "fit_2_multichain_state.p",
            "ksd_1_state.p"} <= names, names
    for f, mods in found.items():
        bad = {m for m in mods if m is None or m.split(".")[0] in (
            "jax", "jaxlib", "flax", "torch", "sgmcmc_tpu")}
        assert not bad, (f, mods)
        assert mods & {"sgmcmc_tpu_torch.models.svm", "numpy"} or \
            f == "options.p", (f, mods)


def test_ksd_resumes_to_the_uninterrupted_result(svm_experiment):
    """A KSD run interrupted after its checkpoint at 20 scores resumes
    there and gives the uninterrupted run's KSD exactly; a block of
    samples is scored by one call and never crosses a checkpoint."""
    e = svm_experiment
    state = os.path.join(e.root, "scratch", "ksd_1_state.p")
    assert e.calls == [20, 10]
    assert ckpt.load_pickle(state)["cur_index"] == 20
    shutil.copy(state, state + ".kept")
    assert driver.do_eval_ksd(e.passes, e.opts[1]) == e.full
    assert not os.path.exists(state)
    shutil.move(state + ".kept", state)


def test_ksd_block_scores_agree_in_law_with_the_loop():
    """The KSD's scores of a block of samples, the chains of one call,
    against one call a sample: 64 scores at the same parameters each way,
    every component's mean within |z| < 5."""
    ys = svm.generate_data(torch.Generator().manual_seed(4),
                           svm.from_scalars(0.9, 0.5, 1.0), 50)[0]
    smp = samplers.SVMSampler(observations=ys, device="cpu", seed=5)
    p = ckpt.tree_to_numpy(svm.from_scalars(0.85, 0.6, 1.1))
    kw = dict(N=32, subsequence_length=-1, is_scaled=False)
    block = flat(driver.score_block(smp, [p] * 64, **kw))
    loop = np.concatenate([flat(driver.score_block(smp, [p], **kw))
                           for _ in range(64)])
    se = np.sqrt((block.var(0) + loop.var(0)) / 64)
    z = np.abs(block.mean(0) - loop.mean(0)) / se
    assert block.shape == loop.shape == (64, 3) and z.max() < 5, z


@pytest.mark.parametrize("iter_type", ["SGLD", "ADAGRAD"])
@pytest.mark.parametrize("num_chains", [1, 3])
def test_fit_resumes_to_the_uninterrupted_fit(tmp_path, num_chains,
                                              iter_type):
    """A fit stopped at its checkpoint and resumed equals one
    uninterrupted fit bitwise (the state carries the generator's and
    ADAGRAD's accumulator)."""
    traces = {}
    for label, stops in (("once", [4]), ("resumed", [2, 4])):
        args = args_for(tmp_path / label)
        args.num_chains = num_chains
        opts = driver.do_setup(args, small_grid("svm", ["POYIADJIS_N_1000"]))
        o = dict(opts[2], checkpoint_num_iters=2, iter_type=iter_type)
        for stop in stops:
            driver.do_fit(args, dict(o, max_num_iters=stop))
        tr = ckpt.load_trace(str(tmp_path / label / "out" / "fit"
                                 / "2_parameters.p"))
        traces[label] = flat(tr["parameters_list"])
    assert traces["once"].shape == (5, 3)
    np.testing.assert_array_equal(traces["resumed"], traces["once"])


def test_lgssm_pipeline_and_kstest(tmp_path):
    args = args_for(tmp_path, "lgssm")
    opts = driver.do_setup(args, small_grid(
        "lgssm", ["GIBBS", "KF", "POYIADJIS_N_1000"]))
    for o in opts:
        driver.do_fit(args, o)
    rows = [r for o in opts for r in driver.do_eval_ks_test(args, o, opts)]
    assert len(rows) == 3 * len(opts)
    assert all(0 <= r["value"] <= 1 and 0 <= r["pvalue"] <= 1 for r in rows)
    agg = driver.do_process_out(args, opts)
    assert "pvalue" in agg.columns and len(agg) > len(rows)


def test_slds_driver_setup_fit_eval(tmp_path):
    """The SLDS's grid at a tiny T: setup (the data carry z), GIBBS and
    SGLD_COMPLETE for 2 iterations from both inits, eval (the noisy
    log-joint rows; the SLDS has no predictive log-likelihood), and
    --num_chains 2 raising for both (Gibbs is no gradient iter type; the
    SLDS sampler has no fit_scan)."""
    args = args_for(tmp_path, "slds")
    grid = [dict(o, max_num_iters=2, steps_per_iteration=1,
                 subsequence_length=8, buffer_length=2)
            if o["name"] == "SGLD_COMPLETE" else dict(o, max_num_iters=2)
            for o in driver.default_sampler_grid("slds")]
    opts = driver.do_setup(args, grid)
    assert sorted({o["name"] for o in opts}) == ["GIBBS", "SGLD_COMPLETE"]
    data = ckpt.load_pickle(str(tmp_path / "in" / "data.p"))
    assert data["latent_z"].shape == (args.T,)
    assert data["test_latent_z"].shape == (args.T_test,)
    assert data["latent_vars"].shape == (args.T, 1)
    for o in opts:
        smp = driver.do_fit(args, o)
        assert isinstance(smp, samplers.SLDSSampler)
        assert all(bool(torch.isfinite(getattr(smp.parameters, f)).all())
                   for f in ("logit_pi", "A", "LQinv_vec", "LRinv_vec"))
    o = next(o for o in opts if o["name"] == "SGLD_COMPLETE")
    args.num_to_eval = 2
    driver.do_eval(args, o, "half_avg_test")
    rows = tables.read_csv(str(tmp_path / "out" / "eval" / (
        f"{o['experiment_id']}_half_avg_test_metrics.csv"))).rows
    metrics = {r["metric"] for r in rows}
    assert {"logjoint", "loglikelihood", "A_logmse"} <= metrics
    assert not any("pred_loglikelihood" in m for m in metrics)
    args.num_chains = 2
    for o in opts:
        with pytest.raises(ValueError, match="Gibbs|fit_scan"):
            driver.do_fit(args, o)
    # the SCIR step the HMM grid runs: the projection inside the step
    assert driver._iter_funcs("SCIR", dict(epsilon=0.2), dict(
        subsequence_length=16)) == jd._iter_funcs(
            "SCIR", dict(epsilon=0.2), dict(subsequence_length=16)) == (
        ["sample_sgld_scir"], [dict(epsilon=0.2, subsequence_length=16)])


@pytest.mark.parametrize("flag", [["--num_particle_devices", "2"],
                                  ["--island_fused"]])
def test_mesh_flags_raise(tmp_path, flag):
    args = args_for(tmp_path, "svm", *flag)
    opts = driver.do_setup(args, small_grid("svm", ["POYIADJIS_N_1000"]))
    with pytest.raises(NotImplementedError, match="slice 14"):
        driver.do_fit(args, opts[0])


def test_multichain_rng_follows_the_device(tmp_path, monkeypatch):
    """The fused window's normals: in-kernel on a CUDA device, the host's
    on the CPU (the JAX driver asks the backend's name, ``driver.py:417``)."""
    assert driver._sampler_rng("cuda") == "kernel"
    assert driver._sampler_rng(torch.device("cpu")) == "host"
    seen = []
    real = samplers.Sampler.fit_scan

    def spy(self, *a, **kw):
        seen.append(kw.get("rng"))
        return real(self, *a, **kw)
    monkeypatch.setattr(samplers.Sampler, "fit_scan", spy)
    args = args_for(tmp_path)
    args.num_chains = 2
    opts = driver.do_setup(args, small_grid("svm", ["NEMETH_1000"]))
    driver.do_fit(args, opts[0])
    assert seen and set(seen) == {"host"}


def test_driver_runs_without_pandas_matplotlib_or_jax(tmp_path):
    """The card's machine has neither pandas nor matplotlib: setup, fit,
    eval, KSD and process_out run in a process where importing them (or
    JAX) fails, and --make_plots says it needs them."""
    import subprocess
    import sys
    code = f"""
import sys
for m in ("pandas", "matplotlib", "jax", "sgmcmc_tpu"):
    sys.modules[m] = None
import torch
torch.set_num_threads(1)
from sgmcmc_tpu_torch.experiments import driver
common = ["--path", {str(tmp_path)!r}, "--device", "cpu", "--experiment_id",
          "0"]
args = driver.build_parser().parse_args(["--T", "40", "--T_test", "30"]
                                        + common)
driver.do_setup(args, [dict(o, max_num_iters=2, steps_per_iteration=1, N=16,
                            subsequence_length=8, buffer_length=2)
                       for o in driver.default_sampler_grid("svm")[:1]])
driver.main(common + ["--fit", "--eval", "test", "--eval_N", "16",
                      "--num_to_eval", "1", "--eval_predictive", "1",
                      "--trace_eval", "ksd", "--ksd_N", "16",
                      "--process_out"])
try:
    driver.main(common + ["--make_plots"])
except SystemExit as e:
    assert "needs pandas and matplotlib" in str(e), e
else:
    raise AssertionError("--make_plots ran without pandas")
print("ok")
"""
    root = os.path.join(os.path.dirname(__file__), "..")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root,
                         env=dict(os.environ, PYTHONPATH=root))
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), \
        res.stderr[-2000:]
    assert os.path.exists(tmp_path / "processed" / "aggregated.csv")
