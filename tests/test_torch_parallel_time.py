"""The port's parallel-in-time messages (``ops/scan.py``,
``ops/kalman_parallel.py``, the ``parallel_*`` functions of ``ops/hmm.py``
and of the LGSSM, GaussHMM and ARPHMM) against the JAX package.

Both sides get the same numpy inputs, on the shapes of
tests/test_kalman_parallel.py, (n, m, T) in {(1, 1, 64), (2, 2, 50), (3,
1, 37)}, the middle one with three chains of distinct parameters.  In
float64: the filtered, predicted and smoothed moments are held to JAX's
associative scans and to the port's sequential filter and smoother at
rtol 1e-8, atol 1e-10; the marginal log-likelihood at rtol 1e-9; the
score (autograd through the scan) to the port's analytic gradient at
every shape and to JAX's ``jax.grad`` at (2, 2, 50) (the shape of the JAX
package's own gradient test; JAX's compile of the scan's gradient takes
longer than the rest of a shape), at rtol 1e-8 (atol 1e-10); the
discrete-state messages
(K=3, T=41, two chains' transition matrices) and the GaussHMM / ARPHMM
wrappers at rtol 1e-9.  Named exception: the port's scan is Hillis-Steele
(every element combined with the one 2^r places back, round r), JAX's
``lax.associative_scan`` a work-efficient tree; the two differ in rounding
only, which the tolerances above bound.
"""
import functools
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from sgmcmc_tpu.models import arphmm as ja
from sgmcmc_tpu.models import gauss_hmm as jg
from sgmcmc_tpu.models import lgssm as jl
from sgmcmc_tpu.ops import hmm as jh
from sgmcmc_tpu.ops import kalman_parallel as jkp
from sgmcmc_tpu_torch.models import arphmm, gauss_hmm, lgssm
from sgmcmc_tpu_torch.ops import hmm, kalman, kalman_parallel
from sgmcmc_tpu_torch.ops.scan import associative_scan

torch.set_num_threads(1)

# The JAX side is compiled without XLA's backend optimisations: it runs
# once per shape, and the compile is most of its time.
OPTIONS = {"xla_backend_optimization_level": 0}
jit = functools.partial(jax.jit, compiler_options=OPTIONS)
MOMENTS = dict(rtol=1e-8, atol=1e-10)
LOGLIK = dict(rtol=1e-9, atol=0.0)
SHAPES = [(1, 1, 64, 1), (2, 2, 50, 3), (3, 1, 37, 1)]
GRAD_SHAPE = SHAPES[1]
FIELDS = ("A", "C", "LQinv_vec", "LRinv_vec")


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


def t(a):
    return torch.from_numpy(np.array(a, np.float64))


def compile_all(jobs):
    """The executables of ``jobs`` ((function, example arguments) pairs):
    each traced here and compiled on a thread of its own while the next
    one traces (XLA's compiler runs outside the interpreter's lock)."""
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(jax.jit(fn).lower(*args).compile, OPTIONS)
                   for fn, args in jobs]
        return [f.result() for f in futures]


def jax_params(n, m, seed):
    """tests/test_kalman_parallel.py's parameters."""
    rng = np.random.default_rng(seed)
    A = 0.6 * np.linalg.qr(rng.normal(size=(n, n)))[0]
    C = rng.normal(size=(m, n)) / np.sqrt(n)
    Q = np.eye(n) * 0.5 + 0.1 * np.ones((n, n))
    R = np.eye(m) * 0.8
    return jl.from_matrices(A, C, Q, R)


def jax_side(jp, ys):
    """JAX's parallel moments and log-likelihood of one chain.  The
    smoother and the log-likelihood call the module's
    ``parallel_filtered_moments`` on the same inputs; while this traces,
    each call after the first returns the first call's result, so the
    filter's scan is traced and compiled once (tracing and compiling the
    scans is most of this file's time)."""
    fwd = jl.default_forward_message(jp)
    fm = jkp.parallel_filtered_moments(ys, jp.A, jp.C, jp.LQinv, jp.LRinv,
                                       fwd)
    with mock.patch.object(jkp, "parallel_filtered_moments",
                           lambda *_: fm):
        return (fm, jkp.parallel_smoothed_moments(ys, jp.A, jp.C, jp.LQinv,
                                                  jp.LRinv, fwd),
                jl.parallel_marginal_loglikelihood(jp, ys))


def data(n, m, T, C):
    """(JAX parameters of each chain, observations [T, m]): chain c has
    tests/test_kalman_parallel.py's parameters of seed n + m + c, the
    observations are simulated from chain 0's."""
    jps = [jax_params(n, m, n + m + c) for c in range(C)]
    rng = np.random.default_rng(T)
    A, Cm = np.asarray(jps[0].A), np.asarray(jps[0].C)
    x, ys = np.zeros(n), []
    for _ in range(T):
        x = A @ x + rng.normal(size=n) * 0.7
        ys.append(Cm @ x + rng.normal(size=m) * 0.9)
    return jps, np.array(ys)


def stack(outs):
    return jax.tree_util.tree_map(lambda *v: np.stack(v), *outs)


@functools.lru_cache(maxsize=None)
def references():
    """{shape: (port parameters [C], observations, JAX's moments and
    log-likelihood stacked over the chains)} and JAX's score of each chain
    at ``GRAD_SHAPE``, every JAX function compiled at once."""
    cases = {shape: data(*shape) for shape in SHAPES}
    jps_g, ys_g = cases[GRAD_SHAPE]
    exes = compile_all(
        [(jax_side, (cases[shape][0][0], cases[shape][1]))
         for shape in SHAPES]
        + [(jl.parallel_gradient_marginal_loglikelihood, (jps_g[0], ys_g))])
    out = {}
    for exe, shape in zip(exes, SHAPES):
        jps, ys = cases[shape]
        out[shape] = (lgssm.params_from_jax(stack(jps), dtype=torch.float64),
                      ys, stack([exe(jp, ys) for jp in jps]))
    return out, stack([exes[-1](jp, ys_g) for jp in jps_g])


def case(n, m, T, C):
    return references()[0][(n, m, T, C)]


@pytest.mark.parametrize("n,m,T,C", SHAPES)
def test_parallel_filter_matches_jax_and_sequential(n, m, T, C):
    p, ys, (want, _, _) = case(n, m, T, C)
    y = t(ys)
    fm = kalman_parallel.parallel_filtered_moments(
        y, p.A, p.C, p.LQinv, p.LRinv, lgssm.default_forward_message(p))
    for got, w in zip(fm, want):
        close(got, w, **MOMENTS)
    mean_seq, cov_seq = kalman.filtered_moments(
        y, p.A, p.C, p.LQinv, p.LRinv, lgssm.default_forward_message(p))
    mean, cov = lgssm.parallel_latent_var_distr(p, y, smoothed=False)
    close(mean, mean_seq.numpy(), **MOMENTS)
    close(cov, cov_seq.numpy(), **MOMENTS)


@pytest.mark.parametrize("n,m,T,C", SHAPES)
def test_parallel_smoother_matches_jax_and_sequential(n, m, T, C):
    """The reverse scan's flipped operands: a smoother that combined them
    in time order would still give plausible moments; the sequential
    smoother and JAX's tell them apart."""
    p, ys, (_, (want_mean, want_cov), _) = case(n, m, T, C)
    y = t(ys)
    mean, cov = lgssm.parallel_latent_var_distr(p, y)
    close(mean, want_mean, **MOMENTS)
    close(cov, want_cov, **MOMENTS)
    mean_seq, cov_seq = lgssm.latent_var_distr(p, y)
    close(mean, mean_seq.numpy(), **MOMENTS)
    close(cov, cov_seq.numpy(), **MOMENTS)


@pytest.mark.parametrize("n,m,T,C", SHAPES)
def test_parallel_loglikelihood_matches_jax_and_sequential(n, m, T, C):
    p, ys, (_, _, want) = case(n, m, T, C)
    got = lgssm.parallel_marginal_loglikelihood(p, t(ys))
    assert got.shape == (C,) and got.dtype == torch.float64
    close(got, want, **LOGLIK)
    close(got, lgssm.marginal_loglikelihood(p, t(ys)).numpy(), **LOGLIK)
    # float32 parameters and observations are computed in float64
    got32 = lgssm.parallel_marginal_loglikelihood(
        lgssm.params_from_jax(jax.tree_util.tree_map(
            np.asarray, jax_params(n, m, n + m)), dtype=torch.float32),
        t(ys).float())
    assert got32.dtype == torch.float64


@pytest.mark.parametrize("n,m,T,C", SHAPES)
def test_parallel_gradient_matches_jax_and_analytic(n, m, T, C):
    p, ys, _ = case(n, m, T, C)
    got = lgssm.parallel_gradient_marginal_loglikelihood(p, t(ys))
    analytic = lgssm.gradient_marginal_loglikelihood(p, t(ys))
    want = references()[1] if (n, m, T, C) == GRAD_SHAPE else None
    for f in FIELDS:
        g = getattr(got, f)
        assert not g.requires_grad and g.shape == getattr(p, f).shape
        close(g, getattr(analytic, f).numpy(), err_msg=f, **MOMENTS)
        if want is not None:
            close(g, getattr(want, f), err_msg=f, **MOMENTS)


def test_associative_scan_prefixes_and_suffixes():
    """Inclusive prefixes in order, the suffixes of ``reverse=True`` with
    the later operand first (a non-commutative product of 2 x 2 matrices
    at lengths that are and are not powers of two)."""
    rng = np.random.default_rng(0)
    for T in (1, 7, 8, 13):
        M = t(rng.normal(size=(2, T, 2, 2)))

        def product(a, b):
            return (a[0] @ b[0],)
        (pre,) = associative_scan(product, (M,), 1)
        (suf,) = associative_scan(product, (M,), 1, reverse=True)
        for s in range(T):
            want_pre = np.linalg.multi_dot([np.eye(2)] + [
                M[:, i].numpy()[0] for i in range(s + 1)] + [np.eye(2)])
            close(pre[0, s], want_pre, rtol=1e-10, atol=1e-9)
            want_suf = np.eye(2)
            for i in range(T - 1, s - 1, -1):
                want_suf = want_suf @ M[1, i].numpy()
            close(suf[1, s], want_suf, rtol=1e-10, atol=1e-9)


@jit
def jax_hmm(logP, Pi):
    K = Pi.shape[-1]
    f0, b0 = jh.default_forward_message(K), jh.default_backward_message(K)
    par = jh.parallel_forward_messages(logP, Pi, f0)
    return (par.prob, par.log_constant,
            jh.parallel_marginal_loglikelihood(logP, Pi, f0, b0))


def test_parallel_hmm_messages_match_jax_and_sequential():
    """K=3, T=41 (tests/test_kalman_parallel.py's HMM case), two chains'
    transition matrices on one logP."""
    rng = np.random.default_rng(4)
    K, T = 3, 41
    Pis = np.stack([rng.dirichlet(np.ones(K) * 2, size=K) for _ in range(2)])
    logP = rng.normal(size=(T, K)) * 2.0
    want = [np.stack(v) for v in zip(*[jax_hmm(logP, Pi) for Pi in Pis])]
    f0, b0 = hmm.default_forward_message(K), hmm.default_backward_message(K)
    par = hmm.parallel_forward_messages(t(logP), t(Pis), f0)
    ll = hmm.parallel_marginal_loglikelihood(t(logP), t(Pis), f0, b0)
    for got, w in zip((par.prob, par.log_constant, ll), want):
        close(got, w, rtol=1e-9, atol=1e-12)
    seq = hmm.forward_messages(t(logP), t(Pis), f0)
    close(par.prob, seq.prob.numpy(), rtol=1e-9, atol=1e-12)
    close(par.log_constant, seq.log_constant.numpy(), **LOGLIK)
    close(ll, hmm.marginal_loglikelihood(t(logP), t(Pis), f0, b0).numpy(),
          **LOGLIK)


@pytest.mark.parametrize("name", ["gauss_hmm", "arphmm"])
def test_parallel_hmm_wrappers_match_jax(name):
    rng = np.random.default_rng(5)
    K, T = 3, 41
    pi = rng.dirichlet(np.ones(K) * 3, size=K)
    R = np.stack([np.eye(1) * (0.4 + 0.2 * k) for k in range(K)])
    y = rng.normal(size=(T, 1)) * 1.5
    if name == "gauss_hmm":
        jp = jg.from_values(pi, rng.normal(size=(K, 1)), R)
        jfn, mod, ys = jg.parallel_marginal_loglikelihood, gauss_hmm, y
    else:
        jp = ja.from_values(pi, 0.6 * rng.normal(size=(K, 1, 1)), R)
        jfn, mod = ja.parallel_marginal_loglikelihood, arphmm
        ys = np.asarray(ja.stack_y(y, 1))
    want = jit(jfn)(jp, ys)
    p = mod.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    got = mod.parallel_marginal_loglikelihood(p, t(ys))
    close(got, [want], **LOGLIK)
    close(got, mod.marginal_loglikelihood(p, t(ys)).numpy(), **LOGLIK)
