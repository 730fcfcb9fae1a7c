"""The port's exact-message kinds of the LGSSM against the JAX package: the
Kalman moments, lagged moments and predictive log-likelihood, FFBS, the
windowed marginal and complete-data gradients, the Gibbs sweep, one SGLD
step of each kind and the multi-sequence marginal score; then the port's
own identities (the windowed score's unbiasedness, FFBS's invariance to
invalid rows) and the sampler surface on the CPU.

The two frameworks cannot share random streams, so every random draw of
the JAX side is rebuilt from its keys (the splits of
``sgmcmc_tpu/ops/kalman.py:ffbs_sample``, ``models/lgssm.py``'s
``windowed_complete_gradient``, ``gibbs_step``, ``_conjugate_mniw_sample``
and ``utils/distributions.py:sample_wishart``) and fed to the port.
Deterministic and shared-draw functions are held in float64 at rtol
1e-10; the sampler paths, which compute in float32, at rtol 1e-4 (the
step tests against float64 references that they share with the windowed
tests, so that JAX compiles each once).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgmcmc_tpu.inference import sgmcmc as jsg
from sgmcmc_tpu.models import lgssm as jl
from sgmcmc_tpu.ops import kalman as jk
from sgmcmc_tpu_torch.inference import samplers, sgmcmc
from sgmcmc_tpu_torch.models import lgssm, registry
from sgmcmc_tpu_torch.ops import kalman

torch.set_num_threads(1)

# The JAX side is compiled without XLA's backend optimisations: it is run
# once, and the compile is most of its time.
jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
FIELDS = ("A", "C", "LQinv_vec", "LRinv_vec")
# (A, C, Q, R) of two chains
CHAINS = [(0.8, 1.2, 0.5, 1.3), (-0.4, 0.7, 1.5, 0.6)]
F64 = dict(rtol=1e-10, atol=1e-10, strict=True)
F32 = dict(rtol=1e-4, atol=1e-5, strict=True)
f64 = jnp.float64


def jax_stacked(dtype=np.float64):
    ps = [jl.from_matrices(A=[[a]], C=[[c]], Q=[[q]], R=[[r]])
          for a, c, q, r in CHAINS]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs).astype(dtype),
                                  *ps)


def port_params(jp, dtype=torch.float64):
    return lgssm.params_from_jax(jp, dtype)


def assert_params(got, want, **tol):
    for f in FIELDS:
        np.testing.assert_allclose(
            getattr(got, f).detach().double().numpy().reshape(-1),
            np.asarray(getattr(want, f), np.float64).reshape(-1), **tol,
            err_msg=f)


def ffbs_normals(key, T, n, dtype=f64):
    """The normals of JAX's one-sample FFBS from ``key``, in the port's
    row order: row T-1 draws the last row, row t the step x_t | x_{t+1}."""
    key_last, key_rest = jax.random.split(key)
    z_last = jax.random.normal(key_last, (n,), dtype)
    z = jax.vmap(lambda k: jax.random.normal(k, (n,), dtype))(
        jax.random.split(key_rest, T - 1))
    return jnp.concatenate([z[::-1], z_last[None]])


def complete_draws(key, W, K, dtype=f64):
    """(FFBS normals [K, W, 1], completion normals [K, 1]) of JAX's
    windowed_complete_gradient from ``key``."""
    def one(k):
        k_ffbs, k_prev = jax.random.split(k)
        return (ffbs_normals(k_ffbs, W, 1, dtype),
                jax.random.normal(k_prev, (1,), dtype))
    return jax.vmap(one)(jax.random.split(key, K))


def rolled_window(ys, start, S, B):
    """JAX's marginal-score window: (window, valid, weights)."""
    T = ys.shape[0]
    idx = start - B + np.arange(S + 2 * B)
    valid = ((idx >= 0) & (idx < T)).astype(ys.dtype)
    t = start + np.arange(S)
    n = np.minimum(np.minimum(t + 1, S), np.minimum(T - S + 1, T - t))
    return (ys[np.clip(idx, 0, T - 1)], valid,
            ((T - S + 1) / n).astype(ys.dtype))


def kalman_case(n, T=12, seed=3):
    rng = np.random.default_rng(seed + n)
    ys = rng.standard_normal((T, 1))
    if n == 1:
        return ys, np.array([[0.8]]), np.array([[1.2]]), \
            np.array([[1.4]]), np.array([[0.9]])
    A = np.array([[0.7, 0.2], [-0.1, 0.5]])
    C = np.array([[1.0, 0.4]])
    LQinv = np.array([[1.3, 0.0], [0.3, 0.8]])
    return ys, A, C, LQinv, np.array([[1.1]])


def kalman_extras(k, ys, A, C, LQinv, LRinv, w, valid):
    """The last messages (with weights and a masked step), filtered and
    lagged moments and predictive log-likelihoods of one kalman module,
    JAX's or the port's, at n = 1; at n = 2 the fixed-lag moments and the
    lag-0 predictive log-likelihood (through the filtered moments)."""
    n = A.shape[-1]
    f, b = k.init_forward_message(n), k.init_backward_message(n)
    args = (ys, A, C, LQinv, LRinv)
    if n == 2:
        return [*k.lagged_moments(*args, f, b, 2),
                k.predictive_loglikelihood(*args, f, 0)]
    return [*k.forward_message(*args, f, w, valid),
            *k.backward_message(*args, b, w, valid),
            *k.filtered_moments(*args, f),
            *k.lagged_moments(*args, f, b, -2),
            *k.lagged_moments(*args, f, b, 3),
            k.predictive_loglikelihood(*args, f, 2)]


@pytest.mark.parametrize("n", [1, 2])
def test_kalman_moments_match_jax(n):
    """The last messages, filtered and lagged moments (lag <= 0 and
    fixed-lag) and predictive log-likelihoods.  (The smoothed moments are
    held through latent_var_sample below, the fused
    log-likelihood-and-gradient pass through the windowed gradients, the
    message stacks and the gradient in tests/test_torch_lgssm.py.)"""
    ys, A, C, LQinv, LRinv = kalman_case(n)
    T = ys.shape[0]
    w = np.linspace(0.5, 1.5, T)
    valid = np.ones(T)
    valid[4] = 0.0
    arrays = (ys, A, C, LQinv, LRinv, w, valid)

    want = jit(lambda *a: kalman_extras(jk, *a))(
        *[jnp.asarray(a) for a in arrays])
    got = kalman_extras(kalman, *[torch.from_numpy(a) for a in arrays])
    assert len(got) == len(want) == (13 if n == 1 else 3)
    for i, (gv, wv) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **F64,
                                   err_msg=str(i))


@pytest.mark.parametrize("n,gaps,K", [(1, True, 2), (2, False, 1)])
def test_ffbs_matches_jax_on_shared_draws(n, gaps, K):
    """FFBS (two samples with invalid rows at the start, inside and at the
    end; one sample at n = 2 without them) on the normals JAX draws from
    its key.  The complete-gradient and Gibbs tests below run it too."""
    ys, A, C, LQinv, LRinv = kalman_case(n, T=10)
    T = ys.shape[0]
    valid = np.ones(T)
    if gaps:
        valid[[0, 4, 5, 9]] = 0.0
    key = jax.random.PRNGKey(7)

    def jax_side(key, ys, A, C, LQinv, LRinv, valid):
        f = jk.init_forward_message(n)
        x = jk.ffbs_sample(key, ys, A, C, LQinv, LRinv, f, K,
                           valid=valid if gaps else None)
        keys = [key] if K == 1 else jax.random.split(key, K)
        return x, jnp.stack([ffbs_normals(k, T, n) for k in keys])
    want, z = jit(jax_side)(key, *[jnp.asarray(a) for a in
                                      (ys, A, C, LQinv, LRinv, valid)])
    z = torch.from_numpy(np.array(z))
    t = [torch.from_numpy(a) for a in (ys, A, C, LQinv, LRinv)]
    got = kalman.ffbs_sample(*t, kalman.init_forward_message(n), K,
                             valid=torch.from_numpy(valid) if gaps else None,
                             normals=z[0] if K == 1 else z)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)


def test_ffbs_is_invariant_to_invalid_rows():
    """Rows marked invalid are transparent: their observations change
    nothing on the valid rows, bitwise, and each copies a neighbouring
    valid draw."""
    ys, A, C, LQinv, LRinv = [torch.from_numpy(a) for a in kalman_case(1,
                                                                       T=12)]
    valid = torch.ones(12, dtype=torch.float64)
    valid[[0, 1, 6, 7, 11]] = 0.0
    z = torch.randn((3, 12, 1), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    f = kalman.init_forward_message(1)
    x1 = kalman.ffbs_sample(ys, A, C, LQinv, LRinv, f, 3, valid, z)
    ys2 = ys.clone()
    ys2[valid == 0] = 1e3
    x2 = kalman.ffbs_sample(ys2, A, C, LQinv, LRinv, f, 3, valid, z)
    assert torch.equal(x1, x2)
    assert torch.equal(x1[:, 6], x1[:, 8]) and torch.equal(x1[:, 7],
                                                           x1[:, 8])
    assert torch.equal(x1[:, 11], x1[:, 10])
    assert torch.equal(x1[:, 0], x1[:, 2])


# One window layout for the windowed-gradient tests and the step tests
# (T=20, S=6, B=3; 4 rows: start 0 with its buffer rows invalid, the last
# start T-S, and two interior ones), so that each kind's JAX reference is
# compiled once: in float64, for the port's float64 functions and for its
# float32 sampler path alike.
T_W, S_W, B_W, K_W = 20, 6, 3, 2
STARTS = np.array([0, 8, 14, 5])


def windows_case(ys=None):
    """(observations, windows, valid, weights) of ``STARTS``."""
    if ys is None:
        ys = 1.5 * np.random.default_rng(1).standard_normal((T_W, 1))
    rows = [rolled_window(ys, s, S_W, B_W) for s in STARTS]
    return (ys, *[np.stack(x) for x in zip(*rows)])


@functools.lru_cache(maxsize=None)
def jax_windowed(kind):
    """The JAX package's windowed gradient of ``kind`` over rows, jitted
    once for every test here; the complete kind also returns the normals
    it draws (K_W draws a row)."""
    def row(p, w, v, wt, k):
        if kind == "marginal":
            return jl.windowed_marginal_gradient(p, w, v, wt, B_W, S_W)
        return (jl.windowed_complete_gradient(p, w, v, wt, B_W, S_W, k,
                                              K_W),
                complete_draws(k, S_W + 2 * B_W, K_W))
    return jit(jax.vmap(row))


def jax_rows(win, valid, weights, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), len(STARTS))
    return [jnp.asarray(a) for a in (win, valid, weights)] + [keys]


def test_windowed_marginal_gradient_matches_jax():
    """Edge windows (start 0, start T-S) and interior ones, with the
    buffers' boundary messages; one chain's parameters per row, cycling
    through the two chains."""
    _, win, valid, weights = windows_case()
    jrows = jax.tree_util.tree_map(lambda x: x[np.arange(4) % 2],
                                   jax_stacked())
    want_g, want_ll = jax_windowed("marginal")(
        jrows, *jax_rows(win, valid, weights, 0))
    t = torch.from_numpy
    g, ll = lgssm.windowed_marginal_gradient(port_params(jrows), t(win),
                                             t(valid), t(weights), B_W, S_W)
    assert_params(g, want_g, **F64)
    np.testing.assert_allclose(ll.numpy(), np.asarray(want_ll), **F64)


def test_windowed_complete_gradient_matches_jax():
    """Two FFBS draws a row on JAX's normals: the completion before the
    subsequence at start 0 (its buffer rows invalid), the buffer row
    elsewhere; then one draw a row, which equals two equal draws."""
    _, win, valid, weights = windows_case()
    jrows = jax.tree_util.tree_map(lambda x: x[np.arange(4) % 2],
                                   jax_stacked())
    (want_g, want_ll), (z, zc) = jax_windowed("complete")(
        jrows, *jax_rows(win, valid, weights, 3))
    t = torch.from_numpy
    args = (port_params(jrows), t(win), t(valid), t(weights), B_W, S_W)
    z, zc = t(np.array(z)), t(np.array(zc))
    g, ll = lgssm.windowed_complete_gradient(*args, num_samples=K_W,
                                             normals=z, completion=zc)
    assert_params(g, want_g, **F64)
    np.testing.assert_allclose(ll.numpy(), np.asarray(want_ll), **F64)
    g1, ll1 = lgssm.windowed_complete_gradient(
        *args, normals=z[:, :1], completion=zc[:, :1])
    g2, ll2 = lgssm.windowed_complete_gradient(
        *args, num_samples=2, normals=z[:, [0, 0]],
        completion=zc[:, [0, 0]])
    assert ll1.shape == (4,)
    assert_params(g1, g2, **F64)
    np.testing.assert_allclose(ll1.numpy(), ll2.numpy(), **F64)


def test_gibbs_step_matches_jax_on_shared_draws():
    """One blocked-Gibbs sweep of two chains (FFBS, then the conjugate
    (Q, A) and, with C fixed to 1, R updates) on the FFBS normals, the
    Wishart chi-squares and the matrix-normal normal JAX draws; then the
    free (R, C) block (``fix_C_eye=False``) on a given latent path."""
    T = 12
    rng = np.random.default_rng(2)
    ys, x_given = 1.5 * rng.standard_normal((2, T, 1))
    jprior = jl.default_prior(1, 1)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)

    def keys_of(key):
        """(FFBS key, the Wishart keys of Q, R and the free R, the
        matrix-normal keys of A and the free C) of one sweep's key."""
        k_x, k_p = jax.random.split(key)
        k1, k2 = jax.random.split(k_p)
        (k_v, k_m), (k_vc, k_mc) = (jax.random.split(k1),
                                    jax.random.split(k2))
        return k_x, jnp.stack([k_v, k2, k_vc]), jnp.stack([k_m, k_mc])

    def jax_side(k, p):
        # the free block under gibbs_step's parameter key: its (Q, A)
        # draws are gibbs_step's own
        k_p = jax.random.split(k)[1]
        k_x, k_wish, k_mn = keys_of(k)
        return (jl.gibbs_step(k, jprior, p, jnp.asarray(ys)),
                jl.gibbs_parameters_sample(k_p, jprior, jnp.asarray(ys),
                                           jnp.asarray(x_given),
                                           fix_C_eye=False),
                ffbs_normals(k_x, T, 1), k_wish,
                jax.vmap(lambda kk: jax.random.normal(kk, (1, 1), f64))(
                    k_mn))
    want, want_free, z, k_wish, mn = jit(jax.vmap(jax_side))(
        keys, jax_stacked())
    # the chi-squares of sample_wishart: 2 Gamma((df - i) / 2) from the
    # first half of each Wishart key; df of Q, R and the free R
    df = jnp.asarray([jprior.df_Qinv + T - 1, jprior.df_Rinv + T,
                      jprior.df_Rinv + T], f64)
    chi2 = jit(jax.vmap(jax.vmap(lambda kk, d: 2.0 * jax.random.gamma(
        jax.random.split(kk)[0], d / 2.0, (1,), f64)), in_axes=(0, None)))
    c2 = np.array(chi2(k_wish, df))                  # [2 chains, 3, 1]
    q_chi2, r_chi2, fr = c2[:, 0], c2[:, 1], c2[:, 2]
    a_z, fc = np.array(mn[:, 0]), np.array(mn[:, 1])
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    empty = torch.zeros((2, 0), dtype=torch.float64)
    prior = lgssm.default_prior(dtype=torch.float64)
    d = lgssm.GibbsDraws(t(z), t(q_chi2), empty, t(a_z), t(r_chi2), empty)
    got = lgssm.gibbs_step(None, prior, port_params(jax_stacked()), t(ys),
                           draws=d)
    assert_params(got, want, **F64)
    free = lgssm.gibbs_parameters_sample(
        None, prior, t(ys), t(x_given).expand(2, T, 1), fix_C_eye=False,
        draws=d._replace(r_chi2=t(fr), c_normals=t(fc)))
    assert_params(free, want_free, **F64)


def test_gibbs_step_float32_against_float64():
    """The sweep's float32 reductions over T=1000 (the scatter sums behind
    the conjugate updates, the FFBS and filter recursions) on the same
    draws as a float64 sweep: rtol 1e-3 (float32's 6e-8 over a
    1000-term sum, with room for the Wishart's inverse)."""
    T, C = 1000, 4
    gen = torch.Generator().manual_seed(5)
    truth = lgssm.from_scalars(0.9, 0.5, 1.0, dtype=torch.float64)
    ys, _ = lgssm.generate_data(gen, truth, T)
    z = torch.randn((C, T, 1), generator=gen, dtype=torch.float64)
    u = torch.rand((C, 4), generator=gen, dtype=torch.float64)
    empty = torch.zeros((C, 0), dtype=torch.float64)
    d = lgssm.GibbsDraws(z, T + 4 * u[:, :1], empty, u[:, 1:2, None] - 0.5,
                         T + 4 * u[:, 2:3], empty)
    params = lgssm.LGSSMParams(
        A=(0.5 + 0.4 * u[:, 3])[:, None, None], C=torch.ones((C, 1, 1),
                                                          dtype=torch.float64),
        LQinv_vec=torch.full((C, 1), 1.2, dtype=torch.float64),
        LRinv_vec=torch.full((C, 1), 0.9, dtype=torch.float64))
    out = {}
    for dt in (torch.float32, torch.float64):
        out[dt] = lgssm.gibbs_step(
            None, lgssm.default_prior(dtype=dt),
            lgssm.LGSSMParams(*[getattr(params, f).to(dt) for f in FIELDS]),
            ys.to(dt),
            draws=lgssm.GibbsDraws(*[x.to(dt) for x in d[:6]]))
    assert_params(out[torch.float32], out[torch.float64], rtol=1e-3,
                  atol=1e-5)


def jax_sgld_step(p, jprior, grad_ll, noise, eps, T):
    """The JAX package's SGLD step and projection around a score."""
    jg = jax.tree_util.tree_map(lambda a, b: (a + b) / T, grad_ll,
                                jl.grad_logprior(jprior, p))
    new = jax.tree_util.tree_map(
        lambda q, g, n: q + eps * g + np.sqrt(2 * eps) * (np.sqrt(1.0 / T)
                                                          * n), p, jg, noise)
    return jg, jl.project_parameters(new)


@pytest.mark.parametrize("kind", ["marginal", "complete"])
def test_sgld_step_of_each_kind_matches_jax(kind):
    """One float32 SGLD step of ``fit_scan``'s gradient on two chains with
    a minibatch of two windows (starts, FFBS and completion normals and
    the Langevin noise shared), against the same step composed from the
    JAX package's functions in float64 on the same float32 data; rtol
    1e-4, the port's float32 error."""
    M, eps = 2, 0.05
    ys32 = (1.5 * np.random.default_rng(6).standard_normal((T_W, 1))).astype(
        np.float32)
    _, win, valid, weights = windows_case(ys32.astype(np.float64))
    jp = jax_stacked(np.float32)
    jp64 = jax.tree_util.tree_map(lambda x: x.astype(f64), jp)
    jrows = jax.tree_util.tree_map(lambda x: jnp.repeat(x, M, 0), jp64)
    rng = np.random.default_rng(8)
    noise = {f: rng.standard_normal(s).astype(np.float32)
             for f, s in zip(FIELDS, [(2, 1, 1), (2, 1, 1), (2, 1), (2, 1)])}
    out = jax_windowed(kind)(jrows, *jax_rows(win, valid, weights, 9))
    (g_rows, ll_rows), (z, zc) = out if kind == "complete" else (out,
                                                                 (0, 0))
    g_mean = jax.tree_util.tree_map(
        lambda g: g.reshape((2, M) + g.shape[1:]).mean(1), g_rows)
    jgrad, jnew = jit(jax.vmap(lambda p, g, n: jax_sgld_step(
        p, jl.default_prior(1, 1), g, n, eps, T_W)))(
        jp64, g_mean, jl.LGSSMParams(**noise))

    s = samplers.LGSSMSampler(observations=ys32[:, 0], device="cpu")
    grad_fn = s._grad_fn(kind=kind, subsequence_length=S_W,
                         buffer_length=B_W, minibatch_size=M,
                         num_samples=K_W)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    draws = (sgmcmc.ExactDraws(t(STARTS)) if kind == "marginal" else
             sgmcmc.ExactDraws(t(STARTS), t(z), t(zc)))
    params = port_params(jp, torch.float32)
    grad, ll = grad_fn(None, params, s.observations, draws)
    new, ll2 = sgmcmc.sgld_step(None, params, s.observations, grad_fn, eps,
                                T_W, draws=draws, noise=lgssm.LGSSMParams(
                                    **{f: t(v) for f, v in noise.items()}))
    new = lgssm.project_parameters(new)
    assert_params(grad, jgrad, **F32)
    assert_params(new, jnew, **F32)
    np.testing.assert_allclose(ll.double().numpy(), np.asarray(
        ll_rows).reshape(2, M).mean(1), **F32)
    assert torch.equal(ll, ll2)


def test_seq_marginal_score_matches_jax():
    """The multi-sequence marginal score in float32 on JAX's sequence
    choice and starts (rebuilt from its key), with buffered windows clipped
    at each sequence's edges; rtol 1e-4.  (The full padded sequences are
    held to the float64 oracle below.)"""
    S, B, num_sequences = 4, 2, 2
    lengths = np.array([9, 14, 11])
    rng = np.random.default_rng(10)
    packed = np.zeros((3, 14, 1), np.float32)
    for i, L in enumerate(lengths):
        packed[i, :L] = rng.standard_normal((L, 1))
    cfg = jsg.PFScoreConfig(n_particles=1, subsequence_length=S,
                            buffer_length=B)
    jscore = jsg.make_seq_marginal_score_fn(jl.windowed_marginal_gradient,
                                            cfg, lengths, num_sequences)
    k = num_sequences

    def draws(key):
        key_seq, key_g = jax.random.split(key)
        idx = jax.random.permutation(key_seq, 3)[:k]
        u = jax.vmap(lambda kk: jax.random.uniform(
            jax.random.split(kk)[0], ()))(jax.random.split(key_g, k))
        T_i = jnp.asarray(lengths)[idx]
        return idx, jnp.floor(u * (T_i - S + 1)).astype(jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    jp = jax_stacked(np.float32)
    (want_g, want_ll), (seq, start) = jit(jax.vmap(
        lambda kk, p: (jscore(kk, p, jnp.asarray(packed)), draws(kk))))(
        keys, jp)
    score = sgmcmc.make_seq_marginal_score_fn(
        lgssm.windowed_marginal_gradient,
        sgmcmc.PFScoreConfig(subsequence_length=S, buffer_length=B),
        lengths, num_sequences)
    t = lambda a: torch.from_numpy(np.array(a, np.int64)).reshape(-1)  # noqa
    g, ll = score(None, port_params(jp, torch.float32),
                  torch.from_numpy(packed),
                  sgmcmc.ExactDraws(t(start), seq=t(seq)))
    assert_params(g, want_g, **F32)
    np.testing.assert_allclose(ll.numpy(), np.asarray(want_ll), **F32)


def test_seq_full_score_is_the_sum_of_exact_gradients():
    """With ``subsequence_length=-1`` the multi-sequence marginal score of
    every sequence is the sum of the per-sequence exact gradients and
    log-likelihoods (the float64 oracle, held to the JAX package in
    tests/test_torch_lgssm.py), whatever the padding holds; rtol 1e-10."""
    lengths = [9, 14, 11]
    rng = np.random.default_rng(17)
    seqs = [rng.standard_normal((L, 1)) for L in lengths]
    packed = torch.full((3, 14, 1), 7.5, dtype=torch.float64)
    for i, q in enumerate(seqs):
        packed[i, :len(q)] = torch.from_numpy(q)
    params = port_params(jax_stacked())
    score = sgmcmc.make_seq_marginal_score_fn(
        lgssm.windowed_marginal_gradient,
        sgmcmc.PFScoreConfig(subsequence_length=-1), lengths)
    g, ll = score(None, params, packed)
    parts = [(lgssm.gradient_marginal_loglikelihood(params, q),
              lgssm.marginal_loglikelihood(params, q))
             for q in map(torch.from_numpy, seqs)]
    np.testing.assert_allclose(ll.numpy(), sum(p[1] for p in parts).numpy(),
                               **F64)
    for f in FIELDS:
        np.testing.assert_allclose(
            getattr(g, f).numpy(),
            sum(getattr(p[0], f) for p in parts).numpy(), **F64)


def test_marginal_score_is_unbiased_over_starts():
    """With B = T (buffer_length=-1: exact boundary messages) the average
    of the windowed score over every start equals the full-data gradient,
    in float64 (the JAX package's test_lgssm_marginal_score_unbiased on
    the port's score); rtol 1e-9."""
    T, S = 16, 4
    gen = torch.Generator().manual_seed(12)
    truth = lgssm.from_scalars(0.8, 0.5, 0.7, dtype=torch.float64)
    ys, _ = lgssm.generate_data(gen, truth, T)
    score = sgmcmc.make_marginal_score_fn(
        lgssm.windowed_marginal_gradient,
        sgmcmc.PFScoreConfig(subsequence_length=S, buffer_length=-1), T)
    n_starts = T - S + 1
    starts = torch.arange(n_starts)
    rows = lgssm.LGSSMParams(*[getattr(truth, f).expand(
        (n_starts,) + getattr(truth, f).shape[1:]) for f in FIELDS])
    g, ll = score(None, rows, ys, sgmcmc.ExactDraws(starts))
    assert bool(torch.isfinite(ll).all())
    mean = lgssm.LGSSMParams(*[getattr(g, f).mean(0, keepdim=True)
                               for f in FIELDS])
    assert_params(mean, lgssm.gradient_marginal_loglikelihood(truth, ys),
                  rtol=1e-9, atol=1e-9)


def test_latent_var_sample_marginal_and_suff_statistic_match_jax():
    """Per-t draws from the smoothed marginals on JAX's normals, and the
    particle filter's sufficient statistic."""
    T, K, lag = 10, 2, None
    ys = np.random.default_rng(13).standard_normal((T, 1))
    x_t, x_n = np.random.default_rng(14).standard_normal((2, 2, 5, 1))
    key = jax.random.PRNGKey(15)

    def jax_side(p, y, x0, x1):
        return (jl.latent_var_sample(p, key, y, num_samples=K,
                                     distr="marginal", lag=lag),
                jax.random.normal(key, (K, T, 1), f64),
                jl.suff_statistic(p, x0, x1, y[0], 0))
    want, z, stat = jit(jax.vmap(jax_side, in_axes=(0, None, 0, 0)))(
        jax_stacked(), jnp.asarray(ys), jnp.asarray(x_t), jnp.asarray(x_n))
    t = torch.from_numpy
    params = port_params(jax_stacked())
    got = lgssm.latent_var_sample(params, None, t(ys), num_samples=K,
                                  distr="marginal", lag=lag,
                                  normals=t(np.array(z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)
    np.testing.assert_allclose(
        lgssm.suff_statistic(params, t(x_t), t(x_n), None, 0).numpy(),
        np.asarray(stat), **F64)


def test_sampler_surface_on_cpu():
    """The new sampler entry points run on the CPU with finite results:
    fit_scan of both kinds, the Seq marginal kind, Gibbs sweeps on every
    chain, and the likelihood surface (floats for one chain, [C] tensors
    for C chains)."""
    gen = torch.Generator().manual_seed(16)
    ys, _ = lgssm.generate_data(gen, lgssm.from_scalars(0.9, 0.5, 1.0), 60)
    s = samplers.LGSSMSampler(observations=ys[:, 0], device="cpu", seed=1)
    s.parameters = lgssm.from_scalars(0.5, 1.0, 2.0)
    ll1 = s.exact_loglikelihood()
    assert isinstance(ll1, float) and np.isfinite(ll1)
    assert s.noisy_loglikelihood(kind="marginal") == ll1
    for kind in ("marginal", "complete", "pf", None):
        v = s.noisy_loglikelihood(kind=kind, subsequence_length=8,
                                  buffer_length=2, N=64)
        assert isinstance(v, float) and np.isfinite(v), kind
    assert s.exact_gradient().A.dtype == torch.float64
    for kind in ("marginal", "complete"):
        trace, aux = s.fit_scan("SGLD", num_iters=2, num_chains=3,
                                subsequence_length=8, buffer_length=2,
                                kind=kind, return_aux=True)
        assert trace.A.shape == (3, 2, 1, 1) and aux.shape == (3, 2)
        for leaf in (trace.A, trace.LQinv_vec, trace.LRinv_vec, aux):
            assert bool(torch.isfinite(leaf).all())
    for _ in range(2):
        p = s.sample_gibbs()
    assert p.A.shape == (3, 1, 1) and bool((p.C == 1.0).all())
    assert bool((p.A.abs() <= 0.9999).all())
    assert s.exact_loglikelihood().shape == (3,)
    seqs = [ys[:40, 0].numpy(), ys[40:, 0].numpy(), ys[5:35, 0].numpy()]
    sq = samplers.SeqLGSSMSampler(seqs, device="cpu", num_sequences=2)
    trace = sq.fit_scan("SGLD", num_iters=2, num_chains=3, kind="marginal",
                        subsequence_length=6, buffer_length=2)
    assert bool(torch.isfinite(trace.A).all())
    assert sq.exact_loglikelihood().shape == (3,)
    single = samplers.SeqLGSSMSampler(seqs, device="cpu")
    single.parameters = lgssm.from_scalars(0.9, 0.5, 1.0)
    total = sum(lgssm.marginal_loglikelihood(
        single.parameters, torch.as_tensor(q)[:, None]).item() for q in seqs)
    np.testing.assert_allclose(single.exact_loglikelihood(), total,
                               rtol=1e-10)
    with pytest.raises(ValueError, match="SeqSampler"):
        sq.fit_scan("SGLD", num_iters=1, kind="complete")


@pytest.mark.parametrize("kind,what", [
    ("marginal", "has no analytic message passing"),
    ("complete", "has no complete-data gradient path")])
def test_models_without_messages_raise_jax_wording(kind, what):
    s = samplers.SVMSampler(observations=np.zeros(20, np.float32),
                            device="cpu")
    with pytest.raises(NotImplementedError, match=what):
        s.fit_scan("SGLD", num_iters=1, kind=kind)
    # the particle filter's log-likelihood needs no messages
    assert np.isfinite(s.noisy_loglikelihood(N=16))
    with pytest.raises(NotImplementedError, match="exact"):
        s.exact_loglikelihood()
    assert registry.SVM.gibbs_step is None
    with pytest.raises(ValueError, match="kind"):
        s.noisy_loglikelihood(kind="exact")
