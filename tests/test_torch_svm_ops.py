"""SVM model functions, subsequence windows and window weights of the port
against the JAX package on the same inputs (float32; exact or 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgmcmc_tpu.models import svm as jsvm
from sgmcmc_tpu.ops import buffered as jbuffered
from sgmcmc_tpu.ops import subsequence as jsub
from sgmcmc_tpu.ops.pallas import resample as jresample
from sgmcmc_tpu_torch.models import svm
from sgmcmc_tpu_torch.ops import buffered, resampling, subsequence
from sgmcmc_tpu_torch.ops.cuda import resample

torch.set_num_threads(1)

SCALARS = [(0.9, 0.5, 1.0), (-0.3, 2.0, 0.7), (0.9999, 1.0, 1.0)]


def stacked():
    """JAX params of each chain and the port's stacked [C] parameters."""
    jps = [jsvm.from_scalars(*s) for s in SCALARS]
    port = svm.SVMParams(
        A=torch.cat([svm.params_from_jax(p).A for p in jps]),
        LQinv_vec=torch.cat([svm.params_from_jax(p).LQinv_vec for p in jps]),
        LRinv_vec=torch.cat([svm.params_from_jax(p).LRinv_vec for p in jps]))
    return jps, port


def test_params_round_trip():
    jps, port = stacked()
    back = svm.params_to_numpy(port)
    for c, jp in enumerate(jps):
        rebuilt = jsvm.SVMParams(**{k: v[c] for k, v in back.items()})
        for f in ("A", "LQinv_vec", "LRinv_vec"):
            np.testing.assert_array_equal(getattr(rebuilt, f),
                                          getattr(jp, f))
    one = svm.params_from_jax(jps[0])
    assert one.A.shape == (1, 1, 1) and one.LQinv_vec.shape == (1, 1)


def test_from_scalars_and_stationary_variance():
    jps, port = stacked()
    mine = svm.SVMParams(*[torch.cat(x) for x in zip(*[
        (p.A, p.LQinv_vec, p.LRinv_vec)
        for p in (svm.from_scalars(*s) for s in SCALARS)])])
    for f in ("A", "LQinv_vec", "LRinv_vec"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(port, f))
    want = [float(jsvm.stationary_variance(p)) for p in jps]
    np.testing.assert_allclose(svm.stationary_variance(port).numpy(), want,
                               rtol=1e-6)
    assert float(svm.stationary_variance(port)[2]) == 1e3   # the cap


def test_fused_body_and_kernel_match_jax():
    rng = np.random.default_rng(0)
    jps, port = stacked()
    C, N = len(jps), 16
    x = rng.normal(0, 2, (C, N)).astype(np.float32)
    z = rng.standard_normal((C, N)).astype(np.float32)
    y = rng.normal(0, 1.5, (C,)).astype(np.float32)
    x[0, 0], x[1, 0] = -80.0, 80.0                  # exercise the clip
    pv = svm._fused_pack(port)
    cols = [pv[:, i:i + 1] for i in range(3)]
    xt, zt, yt = torch.from_numpy(x), torch.from_numpy(z), torch.from_numpy(y)
    xn = svm._fused_propose(cols, [zt], [xt], yt[:, None])
    lw = svm._fused_reweight(cols, [xt], xn, yt[:, None])
    h = svm._fused_stat(cols, [xt], xn, yt[:, None])
    lw_k = svm._reweight(port, xt[..., None], xn[0][..., None], yt[:, None])
    gs = svm.grad_statistic(port, xt[..., None], xn[0][..., None],
                            yt[:, None], 0)
    for c, jp in enumerate(jps):
        jpv = list(jsvm._fused_pack(jp))
        jxn = jsvm._fused_propose(jpv, [z[c]], [x[c]], y[c])
        np.testing.assert_allclose(xn[0][c].numpy(), jxn[0], rtol=1e-6)
        xn_c = xn[0][c].numpy()
        jlw = jsvm._fused_reweight(jpv, [x[c]], [xn_c], y[c])
        np.testing.assert_allclose(lw[c].numpy(), jlw, rtol=1e-6)
        np.testing.assert_allclose(
            lw_k[c].numpy(), jsvm._reweight(jp, x[c][:, None],
                                            xn_c[:, None], y[c:c + 1]),
            rtol=1e-6)
        jh = jsvm._fused_stat(jpv, [x[c]], [xn_c], y[c])
        jg = jsvm.grad_statistic(jp, x[c][:, None], xn_c[:, None],
                                 y[c:c + 1], 0)
        for k in range(3):
            np.testing.assert_allclose(h[k][c].numpy(), jh[k], rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_allclose(gs[c].numpy(), jg, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(torch.stack(h, -1)[c].numpy(), jg,
                                   rtol=1e-6, atol=1e-6)


def test_unpack_prior_and_projection_match_jax():
    jps, port = stacked()
    stat = np.arange(3 * len(jps), dtype=np.float32).reshape(-1, 3)
    un = svm.unpack_grad(torch.from_numpy(stat))
    prior, jprior = svm.default_prior(), jsvm.default_prior()
    g = svm.grad_logprior(prior, port)
    lp = svm.logprior(prior, port)
    raw = svm.SVMParams(A=port.A * 1.5, LQinv_vec=-port.LQinv_vec,
                        LRinv_vec=port.LRinv_vec)
    proj = svm.project_parameters(raw)
    for c, jp in enumerate(jps):
        ju = jsvm.unpack_grad(jnp.asarray(stat[c]))
        jg = jsvm.grad_logprior(jprior, jp)
        jraw = jsvm.SVMParams(A=jp.A * 1.5, LQinv_vec=-jp.LQinv_vec,
                              LRinv_vec=jp.LRinv_vec)
        jproj = jsvm.project_parameters(jraw)
        for f in ("A", "LQinv_vec", "LRinv_vec"):
            np.testing.assert_array_equal(getattr(un, f)[c],
                                          getattr(ju, f))
            np.testing.assert_allclose(getattr(g, f)[c].numpy(),
                                       getattr(jg, f), rtol=1e-6)
            np.testing.assert_allclose(getattr(proj, f)[c].numpy(),
                                       getattr(jproj, f), rtol=1e-6)
        np.testing.assert_allclose(float(lp[c]),
                                   float(jsvm.logprior(jprior, jp)),
                                   rtol=1e-5)


def test_sample_prior_is_projected_and_finite():
    prior = svm.default_prior()
    g = torch.Generator().manual_seed(0)
    p = svm.project_parameters(svm.sample_prior(prior, g, 64))
    assert p.A.shape == (64, 1, 1) and p.LQinv_vec.shape == (64, 1)
    assert bool((p.A.abs() <= 0.9999).all())
    assert bool((p.LQinv_vec > 0).all() and (p.LRinv_vec > 0).all())
    assert bool(torch.isfinite(svm.logprior(prior, p)).all())


@pytest.mark.parametrize("S,B,T", [(8, 2, 40), (40, 10, 1000), (5, -1, 30)])
def test_windows_and_weights_match_jax(S, B, T):
    """The same start gives identical weights, window bounds and step
    weights in both packages."""
    keys = jax.random.split(jax.random.PRNGKey(S + T), 24)
    jw = jax.vmap(lambda k: jsub.sample_buffered_window(k, S, B, T))(keys)
    W = jsub.window_length(S, B, T)
    start = np.asarray(jw.window_start + jw.t1)
    starts = np.concatenate([start, [0, T - S, T // 2]])
    port = subsequence.buffered_window(torch.from_numpy(starts), S, B, T)
    jall = jax.vmap(lambda st: jsub.subsequence_weights(st, S, T))(
        jnp.asarray(starts))
    np.testing.assert_array_equal(port.weights.numpy(), np.asarray(jall))
    n = len(start)
    np.testing.assert_array_equal(port.window_start[:n].numpy(),
                                  np.asarray(jw.window_start))
    np.testing.assert_array_equal(port.t1[:n].numpy(), np.asarray(jw.t1))
    np.testing.assert_array_equal(port.tL[:n].numpy(), np.asarray(jw.tL))
    sw, iw = buffered.window_weights(port.t1, port.tL, port.weights, W)
    jsw, jiw = jax.vmap(lambda a, b, w: jbuffered.window_weights(
        a, b, w, W))(jnp.asarray(port.t1.numpy()),
                     jnp.asarray(port.tL.numpy()), jall)
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    np.testing.assert_array_equal(iw.numpy(), np.asarray(jiw))
    assert subsequence.window_length(S, B, T) == W


def test_resampling_host_side_matches_jax():
    """CDF (float64-accumulated in the port: rtol 1e-6), systematic
    positions and the index-based apply (exact on the same CDF)."""
    rng = np.random.default_rng(1)
    C, N = 3, 32
    lw = (rng.standard_normal((C, N)) * 3).astype(np.float32)
    lw[2] = -np.inf                                  # degenerate chain
    u = rng.uniform(0, 1, C).astype(np.float32)
    vals = rng.standard_normal((C, N, 4)).astype(np.float32)
    cdf = resample.weights_cdf(torch.from_numpy(lw))
    pos = resample.resample_positions("systematic", torch.from_numpy(u), N)
    out = resample.resample_apply(pos, cdf, torch.from_numpy(vals))
    anc = resampling.systematic_resampling(torch.from_numpy(u),
                                           torch.from_numpy(lw))
    for c in range(C):
        np.testing.assert_allclose(cdf[c].numpy(),
                                   np.asarray(jresample.weights_cdf(lw[c])),
                                   rtol=1e-6)
        jpos = (jnp.arange(N, dtype=jnp.float32) + u[c]) / N
        np.testing.assert_array_equal(pos[c].numpy(), np.asarray(jpos))
        jout = jresample.resample_apply_gather(
            jnp.asarray(pos[c].numpy()), jnp.asarray(cdf[c].numpy()),
            jnp.asarray(vals[c]))
        np.testing.assert_array_equal(out[c].numpy(), np.asarray(jout))
        np.testing.assert_array_equal(
            out[c].numpy(), vals[c][anc[c].numpy()])
    np.testing.assert_array_equal(anc[2].numpy(), np.arange(N))
    probs = resampling.normalize_log_weights(torch.from_numpy(lw))
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_sample_buffered_window_draws_valid_windows():
    g = torch.Generator().manual_seed(0)
    S, B, T = 8, 2, 40
    win = subsequence.sample_buffered_window(g, S, B, T, 100)
    W = subsequence.window_length(S, B, T)
    start = win.window_start + win.t1
    assert bool((win.window_start >= 0).all())
    assert bool((win.window_start + W <= T).all())
    assert bool(((start >= 0) & (start <= T - S)).all())
    assert bool((win.tL - win.t1 == S).all())
    again = subsequence.buffered_window(start, S, B, T)
    np.testing.assert_array_equal(again.weights.numpy(), win.weights.numpy())
    start2, w2 = subsequence.sample_subsequence(
        torch.Generator().manual_seed(1), 10, 30, 5, "strict")
    assert bool((start2 % 10 == 0).all())
    np.testing.assert_array_equal(w2.numpy(), np.full((5, 10), 3.0))
