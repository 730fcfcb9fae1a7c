"""The port's multi-sequence (Seq) score and its valid gate against the
JAX package: K1's plain version with the valid gate (JAX kernel with
``valid_gate=True`` in interpret mode), the unfused ``step_valid``, the
Seq window arithmetic of ``make_seq_pf_score_fn``, padding invariance on
both routes, the full-sequence score against the per-sequence scores,
``pack_sequences``, the shortest-sequence guards and the Seq samplers on
the CPU.

Draws are made with numpy (or rebuilt from JAX's keys) and fed to both
packages; the JAX kernel stores particles folded as [s, B] with particle
j = s*p + q at (row q, lane p), the port in natural order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgmcmc_tpu_torch
from sgmcmc_tpu.inference import samplers as jsamplers
from sgmcmc_tpu.inference import sgmcmc as jsgmcmc
from sgmcmc_tpu.models import svm as jsvm
from sgmcmc_tpu.ops import buffered as jbuffered
from sgmcmc_tpu.ops.pallas.fused_pf import fused_window_batched
from sgmcmc_tpu_torch.inference import samplers, sgmcmc
from sgmcmc_tpu_torch.models import svm
from sgmcmc_tpu_torch.ops import buffered
from sgmcmc_tpu_torch.ops.cuda import fused_pf

torch.set_num_threads(1)

FAST = dict(compiler_options={"xla_backend_optimization_level": 0})
LENGTHS = (30, 45, 38)


def fold(a):
    """[..., D, N] natural particle order -> [..., D*s, B], j = s*p + q."""
    B = a.shape[-1] // 8
    f = np.swapaxes(a.reshape(a.shape[:-1] + (B, 8)), -1, -2)
    return f.reshape(a.shape[:-2] + (-1, B))


def window_draws(seed, C, N, W, T_valid):
    """SVM window inputs whose steps from ``T_valid[c]`` on are padding:
    weight 0 and validity 0 there."""
    rng = np.random.default_rng(seed)
    pvec = np.stack([rng.uniform(0.5, 0.95, C),
                     rng.uniform(0.3, 1.5, C) ** -0.5,
                     rng.uniform(0.5, 2.0, C) ** -0.5], -1).astype(np.float32)
    x0 = rng.standard_normal((C, 1, N)).astype(np.float32) * 2.0
    normals = rng.standard_normal((C, W, 1, N)).astype(np.float32)
    ys = (np.exp(rng.uniform(-2.0, 2.0, (C, W)))
          * rng.standard_normal((C, W))).astype(np.float32)
    vs = (np.arange(W)[None] < np.asarray(T_valid)[:, None]).astype(
        np.float32)
    weights = rng.uniform(1.0, 3.0, (C, W)).astype(np.float32) * vs
    weights[:, :2] = 0.0
    xi = rng.uniform(0.0, 1.0, (C, W)).astype(np.float32)
    return pvec, x0, normals, ys, weights, xi, vs


@pytest.mark.parametrize("ess", [None, 0.5])
def test_valid_gate_matches_jax_fused_kernel(ess):
    """K1's plain version with ``vs`` against the JAX kernel with
    ``valid_gate=True`` (with and without the ESS gate), one chain fully
    valid and one padded after step 7.  Statistic rtol=atol=1e-4, loglik
    rtol 1e-5."""
    C, N, W = 2, 64, 12
    arrays = window_draws(1, C, N, W, [W, 7])
    pvec, x0, normals, ys, weights, xi, vs = arrays
    out = fused_pf.fused_window(
        svm.FUSED, *[torch.from_numpy(a) for a in arrays[:6]],
        ess_threshold=ess, vs=torch.from_numpy(vs)).numpy()
    ms, ll = jax.jit(lambda *a: fused_window_batched(
        jsvm.FUSED, *a[:6], interpret=True, ess_threshold=ess, vs=a[6],
        valid_gate=True), **FAST)(
        jnp.asarray(pvec), jnp.asarray(fold(x0)), jnp.asarray(fold(normals)),
        jnp.asarray(ys), jnp.asarray(weights), jnp.asarray(xi),
        jnp.asarray(vs))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[:, :3], np.asarray(ms), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out[:, 3], np.asarray(ll), rtol=1e-5)
    # the gate is on: the padded chain differs from its ungated run
    free = fused_pf.fused_window(
        svm.FUSED, *[torch.from_numpy(a) for a in arrays[:6]],
        ess_threshold=ess).numpy()
    np.testing.assert_array_equal(out[0], free[0])
    assert not np.array_equal(out[1], free[1])


def jax_draws(N, W, key):
    """The draws JAX's run_buffered_pf takes from ``key`` (systematic)."""
    key_init, key_steps = jax.random.split(key)
    z0 = jax.random.normal(key_init, (N, 1), jnp.float32)[:, 0]

    def step(k):
        kr, kp = jax.random.split(k)
        return (jax.random.uniform(kr, (), jnp.float32),
                jax.random.normal(kp, (N, 1), jnp.float32)[:, 0])
    u, z = jax.vmap(step)(jax.random.split(key_steps, W))
    return z0, u, z


def test_unfused_step_valid_matches_jax():
    """run_buffered_pf with ``step_valid`` against the JAX package's on
    the draws rebuilt from its keys (systematic, Poyiadjis O(N)): the
    frozen carry includes the running log-likelihood.  Statistic
    rtol=atol=1e-4, loglik rtol 1e-5."""
    C, N, W = 2, 64, 12
    pvec, _, _, ys, weights, _, vs = window_draws(2, C, N, W, [W, 7])
    jps = [jsvm.from_scalars(float(p[0]), float(p[1]) ** -2,
                             float(p[2]) ** -2) for p in pvec]
    params = jax.tree_util.tree_map(lambda *x: np.stack(x), *jps)
    def run(k, p, y, sw, v):
        out = jbuffered.run_buffered_pf(
            jsvm.KERNEL, jsvm.grad_statistic, p, y[:, None], key=k,
            n_particles=N, statistic_dim=3, step_weights=sw,
            in_window=(sw > 0).astype(sw.dtype), prior_mean=0.0,
            prior_var=1.0, resampler="systematic", resample_mode="auto",
            step_valid=v)
        return out.mean_statistic, out.loglikelihood, jax_draws(N, W, k)
    want_stat, want_ll, draws = jax.jit(lambda *a: jax.vmap(run)(
        jax.random.split(jax.random.PRNGKey(3), C), *a), **FAST)(
        params, ys, weights, vs)
    z0, u, z = (torch.from_numpy(np.array(a)) for a in draws)
    t = torch.from_numpy
    port_params = svm.params_from_jax(params)
    out = buffered.run_buffered_pf(
        svm.KERNEL, svm.grad_statistic, port_params, t(ys)[..., None],
        z0=z0[:, None], normals=z[:, :, None], u=u, statistic_dim=3,
        step_weights=t(weights), in_window=(t(weights) > 0).float(),
        prior_mean=torch.zeros(C), prior_var=torch.ones(C),
        resampler="systematic", step_valid=t(vs))
    np.testing.assert_allclose(out.mean_statistic.numpy(),
                               np.asarray(want_stat), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.loglikelihood.numpy(),
                               np.asarray(want_ll), rtol=1e-5)


def reveal_layout(kernel, stat_fn, params, window, *, step_weights,
                  in_window, step_valid=None, **kw):
    """Stand-in for the JAX run_buffered_pf whose statistic is what the
    Seq score hands it: step weights, in-window mask, validity, window."""
    valid = jnp.ones_like(step_weights) if step_valid is None else step_valid
    stat = jnp.concatenate([step_weights, in_window, valid, window[:, 0]])
    return jbuffered.PFOutput(None, None, None, jnp.zeros((), window.dtype),
                              stat)


@pytest.mark.parametrize("S,B", [(4, 2), (4, -1), (-1, 0)],
                         ids=["S4-B2", "S4-full-buffers", "full-sequence"])
def test_sequence_window_matches_jax(monkeypatch, S, B):
    """The port's Seq layout (sequence, start -> coverage weights, window
    bounds, validity) equals make_seq_pf_score_fn's, exactly.  The JAX
    score runs with its smoother replaced by a stand-in that returns the
    layout it was given; lengths 16, 8, 8 make every rescale
    T_total / T_i a power of two, so the layout is read back exactly, and
    observation t of sequence i is 100 i + t + 1, so the window names its
    sequence and start."""
    lengths = np.array([16, 8, 8])
    T_max = int(lengths.max())
    packed = np.zeros((3, T_max, 1), np.float32)
    for i, T_i in enumerate(lengths):
        packed[i, :T_i, 0] = 100 * i + np.arange(1, T_i + 1)
    monkeypatch.setattr(jsgmcmc, "run_buffered_pf", reveal_layout)
    cfg = dict(n_particles=8, subsequence_length=S, buffer_length=B)
    score = jsgmcmc.make_seq_pf_score_fn(
        jsvm.KERNEL, jsvm.grad_statistic, 3, lambda s: s,
        jsgmcmc.PFScoreConfig(**cfg), lengths, num_sequences=1)
    stats = np.asarray(jax.jit(lambda obs: jax.vmap(
        lambda k: score(k, jsvm.from_scalars(0.9, 0.5, 1.0), obs)[0])(
            jax.random.split(jax.random.PRNGKey(7), 12)), **FAST)(packed))
    port = sgmcmc.SeqPFScore(svm.KERNEL, svm.grad_statistic, 3,
                             svm.unpack_grad, sgmcmc.PFScoreConfig(**cfg),
                             lengths, num_sequences=1)
    W = port.W
    assert stats.shape == (12, 4 * W)
    seen = set()
    for row in stats:
        # the sequence i whose first window value, unscaled, is 100 i + k
        seq = next(i for i, T_i in enumerate(lengths)
                   if 0 < row[3 * W] * T_i / lengths.sum() - 100 * i <= T_i)
        row = row * lengths[seq] / lengths.sum()
        step_w, in_win, valid, y = row.reshape(4, W)
        window_start = int(y[0]) - 100 * seq - 1
        t1 = int(np.argmax(in_win > 0))
        start = 0 if S == -1 else window_start + t1
        draws = sgmcmc.WindowDraws(start=torch.tensor([start]), z0=None,
                                   normals=None, u=None,
                                   seq=torch.tensor([seq]))
        window, got_w, got_in, got_valid = port._layout(
            draws, torch.from_numpy(packed))
        np.testing.assert_array_equal(got_w[0].numpy(), step_w)
        np.testing.assert_array_equal(got_in[0].numpy(), in_win)
        np.testing.assert_array_equal(
            np.ones(W, np.float32) if got_valid is None
            else got_valid[0].numpy(), valid)
        np.testing.assert_array_equal(window[0, :, 0].numpy(), y)
        seen.add((seq, start))
    assert len(seen) > 3 or S == -1


def seq_case(pad_value=0.0):
    """Three SVM sequences packed with ``pad_value`` in their tails."""
    gen = torch.Generator().manual_seed(8)
    truth = svm.from_scalars(0.9, 0.5, 1.0)
    seqs = [svm.generate_data(gen, truth, T)[0] for T in LENGTHS]
    packed, lengths = samplers.pack_sequences(seqs)
    for i, T_i in enumerate(lengths):
        packed[i, T_i:] = pad_value
    return seqs, packed, lengths


def seq_score(cfg_kw, lengths, fused, monkeypatch, num_sequences=-1):
    cfg = sgmcmc.PFScoreConfig(n_particles=32, resampler="systematic",
                               **cfg_kw)
    score = sgmcmc.make_seq_pf_score_fn(
        svm.KERNEL, svm.grad_statistic, 3, svm.unpack_grad, cfg, lengths,
        num_sequences, prior_mean_var_fn=lambda p: (
            torch.zeros_like(p.a), svm.stationary_variance(p)),
        fused_model=svm.FUSED)
    if fused:   # the fused route on CPU tensors: K1's plain version
        monkeypatch.setattr(sgmcmc.PFScore, "uses_fused",
                            lambda self, device: True)
    return score


def params_of(C):
    return svm.SVMParams(A=torch.full((C, 1, 1), 0.8),
                         LQinv_vec=torch.full((C, 1), 1.2),
                         LRinv_vec=torch.full((C, 1), 0.9))


@pytest.mark.parametrize("cfg_kw", [
    dict(subsequence_length=-1),
    dict(subsequence_length=6, buffer_length=-1)],
    ids=["full-sequence", "full-buffers"])
@pytest.mark.parametrize("route", ["unfused", "fused"])
def test_padding_invariance(monkeypatch, route, cfg_kw):
    """The same sequences padded with 0 and with -12.25 give identical
    statistics and log-likelihoods on both routes, bitwise (the valid gate
    keeps the padding out of the filter)."""
    params = params_of(2)
    out = []
    for pad in (0.0, -12.25):
        _, packed, lengths = seq_case(pad)
        score = seq_score(cfg_kw, lengths, route == "fused", monkeypatch)
        gen = torch.Generator().manual_seed(9)
        draws = score.draw(gen, 2, "cpu")
        g, ll = score(None, params, packed, draws)
        out.append(torch.cat([g.A.reshape(2, 1), g.LQinv_vec, g.LRinv_vec,
                              ll[:, None]], 1))
    assert bool(torch.isfinite(out[0]).all())
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("route", ["unfused", "fused"])
def test_full_sequence_score_is_the_sum_of_sequence_scores(monkeypatch,
                                                           route):
    """S=-1 over all sequences: the Seq score equals the sum of the
    single-sequence scores on the same draws (truncated to each length;
    the rescale T_total / sum T_i is 1).  rtol 1e-6 (float32 sums)."""
    seqs, packed, lengths = seq_case()
    C = 2
    params = params_of(C)
    score = seq_score(dict(subsequence_length=-1), lengths,
                      route == "fused", monkeypatch)
    draws = score.draw(torch.Generator().manual_seed(10), C, "cpu")
    g, ll = score(None, params, packed, draws)
    k = len(seqs)
    want_g, want_ll = 0.0, 0.0
    for i, obs in enumerate(seqs):
        T_i = int(lengths[i])
        one = sgmcmc.make_pf_score_fn(
            svm.KERNEL, svm.grad_statistic, 3, svm.unpack_grad,
            score.config, T_i, score.prior_mean_var_fn, svm.FUSED)
        rows = torch.arange(C) * k + i
        d = sgmcmc.WindowDraws(
            start=torch.zeros(C, dtype=torch.int64), z0=draws.z0[rows],
            normals=draws.normals[rows, :T_i], u=draws.u[rows, :T_i])
        gi, lli = one(None, params, obs, d)
        want_g = want_g + torch.cat([gi.A.reshape(C, 1), gi.LQinv_vec,
                                     gi.LRinv_vec], 1)
        want_ll = want_ll + lli
    got = torch.cat([g.A.reshape(C, 1), g.LQinv_vec, g.LRinv_vec], 1)
    np.testing.assert_allclose(got.numpy(), want_g.numpy(), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(ll.numpy(), want_ll.numpy(), rtol=1e-6)


def test_pack_sequences_matches_jax():
    seqs, _, _ = seq_case()
    packed, lengths = samplers.pack_sequences(seqs)
    want, want_len = jsamplers.pack_sequences([s.numpy() for s in seqs])
    assert packed.shape == (3, max(LENGTHS), 1) and packed.dtype == \
        torch.float32
    np.testing.assert_array_equal(lengths, want_len)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))
    packed_1d, _ = samplers.pack_sequences([s[:, 0] for s in seqs])
    assert packed_1d.shape == (3, max(LENGTHS))


@pytest.mark.parametrize("cfg_kw,match", [
    (dict(subsequence_length=10, buffer_length=11), "window 32"),
    (dict(subsequence_length=31, buffer_length=-1), "subsequence 31")])
def test_shortest_sequence_guards(cfg_kw, match):
    """A window or subsequence longer than the shortest sequence raises, in
    both packages."""
    lengths = np.array(LENGTHS)
    with pytest.raises(ValueError, match=match):
        jsgmcmc.make_seq_pf_score_fn(
            jsvm.KERNEL, jsvm.grad_statistic, 3, jsvm.unpack_grad,
            jsgmcmc.PFScoreConfig(**cfg_kw), lengths)
    with pytest.raises(ValueError, match=match):
        sgmcmc.make_seq_pf_score_fn(
            svm.KERNEL, svm.grad_statistic, 3, svm.unpack_grad,
            sgmcmc.PFScoreConfig(**cfg_kw), lengths)
    with pytest.raises(ValueError, match="num_sequences"):
        sgmcmc.make_seq_pf_score_fn(
            svm.KERNEL, svm.grad_statistic, 3, svm.unpack_grad,
            sgmcmc.PFScoreConfig(), lengths, num_sequences=4)


@pytest.mark.parametrize("cls,kw", [
    ("SeqSVMSampler", dict(subsequence_length=8, buffer_length=2,
                           num_sequences=1)),
    ("SeqGARCHSampler", dict(subsequence_length=8, buffer_length=2,
                             num_sequences=2)),
    ("SeqSVJMSampler", dict(subsequence_length=6, buffer_length=-1)),
    ("SeqLGSSMSampler", dict(subsequence_length=-1))])
def test_seq_fit_scan_on_cpu(cls, kw):
    """The Seq samplers' fit_scan on the CPU: T is the total length and the
    trace and log-likelihoods are finite."""
    seqs, _, lengths = seq_case()
    s = getattr(samplers, cls)(seqs, device="cpu", seed=11)
    assert s.T == sum(LENGTHS)
    assert getattr(sgmcmc_tpu_torch, cls) is type(s)
    trace, aux = s.fit_scan("SGLD", num_iters=2, num_chains=3,
                            chain_init="prior", N=32,
                            resampler="systematic", return_aux=True, **kw)
    assert aux.shape == (3, 2) and bool(torch.isfinite(aux).all())
    for f in trace.__dataclass_fields__:
        assert bool(torch.isfinite(getattr(trace, f)).all())


def test_seq_marginal_kind_raises():
    seqs, _, _ = seq_case()
    s = samplers.SeqSVMSampler(seqs, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        s.fit_scan("SGLD", num_iters=1, kind="marginal")
