"""The port's PaRIS smoothers (exact and accept-reject backward sampling)
against the JAX package.

``paris`` is held to JAX's ``make_paris_step`` draw for draw: JAX's
``run_buffered_pf(smoother="paris", save_all=True)`` gives the carry of
every step, from which its own backward indices J are rebuilt (the step
splits its key into ``(key_prop, key_bs)`` first, then ``key_prop`` into
the resampling and proposal keys; J[i] is ``categorical`` on the split
``key_bs`` of row i), and the port runs on JAX's initial normals,
resampling uniforms, proposal normals and J.  Statistic rtol = atol =
1e-4, log-likelihood rtol 1e-5 (float32 rounding; the two CDFs are
accumulated in different orders).  The port's own backward draw (inverse
CDF at the uniforms ``v``, a named exception: JAX draws Gumbel-max
categoricals) is held to the normalised backward weights by a chi-square
test, and ``paris_ar`` to ``paris`` bit for bit with no accept-reject
round and in law with them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sstats

from sgmcmc_tpu.models import garch as jgarch
from sgmcmc_tpu.models import lgssm as jlgssm
from sgmcmc_tpu.models import svm as jsvm
from sgmcmc_tpu.ops import buffered as jbuffered
from sgmcmc_tpu.ops import smoothers as jsmoothers
from sgmcmc_tpu_torch.inference import sgmcmc
from sgmcmc_tpu_torch.inference.samplers import (Sampler, SeqSVMSampler,
                                                 SVMSampler)
from sgmcmc_tpu_torch.models import garch, lgssm, registry, svm
from sgmcmc_tpu_torch.ops import buffered, smoothers

torch.set_num_threads(1)

N, W, K = 64, 12, 2
# jitted JAX references compile faster without the backend's optimisation
FAST = dict(compiler_options={"xla_backend_optimization_level": 0})
# (port module, JAX module, JAX parameters of two chains, prior variance)
MODELS = {
    "svm": (svm, jsvm, lambda: [jsvm.from_scalars(0.8, 0.6, 1.1),
                                jsvm.from_scalars(0.5, 1.2, 0.8)], None),
    "lgssm": (lgssm, jlgssm, lambda: [
        jlgssm.from_matrices(A=[[0.8]], C=[[1.0]], Q=[[0.5]], R=[[1.3]],
                             dtype=jnp.float32),
        jlgssm.from_matrices(A=[[-0.4]], C=[[1.0]], Q=[[1.5]], R=[[0.6]],
                             dtype=jnp.float32)], 10.0),
    "garch": (garch, jgarch, lambda: [
        jgarch.from_alpha_beta_gamma(0.1, 0.6, 0.2, 0.5),
        jgarch.from_alpha_beta_gamma(0.3, 0.25, 0.5, 1.5)], None),
}


def stacked(ps):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *ps)


def windows(seed, C):
    """Observations and step weights [C, W] (two buffer steps)."""
    rng = np.random.default_rng(seed)
    ys = (np.exp(0.5 * rng.standard_normal((C, W)))
          * rng.standard_normal((C, W))).astype(np.float32)
    w = rng.uniform(1.0, 3.0, (C, W)).astype(np.float32)
    w[:, :2] = 0.0
    return ys, w


@functools.lru_cache(maxsize=None)
def jax_paris(name, ess, bw_chunk):
    """JAX's PaRIS over two chains, with its draws and its own backward
    indices J [2, W, N, K] rebuilt from its saved carries, in one jitted
    call."""
    mod, jmod, make, var = MODELS[name]
    jps = make()
    kernel = jmod.get_kernel(None)
    ys, w = windows(3, 2)
    pv = (np.full(2, var, np.float32) if var is not None else np.array(
        [float(jmod.stationary_variance(p)) for p in jps], np.float32))

    def one(key, p, y, sw, v):
        out, saved = jbuffered.run_buffered_pf(
            kernel, jmod.grad_statistic, p, y[:, None], key=key,
            n_particles=N, statistic_dim=mod.STATISTIC_DIM,
            smoother="paris", step_weights=sw,
            in_window=(sw > 0).astype(sw.dtype), prior_mean=0.0,
            prior_var=v, resampler="multinomial", resample_mode="auto",
            n_tilde=K, ess_threshold=ess, bw_chunk=bw_chunk, save_all=True)
        key_init, key_steps = jax.random.split(key)
        x0 = kernel.sample_x0(p, key_init, N, 0.0, v).astype(jnp.float32)
        prev_x = jnp.concatenate([x0[None], saved.particles[:-1]])
        prev_lw = jnp.concatenate([jnp.zeros((1, N), jnp.float32),
                                   saved.log_weights[:-1]])

        def step_draws(k, px, plw, nx):
            key_prop, key_bs = jax.random.split(k)
            kr, kp = jax.random.split(key_prop)
            log_bw = jsmoothers._backward_log_weights(kernel, p, px, plw, nx)
            J = jax.vmap(lambda kk, lw: jax.random.categorical(
                kk, lw, shape=(K,)))(jax.random.split(key_bs, N), log_bw)
            return (jax.random.uniform(kr, (N,), jnp.float32),
                    jax.random.normal(kp, (N,), jnp.float32), J)

        u, z, J = jax.vmap(step_draws)(jax.random.split(key_steps, W),
                                       prev_x, prev_lw, saved.particles)
        z0 = jax.random.normal(key_init, (N,), jnp.float32)
        return out.mean_statistic, out.loglikelihood, z0, u, z, J

    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    out = jax.jit(jax.vmap(one), **FAST)(keys, stacked(jps), ys, w, pv)
    return jps, ys, w, pv, [np.array(a) for a in out]


@pytest.mark.parametrize("name,ess,bw_chunk", [
    ("svm", None, None), ("svm", 0.5, 16), ("lgssm", 0.5, None),
    ("garch", None, 16)],
    ids=["svm", "svm-ess-chunk", "lgssm-ess", "garch-chunk"])
def test_paris_matches_jax_on_its_backward_indices(name, ess, bw_chunk):
    mod = MODELS[name][0]
    jps, ys, w, pv, (want_stat, want_ll, z0, u, z, J) = jax_paris(
        name, ess, bw_chunk)
    t = torch.from_numpy
    got = buffered.run_buffered_pf(
        mod.get_kernel(None), mod.grad_statistic,
        mod.params_from_jax(stacked(jps)), t(ys)[..., None],
        z0=t(z0)[:, None], normals=t(z)[:, :, None], u=t(u),
        statistic_dim=mod.STATISTIC_DIM, smoother="paris",
        step_weights=t(w), in_window=(t(w) > 0).float(),
        prior_mean=torch.zeros(2), prior_var=t(pv), resampler="multinomial",
        ess_threshold=ess, bw_chunk=bw_chunk, n_tilde=K,
        J=t(J.astype(np.int64)))
    assert bool(torch.isfinite(got.mean_statistic).all())
    np.testing.assert_allclose(got.mean_statistic.numpy(), want_stat,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.loglikelihood.numpy(), want_ll,
                               rtol=1e-5)


def random_carry(seed, C=2, n=16, H=3):
    """A PaRIS carry, new particles and a step input on the SVM."""
    g = torch.Generator().manual_seed(seed)
    params = svm.SVMParams(A=torch.tensor([0.8, 0.5]).reshape(2, 1, 1),
                           LQinv_vec=torch.tensor([[1.3], [0.9]]),
                           LRinv_vec=torch.tensor([[1.0], [1.2]]))
    carry = smoothers.PFCarry(
        torch.randn((C, n, 1), generator=g),
        torch.randn((C, n), generator=g), torch.randn((C, n, H), generator=g),
        torch.zeros(C))
    inp = smoothers.PFStepInput(
        z=torch.randn((C, n, 1), generator=g), u=torch.rand((C, n),
                                                           generator=g),
        y=torch.randn((C, 1), generator=g), weight=torch.tensor([1.5, 2.0]),
        in_window=torch.ones(C), t=3, v=torch.rand((C, n, K), generator=g),
        generator=torch.Generator().manual_seed(seed + 1))
    return params, carry, inp


def test_backward_draw_follows_the_backward_weights():
    """The inverse-CDF backward indices against the normalised backward
    weights of each row: a chi-square test per row (p > 1e-3), 20,000
    draws a row."""
    params, carry, _ = random_carry(0)
    g = torch.Generator().manual_seed(1)
    new = torch.randn((2, 16, 1), generator=g)
    v = torch.rand((2, 16, 20000), generator=g)
    J = smoothers._backward_indices(svm.KERNEL, params, carry.particles,
                                    carry.log_weights, new, v, None)
    x_t, x_next = smoothers._pairs(carry.particles, new)
    probs = torch.softmax(smoothers._backward_log_weights(
        svm.KERNEL, params, carry.log_weights, x_t, x_next), -1).double()
    for c in range(2):
        for i in range(16):
            counts = torch.bincount(J[c, i], minlength=16).double()
            p = probs[c, i]
            keep = p * v.shape[-1] >= 5       # pool the rare cells
            obs = torch.cat([counts[keep], counts[~keep].sum()[None]])
            exp = torch.cat([p[keep], p[~keep].sum()[None]]) * v.shape[-1]
            if float(exp[-1]) == 0.0:
                obs, exp = obs[:-1], exp[:-1]
            pval = sstats.chisquare(obs.numpy(), exp.numpy() * float(
                obs.sum() / exp.sum())).pvalue
            assert pval > 1e-3, (c, i, pval)


def test_paris_ar_without_rounds_is_paris():
    """paris_ar with a budget of 0 rounds takes the exact draw at v for
    every lane: the paris step's result bit for bit (bw_chunk too)."""
    params, carry, inp = random_carry(2)
    for chunk in (None, 4):
        exact = smoothers.make_paris_step(
            svm.KERNEL, svm.grad_statistic, bw_chunk=chunk)(params, carry,
                                                            inp)
        ar = smoothers.make_paris_ar_step(
            svm.KERNEL, svm.grad_statistic, max_accept_reject=0,
            bw_chunk=chunk)(params, carry, inp)
        for a, b in zip(exact, ar):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="n_tilde=3"):
        smoothers.make_paris_step(svm.KERNEL, svm.grad_statistic,
                                  n_tilde=3)(params, carry, inp)
    with pytest.raises(ValueError, match="generator"):
        smoothers.make_paris_ar_step(svm.KERNEL, svm.grad_statistic)(
            params, carry, inp._replace(generator=None))


def test_paris_ar_matches_paris_in_law():
    """The port's mirror of the JAX package's
    test_paris_ar_matches_paris_statistically: 12 replicate runs (chains)
    of each at N=128 over 25 steps, their means within rtol 0.3, atol 1.0;
    the accept-reject rounds run and count their host reads."""
    g = torch.Generator().manual_seed(5)
    truth = svm.from_scalars(0.9, 0.3, 1.0)
    ys, _ = svm.generate_data(g, truth, 25)
    R, n = 12, 128
    rows = svm.SVMParams(*[x.expand((R,) + x.shape[1:]) for x in (
        truth.A, truth.LQinv_vec, truth.LRinv_vec)])
    pv = svm.stationary_variance(rows)
    f = smoothers.accept_reject_backward_indices
    before = (f.calls, f.rounds, f.syncs)
    means = {}
    for name in ("paris", "paris_ar"):
        gen = torch.Generator().manual_seed(6)
        means[name] = buffered.run_buffered_pf(
            svm.KERNEL, svm.grad_statistic, rows,
            ys[None].expand(R, -1, -1), z0=torch.randn((R, 1, n),
                                                      generator=gen),
            normals=torch.randn((R, 25, 1, n), generator=gen),
            u=torch.rand((R, 25, n), generator=gen), statistic_dim=3,
            smoother=name, prior_mean=torch.zeros(R), prior_var=pv,
            v=torch.rand((R, 25, n, K), generator=gen),
            generator=gen).mean_statistic.mean(0)
    calls, rounds, syncs = (a - b for a, b in zip(
        (f.calls, f.rounds, f.syncs), before))
    assert calls == 25 and 8 <= rounds <= 25 * smoothers._default_ar_budget(n)
    assert syncs <= -(-rounds // smoothers.AR_CHECK_EVERY) + calls
    np.testing.assert_allclose(means["paris_ar"].numpy(),
                               means["paris"].numpy(), rtol=0.3, atol=1.0)


def test_n_tilde_reaches_the_config_and_the_draws():
    s = Sampler("svm", observations=np.zeros((30, 1)), device="cpu")
    assert s._score_config().n_tilde == 2
    assert s._score_config(Ntilde=3).n_tilde == 3
    assert s._score_config(n_tilde=4).n_tilde == 4
    cfg = sgmcmc.PFScoreConfig(n_particles=8, subsequence_length=6,
                               buffer_length=2, smoother="paris", n_tilde=3)
    score = sgmcmc.make_pf_score_fn(svm.KERNEL, svm.grad_statistic, 3,
                                    svm.unpack_grad, cfg, 30)
    draws = score.draw(torch.Generator().manual_seed(0), 2, "cpu")
    assert draws.v.shape == (2, 10, 8, 3)
    plain = sgmcmc.make_pf_score_fn(
        svm.KERNEL, svm.grad_statistic, 3, svm.unpack_grad,
        sgmcmc.PFScoreConfig(n_particles=8), 30)
    assert plain.draw(torch.Generator(), 2, "cpu").v is None


@pytest.mark.parametrize("pf", ["paris", "paris_ar"])
def test_seq_paris_score_is_invariant_to_its_padding(pf):
    """The Seq score's unfused route runs PaRIS through the valid gate
    (the demo's LD leg: every sequence, whole): padding 0 and -12.25 give
    bitwise equal scores."""
    rng = np.random.default_rng(4)
    lengths = np.array([9, 14, 6])
    packed = torch.zeros((3, 14, 1))
    for i, n_i in enumerate(lengths):
        packed[i, :n_i, 0] = torch.from_numpy(
            rng.standard_normal(n_i).astype(np.float32))
    cfg = sgmcmc.PFScoreConfig(n_particles=16, subsequence_length=-1,
                               smoother=pf, resample_mode="auto")
    score = sgmcmc.make_seq_pf_score_fn(
        svm.KERNEL, svm.grad_statistic, 3, svm.unpack_grad, cfg, lengths,
        prior_mean_var_fn=registry.SVM.prior_mean_var, fused_model=svm.FUSED)
    rows = svm.SVMParams(A=torch.full((2, 1, 1), 0.8),
                         LQinv_vec=torch.full((2, 1), 1.2),
                         LRinv_vec=torch.full((2, 1), 0.9))
    draws = score.draw(torch.Generator().manual_seed(1), 2, "cpu")
    assert score.valid_gate and draws.v.shape == (6, 14, 16, K)
    outs = []
    for pad in (0.0, -12.25):
        obs = packed.clone()
        for i, n_i in enumerate(lengths):
            obs[i, n_i:] = pad
        g, ll = score(torch.Generator().manual_seed(2), rows, obs, draws)
        outs.append(torch.cat([g.A[:, 0], g.LQinv_vec, g.LRinv_vec,
                               ll[:, None]], 1))
    assert bool(torch.isfinite(outs[0]).all())
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("pf", ["paris", "paris_ar"])
def test_fit_scan_runs_paris_on_cpu(pf):
    """SVMSampler and SeqSVMSampler.fit_scan with pf='paris' / 'paris_ar'
    (the experiment grid's PARIS entry and the demo's LD leg, at small
    size)."""
    g = torch.Generator().manual_seed(8)
    ys, _ = svm.generate_data(g, svm.from_scalars(0.9, 0.5, 1.0), 40)
    s = SVMSampler(observations=ys, device="cpu", seed=1)
    trace, aux = s.fit_scan("SGLD", num_iters=2, num_chains=3, N=32,
                            subsequence_length=8, buffer_length=2, pf=pf,
                            Ntilde=3, return_aux=True)
    sq = SeqSVMSampler([ys[:25], ys[25:]], device="cpu", seed=2)
    strace, saux = sq.fit_scan("SGLD", num_iters=1, num_chains=2, N=16,
                               pf=pf, subsequence_length=-1, return_aux=True)
    assert trace.A.shape == (3, 2, 1, 1) and strace.A.shape == (2, 1, 1, 1)
    for leaf in (trace.A, trace.LQinv_vec, aux, strace.A, saux):
        assert bool(torch.isfinite(leaf).all())
