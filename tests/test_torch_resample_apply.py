"""The port's resample-apply (its plain version, through the wrapper on CPU
tensors) against the JAX package's resample-apply kernels, the resampling
positions and the resamplers.

Inputs are drawn once with numpy and fed to both packages.  Column 0 of
``vals`` tags each row with its index, so the selection is compared
exactly; the other columns are compared within the JAX two-level kernel's
bf16 hi/lo bound (rtol=2e-5, atol=1e-5, as tests/test_resample_apply.py).
"""
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgmcmc_tpu.ops import resampling as jresampling
from sgmcmc_tpu.ops.pallas import resample as jresample
from sgmcmc_tpu_torch.ops import resampling
from sgmcmc_tpu_torch.ops.cuda import build, resample

torch.set_num_threads(1)


def inputs(seed, C, N, K, scheme="multinomial"):
    """(pos [C, N], cdf [C, N], vals [C, N, K]) as float32 numpy arrays;
    the CDF is the port's, made from random log weights."""
    rng = np.random.default_rng(seed)
    lw = (rng.standard_normal((C, N)) * 2).astype(np.float32)
    u = rng.uniform(0, 1, (C, N)).astype(np.float32)
    cdf = resample.weights_cdf(torch.from_numpy(lw))
    pos = resample.resample_positions(scheme, torch.from_numpy(u), N)
    vals = (rng.standard_normal((C, N, K)) * 5).astype(np.float32)
    vals[..., 0] = np.arange(N)
    return pos.numpy(), cdf.numpy(), vals


def port_apply(pos, cdf, vals):
    t = torch.from_numpy
    return resample.resample_apply(t(pos), t(cdf), t(vals)).numpy()


def assert_same_selection(got, want):
    np.testing.assert_array_equal(got[..., 0], np.asarray(want)[..., 0])
    np.testing.assert_allclose(got[..., 1:], np.asarray(want)[..., 1:],
                               rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("scheme", ["multinomial", "stratified"])
def test_reference_matches_k2a_interpret(scheme):
    pos, cdf, vals = inputs(0, 1, 128, 4, scheme)
    want = jresample.resample_apply_pallas2(
        jnp.asarray(pos[0]), jnp.asarray(cdf[0]), jnp.asarray(vals[0]),
        interpret=True)
    assert_same_selection(port_apply(pos, cdf, vals)[0], want)


def test_reference_matches_k2b_interpret():
    pos, cdf, vals = inputs(1, 4, 128, 4)
    want = jresample.resample_apply_pallas2_batched(
        jnp.asarray(pos), jnp.asarray(cdf), jnp.asarray(vals),
        chain_block=2, interpret=True)
    assert_same_selection(port_apply(pos, cdf, vals), want)


@pytest.mark.parametrize("K", [1, 4])
def test_reference_matches_k3_mirror(K):
    """K3 has no interpret mode; its plain mirror ``resample_apply_xla``
    builds the same dense one-hot product, at the JAX default N=1000."""
    pos, cdf, vals = inputs(2, 1, 1000, K)
    want = jresample.resample_apply_xla(
        jnp.asarray(pos[0]), jnp.asarray(cdf[0]), jnp.asarray(vals[0]))
    assert_same_selection(port_apply(pos, cdf, vals)[0], want)


@pytest.mark.parametrize("scheme", ["multinomial", "stratified",
                                    "systematic"])
def test_positions_match_jax_bitwise(scheme):
    """Positions from the uniforms that JAX's resample_positions draws
    from the same key."""
    N = 96
    key = jax.random.PRNGKey(5)
    shape = () if scheme == "systematic" else (N,)
    u = np.array(jax.random.uniform(key, shape, jnp.float32))
    want = jresample.resample_positions(scheme, key, N, jnp.float32)
    got = resample.resample_positions(scheme, torch.from_numpy(u)[None], N)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_degenerate_weights_select_identity():
    """All -inf log weights: the uniform CDF (j+1)/N, so stratified
    positions pick every particle once, as in the JAX package."""
    N = 64
    lw = np.full((2, N), -np.inf, np.float32)
    u = np.random.default_rng(3).uniform(0, 1, (2, N)).astype(np.float32)
    vals = np.arange(2 * N, dtype=np.float32).reshape(2, N, 1)
    out = resample.resample_rows(torch.from_numpy(u), torch.from_numpy(lw),
                                 torch.from_numpy(vals), "stratified")
    np.testing.assert_array_equal(out.numpy(), vals)
    jcdf = jresample.weights_cdf(jnp.asarray(lw[0]))
    np.testing.assert_array_equal(
        resample.weights_cdf(torch.from_numpy(lw))[0].numpy(),
        np.asarray(jcdf))


def test_all_modes_select_identically():
    rng = np.random.default_rng(4)
    lw = torch.from_numpy(rng.standard_normal((2, 40)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(0, 1, (2, 40)).astype(np.float32))
    vals = torch.from_numpy(rng.standard_normal((2, 40, 3))
                            .astype(np.float32))
    outs = [resample.resample_rows(u, lw, vals, "multinomial", mode)
            for mode in resample.RESAMPLE_MODES]
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="resample mode"):
        resample.resample_rows(u, lw, vals, "multinomial", "fused")


def test_wrapper_rejects_malformed_inputs():
    pos, cdf, vals = [torch.from_numpy(a) for a in inputs(6, 2, 16, 4)]
    before = resample.resample_apply.launches
    with pytest.raises(ValueError, match="do not match"):
        resample.resample_apply(pos, cdf[:1], vals)
    with pytest.raises(ValueError, match=r"vals \[C, N, K\]"):
        resample.resample_apply(pos, cdf, vals[..., 0])
    with pytest.raises(TypeError, match="float32"):
        resample.resample_apply(pos, cdf.double(), vals)
    with pytest.raises(ValueError, match="contiguous"):
        resample.resample_apply(pos.t().contiguous().t(), cdf, vals)
    # CPU tensors run the plain version and launch nothing
    resample.resample_apply(pos, cdf, vals)
    assert resample.resample_apply.launches == before


def test_resamplers_match_jax_on_shared_draws():
    """Stratified and systematic ancestors on the uniforms JAX draws from
    the same key (the JAX module searches side='left' on cumsum(probs),
    the port side='right' on its float64 CDF: equal off exact ties), and
    the effective sample size."""
    N = 128
    rng = np.random.default_rng(7)
    lw = (rng.standard_normal((1, N)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(8)
    for name, shape in (("stratified", (N,)), ("systematic", ())):
        u = np.array(jax.random.uniform(key, shape, jnp.float32))
        want = jresampling.get_resampler(name)(key, jnp.asarray(lw[0]))
        got = resampling.get_resampler(name)(torch.from_numpy(u)[None],
                                             torch.from_numpy(lw))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    np.testing.assert_allclose(
        resampling.effective_sample_size(torch.from_numpy(lw)).numpy(),
        [float(jresampling.effective_sample_size(jnp.asarray(lw[0])))],
        rtol=1e-5)
    anc = resampling.multinomial_resampling(
        torch.from_numpy(rng.uniform(0, 1, (1, N)).astype(np.float32)),
        torch.from_numpy(lw))
    assert anc.shape == (1, N) and int(anc.max()) < N
    with pytest.raises(ValueError, match="resampler"):
        resampling.get_resampler("residual")


def test_library_builds_every_kernel_source():
    """One library from every csrc/*.cu, named by a hash of the sources;
    the sources ship with the package, so an installed port can build."""
    assert [p.name for p in build.sources()] == [
        "cuda_error.cu", "fused_window_garch_optimal.cu",
        "fused_window_garch_prior.cu", "fused_window_lgssm_optimal.cu",
        "fused_window_lgssm_prior.cu", "fused_window_svjm.cu",
        "fused_window_svm.cu", "philox_normals.cu", "resample_apply.cu"]
    assert build.library_path().parent == build.BUILD_DIR
    pyproject = Path(__file__).resolve().parents[1] / "pyproject.toml"
    globs = tomllib.loads(pyproject.read_text())[
        "tool"]["setuptools"]["package-data"]["sgmcmc_tpu_torch"]
    pkg = build.CSRC_DIR.parent
    shipped = {p for g in globs for p in pkg.glob(g)}
    assert shipped == set(build.CSRC_DIR.glob("*.cu*"))
