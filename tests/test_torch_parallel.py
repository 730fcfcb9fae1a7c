"""The port's parallel layer (``sgmcmc_tpu_torch/parallel/``) against the
JAX package's, on the CPU.

Two two-process gloo runs (``tests/torch_parallel_child.py``, which
imports torch and the port only) start together from a ``file://`` init
in ``tmp_path`` and write their results to ``.npz`` files:

* ``shard`` (a 1 x 2 mesh): ``run_buffered_pf_sharded`` on JAX's own
  draws against JAX's ``run_buffered_pf_sharded`` under ``shard_map``
  (float64 LGSSM, optimal kernel, systematic; rtol = atol = 1e-10):
  ``poyiadjis_N``, ``filter``, ``poyiadjis_N2`` dense and in ``bw_chunk``
  rows, ``paris`` on JAX's backward indices J and the ESS gate with
  lambda = 0.9.  JAX's draws are rebuilt from its keys (the step splits
  its key into the resampling, proposal and backward keys; the proposal
  and backward keys fold in the particle index; J is ``categorical`` of
  the gathered backward weights, recomputed in the same ``shard_map``).
  The multinomial comb (an inverse CDF where JAX draws Gumbel-max, equal
  in law) is held to the Kalman gradient by a z-test as
  ``tests/test_parallel.py`` does; the sharded smoother against the port's
  unsharded one on the same float32 draws (rtol 1e-5, atol 1e-5: the two
  reduce in different orders); the distributed SGLD fits: deterministic,
  both particle ranks holding the same parameters after every iteration
  (sharded, multinomial, island), two collectives an iteration in the
  profiled island fit, the island score equal bitwise to the
  mean of the two ranks' islands rerun by ``fused_window_reference`` here,
  and the small-island warning.
* ``chain`` (a 2 x 1 mesh): the mesh coordinates, the chain blocks, the
  gathered trace on both ranks, then the driver's ``--num_particle_devices
  2 --island_fused`` fit under the same group, rank 0 alone writing.

In this process: the mesh coordinates and chain blocks of a 4 x 2 mesh
against JAX's ``NamedSharding`` index map, ``fit_scan(mesh=make_mesh(1,
1))`` equal bitwise to ``fit_scan(num_chains=C)``, and the refusals.
"""
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch.distributed.device_mesh import DeviceMesh

from sgmcmc_tpu.models import lgssm as jlgssm
from sgmcmc_tpu.ops import smoothers as jsmoothers
from sgmcmc_tpu.parallel import pf_shard as jpf_shard
from sgmcmc_tpu.parallel import sharding as jsharding
from sgmcmc_tpu_torch.experiments import driver
from sgmcmc_tpu_torch.inference import samplers
from sgmcmc_tpu_torch.models import svm
from sgmcmc_tpu_torch.models.base import params_map
from sgmcmc_tpu_torch.ops.cuda import fused_pf
from sgmcmc_tpu_torch.parallel import sharding

torch.set_num_threads(1)

CHILD = os.path.join(os.path.dirname(__file__), "torch_parallel_child.py")
W, NL, K = 12, 32, 2
# name: (smoother, ess_threshold, bw_chunk, lambduh)
CASES = {"poyiadjis_N": ("poyiadjis_N", None, None, 0.95),
         "filter": ("filter", None, None, 0.95),
         "poyiadjis_N2": ("poyiadjis_N2", None, None, 0.95),
         "poyiadjis_N2_chunk": ("poyiadjis_N2", None, 8, 0.95),
         "paris": ("paris", None, None, 0.95),
         "ess_gate": ("nemeth", 0.5, None, 0.9)}
FAST = dict(compiler_options={"xla_backend_optimization_level": 0})


def jax_params():
    return jlgssm.from_matrices(A=[[0.8]], C=[[1.0]], Q=[[0.5]], R=[[0.7]])


def jax_reference(ys, sw):
    """Every case of JAX's sharded smoother on a 1 x 2 mesh in one jitted
    call, with the draws it made: per case (mean statistic, loglik, z0
    [N], u [W], z [W, N], J [W, N, K] or None)."""
    params = jax_params()
    kernel = jlgssm.get_kernel("optimal")
    mesh = jsharding.make_mesh(1, 2, devices=jax.devices()[:2])
    iw = (sw > 0).astype(sw.dtype)
    pm, pv = jnp.zeros(1, ys.dtype), 10.0 * jnp.eye(1, dtype=ys.dtype)

    def local(key, obs):
        p = jax.lax.axis_index("particle")
        key_init, key_steps = jax.random.split(key)
        keys = jax.random.split(key_steps, W)
        z0 = jax.random.normal(jax.random.fold_in(key_init, p), (NL, 1),
                               ys.dtype)[:, 0]

        def draws(k):
            kr, kp, _ = jax.random.split(k, 3)
            return (jax.random.uniform(kr, (), ys.dtype),
                    jax.random.normal(jax.random.fold_in(kp, p), (NL, 1),
                                      ys.dtype)[:, 0])

        u, z = jax.vmap(draws)(keys)
        outs = []
        for name, (sm, ess, chunk, lam) in CASES.items():
            stat, ll = jpf_shard.run_buffered_pf_sharded(
                kernel, jlgssm.grad_statistic, params, obs, key=key,
                n_local=NL, statistic_dim=4, smoother=sm, step_weights=sw,
                in_window=iw, prior_mean=pm, prior_var=pv,
                resampler="systematic", lambduh=lam, n_tilde=K,
                ess_threshold=ess, bw_chunk=chunk)
            outs.append((stat, ll))
        # PaRIS's backward indices: the step rerun, J drawn from each
        # step's gathered carry with the step's own keys
        step = jpf_shard.make_sharded_smoother_step(
            kernel, jlgssm.grad_statistic, "paris", "particle",
            "systematic", n_tilde=K)
        x0 = kernel.sample_x0(params, jax.random.fold_in(key_init, p), NL,
                              pm, pv).astype(ys.dtype)
        carry0 = jsmoothers.PFCarry(x0, jnp.zeros((NL,), ys.dtype),
                                    jnp.zeros((NL, 4), ys.dtype),
                                    jnp.zeros((), ys.dtype))

        def body(c, inp):
            new = step(params, c, inp)
            all_x = jax.lax.all_gather(c.particles, "particle", tiled=True)
            all_w = jax.lax.all_gather(c.log_weights, "particle",
                                       tiled=True)
            kb = jax.random.split(inp.key, 3)[2]

            def row(xn):
                return all_w + kernel.prior_log_density(
                    params, all_x, jnp.broadcast_to(xn[None], all_x.shape))
            J = jax.vmap(lambda k, lw: jax.random.categorical(
                k, lw, shape=(K,)))(
                jax.random.split(jax.random.fold_in(kb, p), NL),
                jax.vmap(row)(new.particles))
            return new, J

        _, J = jax.lax.scan(body, carry0, jsmoothers.PFStepInput(
            key=keys, y=obs, weight=sw, in_window=iw,
            t=jnp.arange(W, dtype=jnp.int32)))
        return outs, z0, u, z, J

    specs = ([(P(), P())] * len(CASES), P("particle"), P(), P(None,
             "particle"), P(None, "particle"))
    f = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P()),
                          out_specs=tuple(specs), check_vma=False), **FAST)
    outs, z0, u, z, J = f(jax.random.PRNGKey(77), ys)
    return {name: (np.asarray(o[0]), np.asarray(o[1]))
            for name, o in zip(CASES, outs)}, [np.asarray(a)
                                               for a in (z0, u, z, J)]


def kalman_gradient(params, ys):
    g = jlgssm.gradient_marginal_loglikelihood(params, ys)
    return np.concatenate([np.asarray(g.LRinv_vec), np.asarray(g.LQinv_vec),
                           np.asarray(g.C).ravel(), np.asarray(g.A).ravel()])


def spawn(role, tmp):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    return [subprocess.Popen(
        [sys.executable, CHILD, role, str(r), "2", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two spawns: ``chain`` once the driver's setup is written,
    ``shard`` once the JAX side is; their results per role and rank."""
    tmp = tmp_path_factory.mktemp("parallel")
    args = driver.build_parser().parse_args(
        ["--path", str(tmp / "experiment"), "--model", "svm", "--device",
         "cpu", "--T", "40", "--T_test", "20"])
    grid = [dict(o, max_num_iters=3, steps_per_iteration=1, N=32,
                 subsequence_length=8, buffer_length=2)
            for o in driver.default_sampler_grid("svm")
            if o["name"] == "POYIADJIS_N_1000"]
    driver.do_setup(args, grid)
    procs = {"chain": spawn("chain", tmp)}
    params = jax_params()
    ys, _ = jlgssm.generate_data(jax.random.PRNGKey(0), params, W)
    rng = np.random.default_rng(0)
    sw = rng.uniform(1.0, 3.0, W)
    sw[:2] = 0.0
    want, (z0, u, z, J) = jax_reference(ys, jnp.asarray(sw))
    ys_z, _ = jlgssm.generate_data(jax.random.PRNGKey(1), params, 20)
    inp = dict(A=np.asarray(params.A), C=np.asarray(params.C),
               LQinv_vec=np.asarray(params.LQinv_vec),
               LRinv_vec=np.asarray(params.LRinv_vec), ys=np.asarray(ys),
               sw=sw, n_local=NL, cases=",".join(CASES),
               ys_z=np.asarray(ys_z))
    for name, cfg in CASES.items():
        inp.update({f"{name}/config": np.array(cfg, dtype=object),
                    f"{name}/z0": z0, f"{name}/u": u, f"{name}/z": z})
    inp["paris/J"] = J
    np.savez(tmp / "inputs.npz", **inp)
    procs["shard"] = spawn("shard", tmp)
    try:
        logs = {role: [p.communicate(timeout=300)[0] for p in ps]
                for role, ps in procs.items()}
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()              # the child's own PID
    for role, ps in procs.items():
        for p, log in zip(ps, logs[role]):
            assert p.returncode == 0, log[-3000:]
    out = {role: [dict(np.load(tmp / f"{role}_{r}.npz", allow_pickle=True))
                  for r in range(2)] for role in procs}
    return types.SimpleNamespace(tmp=tmp, want=want, out=out,
                                 expected=kalman_gradient(params, ys_z))


def test_children_import_neither_jax_nor_the_jax_package(runs):
    for role in runs.out.values():
        assert not any(bool(r["imported_jax"]) for r in role)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_smoother_matches_jax_on_its_draws(runs, case):
    want_stat, want_ll = runs.want[case]
    for r in runs.out["shard"]:
        np.testing.assert_allclose(r[f"{case}/stat"][0], want_stat,
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(r[f"{case}/ll"][0], want_ll, rtol=1e-10)


def test_multinomial_sharded_score_against_kalman(runs):
    """48 chains of N=512 over two ranks (multinomial, each rank's own
    uniforms): the mean statistic within 5 standard errors (plus the
    Poyiadjis bias allowance of tests/test_parallel.py) of the Kalman
    gradient, the same on both ranks."""
    a, b = (r["multinomial/stat"] for r in runs.out["shard"])
    np.testing.assert_array_equal(a, b)
    mean, se = a.mean(0), a.std(0) / np.sqrt(a.shape[0])
    err = np.abs(mean - runs.expected)
    assert np.all(err < 5 * se + 0.05 * np.abs(runs.expected) + 0.05), (
        mean, runs.expected, se)


@pytest.mark.parametrize("smoother", ["poyiadjis_N", "poyiadjis_N2",
                                      "nemeth", "filter", "paris"])
def test_sharded_smoother_matches_the_unsharded_one(runs, smoother):
    r0, r1 = runs.out["shard"]
    for r in (r0, r1):
        np.testing.assert_allclose(r[f"unsharded/{smoother}/stat"],
                                   r0[f"unsharded/{smoother}/ref_stat"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r[f"unsharded/{smoother}/ll"],
                                   r0[f"unsharded/{smoother}/ref_ll"],
                                   rtol=1e-5)


@pytest.mark.parametrize("route", ["sharded", "multinomial", "island"])
def test_particle_ranks_hold_the_same_parameters(runs, route):
    """Every recorded iteration of both particle ranks is the same: the
    window starts, the comb's uniform and the Langevin noise come from the
    chain block's shared stream."""
    r0, r1 = runs.out["shard"]
    for f in ("A", "LQinv", "aux"):
        np.testing.assert_array_equal(r0[f"fit/{route}/{f}"],
                                      r1[f"fit/{route}/{f}"])
    assert r0[f"fit/{route}/A"].shape == (4, 3, 1, 1)
    assert np.isfinite(r0[f"fit/{route}/A"]).all()
    # the chains differ from one another and move from the start
    assert np.ptp(r0[f"fit/{route}/A"][:, -1]) > 0


def test_distributed_fit_is_deterministic(runs):
    for r in runs.out["shard"]:
        np.testing.assert_array_equal(r["fit/sharded/A"], r["fit/again/A"])
        assert not np.array_equal(r["fit/sharded/A"], r["fit/island/A"])


def test_island_score_is_the_mean_of_two_islands(runs):
    """The all-reduced island rows equal, bitwise, the mean of the two
    ranks' island filters rerun here by fused_window_reference on the
    inputs each rank gave K1."""
    outs = []
    for r in runs.out["shard"]:
        args = [torch.from_numpy(r[f"island/{n}"]) for n in (
            "pvec", "x0", "normals", "ys", "weights", "xi")]
        outs.append(fused_pf.fused_window_reference(
            svm.FUSED, *args, lambduh=float(r["island/lambduh"])))
    mean = (outs[0] + outs[1]) / 2
    H = svm.FUSED.n_stat
    assert not torch.equal(outs[0], outs[1])
    for r in runs.out["shard"]:
        assert torch.equal(torch.from_numpy(r["island/stat"]), mean[:, :H])
        assert torch.equal(torch.from_numpy(r["island/ll"]), mean[:, H])


def test_island_runs_two_collectives_an_iteration(runs):
    """Under the profiler every iteration of the island fit holds two
    ``sgmcmc.collective`` spans on each rank: the all-reduces of the
    statistic and the log-likelihood."""
    for r in runs.out["shard"]:
        assert r["fit/island/collectives"].tolist() == [2, 2, 2]


def test_small_island_warning(runs):
    r = runs.out["shard"][0]
    assert bool(r["fit/island/warned"])
    assert not bool(r["fit/sharded/warned"])


def test_chain_mesh_gathers_the_global_trace(runs):
    """A 2 x 1 mesh: rank c holds chains [2c, 2c + 2) and both return the
    same [4, 3, ...] trace and hold the same stacked parameters."""
    r0, r1 = runs.out["chain"]
    assert r0["coords21"].tolist() == [0, 0] and \
        r1["coords21"].tolist() == [1, 0]
    assert r0["coords12"].tolist() == [0, 0] and \
        r1["coords12"].tolist() == [0, 1]
    np.testing.assert_allclose(r0["block_A"][:, 0, 0], [0.7, 1.4],
                               rtol=1e-6)
    np.testing.assert_allclose(r1["block_A"][:, 0, 0], [2.1, 2.8],
                               rtol=1e-6)
    for f in ("chain/A", "chain/aux", "chain/held"):
        np.testing.assert_array_equal(r0[f], r1[f])
    assert r0["chain/A"].shape == (4, 3, 1, 1)
    assert np.isfinite(r0["chain/A"]).all()
    np.testing.assert_array_equal(r0["chain/held"], r0["chain/A"][:, -1])
    # the two chain blocks draw from streams of their own
    assert not np.array_equal(r0["chain/A"][:2], r0["chain/A"][2:])


def test_driver_sharded_fit_writes_on_rank_zero(runs):
    r0, r1 = runs.out["chain"]
    assert int(r0["driver/tables"]) >= 1 and int(r0["driver/pickles"]) >= 2
    assert int(r1["driver/tables"]) == 0 and int(r1["driver/pickles"]) == 0
    fit = runs.tmp / "experiment" / "out" / "fit"
    assert (fit / "0_parameters.p").exists()


def test_mesh_coordinates_and_blocks_match_jax():
    """The 4 x 2 mesh: each rank's (chain, particle) coordinates and its
    block of 8 chains are those of JAX's mesh and NamedSharding index map
    on the virtual 8-device CPU mesh (the shards of a [C] array over the
    chain axis), for parameters carried over from the JAX package."""
    jmesh = jsharding.make_mesh(n_chain_devices=4, n_particle_devices=2)
    C = 8
    jp = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x)[None] * jnp.arange(1, C + 1).reshape(
            (C,) + (1,) * jnp.ndim(x)), jlgssm.from_matrices(
                A=[[0.8]], C=[[1.0]], Q=[[0.5]], R=[[0.7]]))
    from sgmcmc_tpu_torch.models import lgssm
    tp = lgssm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    index = NamedSharding(jmesh, P("chain")).devices_indices_map((C,))
    grid = np.asarray(jmesh.devices)
    for rank in range(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                          mesh_dim_names=sharding.AXES, _init_backend=False,
                          _rank=rank)
        c, p = sharding.mesh_coordinates(mesh)
        dev = grid.reshape(-1)[rank]
        assert (c, p) == tuple(int(i) for i in np.argwhere(grid == dev)[0])
        sl = index[dev][0]
        block = sharding.shard_chain_states(mesh, tp)
        np.testing.assert_array_equal(block.A.numpy(),
                                      np.asarray(jp.A)[sl].astype(np.float32))


@pytest.fixture
def world_of_one():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_mesh_1x1_fit_equals_fit_scan(world_of_one):
    """fit_scan(mesh=make_mesh(1, 1)) in one process (a group of one rank
    made on the spot) draws what fit_scan(num_chains=C) draws: the trace,
    the log-likelihoods and the held parameters are equal bitwise; so does
    chain_parallel_fit of the sampler's SGLD step."""
    g = torch.Generator().manual_seed(0)
    ys, _ = svm.generate_data(g, svm.from_scalars(0.9, 0.5, 1.0), 64)
    kw = dict(N=32, subsequence_length=8, buffer_length=2,
              resampler="systematic", record=2, return_aux=True)
    got = {}
    for label, extra in (("plain", {}),
                         ("mesh", dict(mesh=sharding.make_mesh(1, 1)))):
        s = samplers.SVMSampler(observations=ys, device="cpu", seed=3)
        trace, aux = s.fit_scan("SGLD", num_iters=6, num_chains=4,
                                **kw, **extra)
        got[label] = (trace, aux, s.parameters)
    for a, b in zip(got["plain"], got["mesh"]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            for f in ("A", "LQinv_vec", "LRinv_vec"):
                assert torch.equal(getattr(a, f), getattr(b, f))
    assert got["mesh"][0].A.shape == (4, 3, 1, 1)
    s = samplers.SVMSampler(observations=ys, device="cpu", seed=3)
    kw.pop("record"), kw.pop("return_aux")
    fit = sharding.chain_parallel_fit(
        s._step("sgld", 0.1, **kw), sharding.make_mesh(1, 1), 6,
        project_fn=s.model.project_parameters)
    params, aux = fit(s.generator, s._chain_init_params(4, "replicate"), ys)
    assert torch.equal(aux[:, 1::2], got["plain"][1])
    assert torch.equal(params.A, got["plain"][2].A)


def test_distributed_fit_refusals(world_of_one):
    """fit_scan(mesh=...)'s errors: another iter type, a score other than
    the particle filter's, chains that do not split over the chain axis,
    a P that does not divide the world, particles that do not split."""
    s = samplers.SVMSampler(observations=np.zeros(30, np.float32),
                            device="cpu")
    mesh = sharding.make_mesh(1, 1)
    with pytest.raises(NotImplementedError, match="SGLD"):
        s.fit_scan("SGRLD", num_iters=1, mesh=mesh, N=16)
    with pytest.raises(NotImplementedError, match="kind='pf'"):
        s.fit_scan("SGLD", num_iters=1, mesh=mesh, kind="marginal", N=16)
    with pytest.raises(ValueError, match="torchrun"):
        s.fit_scan("SGLD", num_iters=1, n_particle_devices=2, N=16)
    with pytest.raises(ValueError, match="torchrun"):
        sharding.make_mesh(2, 1)
    fake = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=sharding.AXES, _init_backend=False,
                      _rank=0)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        s.fit_scan("SGLD", num_iters=1, mesh=fake, num_chains=3, N=16)
    with pytest.raises(ValueError, match="particle axis"):
        s.fit_scan("SGLD", num_iters=1, mesh=fake, num_chains=2, N=15)
    params = params_map(lambda x: x.expand((4,) + x.shape[1:]),
                        svm.from_scalars(0.5, 1.0, 1.0))
    with pytest.raises(ValueError, match="do not split"):
        sharding.shard_chain_states(
            DeviceMesh("cpu", torch.arange(3).reshape(3, 1),
                       mesh_dim_names=sharding.AXES, _init_backend=False,
                       _rank=0), params)


def test_driver_mesh_flags_need_a_group(tmp_path):
    """Without a process group --num_particle_devices 2 raises, naming
    torchrun; so does it with another iter type than SGLD."""
    assert not dist.is_initialized()
    args = driver.build_parser().parse_args(
        ["--path", str(tmp_path), "--model", "svm", "--device", "cpu",
         "--T", "40", "--T_test", "20", "--num_particle_devices", "2"])
    grid = [dict(o, max_num_iters=2, N=16, subsequence_length=8,
                 buffer_length=2) for o in driver.default_sampler_grid("svm")
            if o["name"] == "POYIADJIS_N_1000"]
    opts = driver.do_setup(args, grid)
    with pytest.raises(ValueError, match="torchrun"):
        driver.do_fit(args, opts[0])
    with pytest.raises(ValueError, match="SGLD"):
        driver.do_fit(args, dict(opts[0], iter_type="ADAGRAD"))
