"""One rank of ``tests/test_torch_parallel.py``'s two-process runs.

    python tests/torch_parallel_child.py ROLE RANK WORLD DIR

joins a gloo group through ``file://DIR/init_ROLE``, runs the role's
checks with the port alone (torch, numpy; never JAX) and writes its
results to ``DIR/ROLE_RANK.npz``.  ``shard`` runs on a 1 x 2 mesh: the
sharded smoothers on the JAX package's draws (``DIR/inputs.npz``) and on
the port's own against the unsharded smoother, the multinomial comb for a
z-test, and the distributed SGLD fits (sharded, multinomial, island).
``chain`` runs on a 2 x 1 mesh, then the driver's sharded fit under the
same group.
"""
import contextlib
import os
import sys
import types
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from sgmcmc_tpu_torch.inference import samplers  # noqa: E402
from sgmcmc_tpu_torch.inference.sgmcmc import (PFScore,  # noqa: E402
                                               PFScoreConfig)
from sgmcmc_tpu_torch.models import lgssm, svm  # noqa: E402
from sgmcmc_tpu_torch.models.base import params_map  # noqa: E402
from sgmcmc_tpu_torch.models.registry import get_model  # noqa: E402
from sgmcmc_tpu_torch.ops import buffered  # noqa: E402
from sgmcmc_tpu_torch.ops.cuda import fused_pf  # noqa: E402
from sgmcmc_tpu_torch.parallel import pf_shard, sharding, training  # noqa

F64 = torch.float64
# the SVM fits: one series, the distributed fit's keywords
FIT_KW = dict(N=64, subsequence_length=8, buffer_length=2,
              pf="poyiadjis_N", resampler="systematic")


def svm_series():
    g = torch.Generator().manual_seed(4)
    ys, _ = svm.generate_data(g, svm.from_scalars(0.9, 0.5, 1.0), 64)
    return ys


def jax_cases(inp, rank, group, out):
    """The sharded smoother on the JAX package's draws, every case."""
    p = lgssm.params_from_jax(types.SimpleNamespace(
        A=inp["A"], C=inp["C"], LQinv_vec=inp["LQinv_vec"],
        LRinv_vec=inp["LRinv_vec"]), dtype=F64)
    t = torch.from_numpy
    ys, sw = t(inp["ys"])[None], t(inp["sw"])[None]
    NL = int(inp["n_local"])
    sl = slice(rank * NL, (rank + 1) * NL)
    for name in str(inp["cases"]).split(","):
        smoother, ess, chunk, lam = inp[f"{name}/config"]
        J = inp.get(f"{name}/J")
        stat, ll = pf_shard.run_buffered_pf_sharded(
            lgssm.get_kernel(), lgssm.grad_statistic, p, ys,
            z0=t(inp[f"{name}/z0"][sl])[None, None],
            normals=t(inp[f"{name}/z"][:, sl])[None, :, None],
            u=t(inp[f"{name}/u"])[None], statistic_dim=4, group=group,
            smoother=str(smoother), step_weights=sw,
            in_window=(sw > 0).to(F64), prior_mean=torch.zeros(1, dtype=F64),
            prior_var=torch.full((1,), 10.0, dtype=F64),
            resampler="systematic", lambduh=float(lam), n_tilde=2,
            ess_threshold=None if ess is None else float(ess),
            bw_chunk=None if chunk is None else int(chunk),
            J=None if J is None else t(J[:, sl].astype(np.int64))[None])
        out[f"{name}/stat"], out[f"{name}/ll"] = stat.numpy(), ll.numpy()


def against_unsharded(rank, group, out):
    """Float32 LGSSM windows on draws shared by both ranks: the sharded
    smoother at P=2 and, on rank 0, the unsharded one on the same draws."""
    g = torch.Generator().manual_seed(11)
    C, W, N = 3, 12, 64
    NL = N // 2
    p = params_map(lambda x: x.expand((C,) + x.shape[1:]).contiguous(),
                   lgssm.from_scalars(0.8, 0.5, 0.7))
    ys = torch.randn((C, W, 1), generator=g)
    z0 = torch.randn((C, 1, N), generator=g)
    nm = torch.randn((C, W, 1, N), generator=g)
    u = torch.rand((C, W), generator=g)
    v = torch.rand((C, W, N, 2), generator=g)
    sl = slice(rank * NL, (rank + 1) * NL)
    kw = dict(statistic_dim=4, prior_mean=torch.zeros(C),
              prior_var=torch.full((C,), 10.0), resampler="systematic",
              lambduh=0.9)
    for sm, ess in (("poyiadjis_N", None), ("poyiadjis_N2", None),
                    ("nemeth", 0.5), ("filter", None), ("paris", None)):
        stat, ll = pf_shard.run_buffered_pf_sharded(
            lgssm.get_kernel(), lgssm.grad_statistic, p, ys,
            z0=z0[..., sl], normals=nm[..., sl], u=u, group=group,
            smoother=sm, ess_threshold=ess, v=v[:, :, sl], **kw)
        out[f"unsharded/{sm}/stat"], out[f"unsharded/{sm}/ll"] = \
            stat.numpy(), ll.numpy()
        if rank == 0:
            ref = buffered.run_buffered_pf(
                lgssm.get_kernel(), lgssm.grad_statistic, p, ys, z0=z0,
                normals=nm, u=u, smoother=sm, ess_threshold=ess, v=v, **kw)
            out[f"unsharded/{sm}/ref_stat"] = ref.mean_statistic.numpy()
            out[f"unsharded/{sm}/ref_ll"] = ref.loglikelihood.numpy()


def multinomial(inp, rank, group, out):
    """C windows of one float64 LGSSM at N=512 over P=2, multinomial, on
    each rank's own uniforms: the chains' statistics for the z-test."""
    p0 = lgssm.params_from_jax(types.SimpleNamespace(
        A=inp["A"], C=inp["C"], LQinv_vec=inp["LQinv_vec"],
        LRinv_vec=inp["LRinv_vec"]), dtype=F64)
    C, NL = 48, 256
    ys = torch.from_numpy(inp["ys_z"])
    W = ys.shape[0]
    p = params_map(lambda x: x.expand((C,) + x.shape[1:]).contiguous(), p0)
    g = torch.Generator().manual_seed(100 + rank)
    stat, ll = pf_shard.run_buffered_pf_sharded(
        lgssm.get_kernel(), lgssm.grad_statistic, p,
        ys[None].expand(C, -1, -1),
        z0=torch.randn((C, 1, NL), generator=g, dtype=F64),
        normals=torch.randn((C, W, 1, NL), generator=g, dtype=F64),
        u=torch.rand((C, W, NL), generator=g, dtype=F64), statistic_dim=4,
        group=group, prior_mean=torch.zeros(C, dtype=F64),
        prior_var=torch.full((C,), 10.0, dtype=F64), resampler="multinomial")
    out["multinomial/stat"], out["multinomial/ll"] = stat.numpy(), ll.numpy()


def collectives_per_iter(prof) -> np.ndarray:
    """The ``sgmcmc.collective`` spans inside each ``sgmcmc.iter`` span of
    a profiled run."""
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("sgmcmc.")]
    return np.array([sum(n == "sgmcmc.collective" and s <= cs and ce <= e
                         for n, cs, ce in spans)
                     for name, s, e in sorted(spans, key=lambda v: v[1])
                     if name == "sgmcmc.iter"])


def fits(rank, mesh, group, out):
    """The distributed SGLD fit on the 1 x 2 mesh: sharded systematic
    (twice, from one seed), sharded multinomial and island (under the
    profiler: its collectives an iteration); then one island score with
    its K1 inputs."""
    ys = svm_series()
    for label, kw in (("sharded", {}), ("again", {}),
                      ("multinomial", dict(resampler="multinomial")),
                      ("island", dict(island_fused=True))):
        s = samplers.SVMSampler(observations=ys, device="cpu", seed=5)
        prof = (profile(activities=[ProfilerActivity.CPU])
                if label == "island" else contextlib.nullcontext())
        with warnings.catch_warnings(record=True) as rec, prof:
            warnings.simplefilter("always")
            trace, aux = s.fit_scan("SGLD", num_iters=3, num_chains=4,
                                    mesh=mesh, record="all", return_aux=True,
                                    **{**FIT_KW, **kw})
        if label == "island":
            out["fit/island/collectives"] = collectives_per_iter(prof)
        out[f"fit/{label}/A"] = trace.A.numpy()
        out[f"fit/{label}/LQinv"] = trace.LQinv_vec.numpy()
        out[f"fit/{label}/aux"] = aux.numpy()
        out[f"fit/{label}/warned"] = any("island size" in str(w.message)
                                         for w in rec)
    # one island score: K1's inputs (caught on their way in) and the
    # all-reduced rows
    cfg = PFScoreConfig(n_particles=32, subsequence_length=8,
                        buffer_length=2, resampler="systematic",
                        resample_mode="auto")
    score = PFScore(svm.KERNEL, svm.grad_statistic, svm.STATISTIC_DIM,
                    svm.unpack_grad, cfg, ys.shape[0],
                    get_model("svm").prior_mean_var, svm.FUSED)
    score.fused_on_cpu = True
    caught, real = [], fused_pf.fused_window

    def spy(model, *args, **kw):
        caught.append((args, kw))
        return real(model, *args, **kw)
    fused_pf.fused_window = spy
    try:
        params = params_map(lambda x: x.expand((4,) + x.shape[1:]),
                            svm.from_scalars(0.7, 0.8, 1.2))
        stat, ll = training.island_row_scores(
            score, torch.Generator().manual_seed(1),
            torch.Generator().manual_seed(20 + rank), params, ys, group)
    finally:
        fused_pf.fused_window = real
    (args, kw), = caught
    for name, a in zip(("pvec", "x0", "normals", "ys", "weights", "xi"),
                       args):
        out[f"island/{name}"] = a.numpy()
    out["island/lambduh"] = float(args[6])
    out["island/stat"], out["island/ll"] = stat.numpy(), ll.numpy()


def chain_role(rank, tmp, out):
    mesh = sharding.make_mesh(2, 1)
    out["coords21"] = np.array(sharding.mesh_coordinates(mesh))
    p4 = params_map(lambda x: x.expand((4,) + x.shape[1:]).contiguous(),
                    svm.from_scalars(0.7, 0.8, 1.2))
    p4 = params_map(lambda x: x * torch.arange(1, 5, dtype=x.dtype).reshape(
        (4,) + (1,) * (x.dim() - 1)), p4)
    out["block_A"] = sharding.shard_chain_states(mesh, p4).A.numpy()
    s = samplers.SVMSampler(observations=svm_series(), device="cpu", seed=6)
    trace, aux = s.fit_scan("SGLD", num_iters=3, num_chains=4, mesh=mesh,
                            record="all", return_aux=True, **FIT_KW)
    out["chain/A"], out["chain/aux"] = trace.A.numpy(), aux.numpy()
    out["chain/held"] = s.parameters.A.numpy()
    out["coords12"] = np.array(sharding.mesh_coordinates(
        sharding.make_mesh(1, 2)))
    # the driver's sharded fit under this group; count what each rank
    # writes
    from sgmcmc_tpu_torch.experiments import driver
    counts = {"tables": 0, "pickles": 0}
    real_csv, real_pickle, real_trace = (driver.tables.write_csv,
                                         driver.ckpt.save_pickle,
                                         driver.ckpt.save_trace)

    def counting(key, fn):
        def wrapped(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return wrapped
    driver.tables.write_csv = counting("tables", real_csv)
    driver.ckpt.save_pickle = counting("pickles", real_pickle)
    driver.ckpt.save_trace = counting("pickles", real_trace)
    try:
        driver.main(["--path", os.path.join(tmp, "experiment"), "--model",
                     "svm", "--device", "cpu", "--fit", "--experiment_id",
                     "0", "--num_chains", "2", "--num_particle_devices",
                     "2", "--island_fused"])
    finally:
        driver.tables.write_csv = real_csv
        driver.ckpt.save_pickle, driver.ckpt.save_trace = (real_pickle,
                                                           real_trace)
    out["driver/tables"], out["driver/pickles"] = (counts["tables"],
                                                   counts["pickles"])


def main():
    role, rank, world, tmp = (sys.argv[1], int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    sharding.initialize_multi_host(f"file://{tmp}/init_{role}", world, rank,
                                   backend="gloo")
    out = {}
    if role == "shard":
        mesh = sharding.make_mesh(1, 2)
        out["coords"] = np.array(sharding.mesh_coordinates(mesh))
        group = sharding.axis_group(mesh, "particle")
        inp = dict(np.load(os.path.join(tmp, "inputs.npz"),
                           allow_pickle=True))
        jax_cases(inp, rank, group, out)
        against_unsharded(rank, group, out)
        multinomial(inp, rank, group, out)
        fits(rank, mesh, group, out)
    else:
        chain_role(rank, tmp, out)
    out["imported_jax"] = any(m == "jax" or m.startswith("jax.")
                              or m.startswith("sgmcmc_tpu.")
                              for m in sys.modules)
    np.savez(os.path.join(tmp, f"{role}_{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
