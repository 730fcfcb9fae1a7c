"""The plain reference against the port on the CPU: the frozen Philox
copy against the port's plain generator, and one replayed call against
the port's own call on the same inputs and seed."""
import pytest
import torch

from benchmark.harness import check, data, spec
from benchmark.harness.system import System, leaves_of
from benchmark.reference import philox

from benchmark.tests.small import cpu_route, small_cell


def test_philox_copy_matches_the_ports_plain_generator():
    from sgmcmc_tpu_torch.ops.cuda import philox as port
    seeds = torch.tensor([0, 1, -5, 2 ** 62 + 12345, -(2 ** 63)],
                         dtype=torch.int64)
    for stream in (0, 1):
        for t in (0, 7):
            want = port.philox_normals_reference(seeds, 1, 1, 33, stream,
                                                 t0=t)[:, 0, 0]
            got = philox.normals(seeds, t, 0, 33, stream)
            assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["svm_k1", "garch_unfused", "garch_k1",
                                  "svm_unfused", "svm_paris100"])
def test_replay_equals_the_ports_call(name):
    torch.manual_seed(0)
    cell = small_cell(name, chains=6)
    ref = spec.reference_model(cell.config["reference"])
    dev = torch.device("cpu")
    obs = data.series(ref, cell.config, 11, dev)
    leaves = data.starts(ref, cell.config, 11, 6, dev)
    with cpu_route(cell):
        system = System(cell.config, cell.workload, obs, 3, dev, leaves)
        _, state = system.state()
        rec, aux = system.call(first=True)
    final = leaves_of(system.sampler.parameters, ref.LEAVES)
    trace = leaves_of(rec, ref.LEAVES)
    ll, f = check.replay(ref, cell.config, cell.workload, obs, leaves, state)
    assert (ll - aux).abs().max() <= 1e-6 * aux.abs().max()
    for k in ref.LEAVES:
        assert torch.equal(f[k], trace[k])
        assert torch.equal(f[k][:, -1], final[k])
    # step by step on the port's own trace: the same
    ll_p, f_p = check.replay(ref, cell.config, cell.workload, obs, leaves,
                             state, path=trace)
    assert torch.equal(ll_p, ll)
    for k in ref.LEAVES:
        assert torch.equal(f_p[k], f[k])
    # the control (bfloat16) is far from it
    ll16, f16 = check.replay(ref, cell.config, cell.workload, obs, leaves,
                             state, dtype=torch.bfloat16)
    assert (ll16 - aux).abs().max() > 1e-3 * aux.abs().max()


@pytest.mark.parametrize("rng, resampler, pf", [
    ("host", "multinomial", "paris"),
    ("host", "multinomial", "poyiadjis_N"),
    ("kernel", "systematic", "poyiadjis_N")])
def test_draws_at_two_normals_equal_the_ports(rng, resampler, pf):
    """The SVJM draws two normals a particle: the reference's draws equal
    the port's ``PFScore.draw`` tensor for tensor, and both leave the
    generator in the same state."""
    from sgmcmc_tpu_torch.inference.samplers import SVJMSampler
    from sgmcmc_tpu_torch.ops.cuda import philox as port_philox
    from benchmark.reference import fit as ref_fit
    T, S, B, N, C = 120, 20, 5, 16, 5
    dev = torch.device("cpu")
    sampler = SVJMSampler(observations=torch.randn(T), device=dev, seed=0)
    score = sampler._make_score(sampler._score_config(
        N=N, subsequence_length=S, buffer_length=B, resampler=resampler,
        rng=rng, pf=pf), None)
    score.fused_on_cpu = rng == "kernel"
    assert score.kernel.noise_dim == 2
    g_port = torch.Generator().manual_seed(2 ** 31 + 9)
    g_ref = torch.Generator().manual_seed(2 ** 31 + 9)
    draws = score.draw(g_port, C, dev)
    plan = ref_fit.CallPlan(T=T, S=S, B=B, N=N, iters=1, epsilon=0.1,
                            resampler=resampler, kernel_rng=rng == "kernel",
                            route="k1" if rng == "kernel" else "unfused",
                            pf=pf, n_tilde=2, noise_dim=2)
    start = torch.randint(0, T - S + 1, (C,), generator=g_ref)
    z0, normals, positions, backward = ref_fit._filter_draws(g_ref, plan, C,
                                                             dev)
    W = plan.W
    assert torch.equal(start, draws.start)
    assert torch.equal(torch.stack(z0, 1), draws.z0)
    prop = torch.stack([torch.stack(normals(t), 1) for t in range(W)], 1)
    if rng == "kernel":
        assert draws.normals is None
        assert torch.equal(prop, port_philox.philox_normals(
            draws.seeds, W, 2, N, port_philox.STREAM_PROPOSAL))
    else:
        assert torch.equal(prop, draws.normals)
    j = torch.arange(N, dtype=torch.float32)
    pos = torch.stack([positions(t, j) for t in range(W)], 1)
    from sgmcmc_tpu_torch.ops.cuda.resample import resample_positions
    want = torch.stack([resample_positions(resampler, draws.u[:, t], N)
                        for t in range(W)], 1)
    assert torch.equal(pos, want)
    if pf == "paris":
        assert torch.equal(torch.stack([backward(t) for t in range(W)], 1),
                           draws.v)
    else:
        assert backward is None and draws.v is None
    assert torch.equal(g_port.get_state(), g_ref.get_state())


def test_unknown_smoother_raises():
    from benchmark.reference import fit as ref_fit
    cell = small_cell("svm_unfused", chains=2)
    cfg = dict(cell.config, pf="poyiadjis_N2")
    ref = spec.reference_model(cfg["reference"])
    dev = torch.device("cpu")
    obs = data.series(ref, cfg, 1, dev)
    leaves = data.starts(ref, cfg, 1, 2, dev)
    state = torch.Generator().manual_seed(1).get_state()
    with pytest.raises(ValueError, match="poyiadjis_N2"):
        check.replay(ref, cfg, cell.workload, obs, leaves, state)
    assert "poyiadjis_N2" not in ref_fit.SMOOTHERS
