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


@pytest.mark.parametrize("name", ["svm_k1", "garch_unfused", "garch_k1"])
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
