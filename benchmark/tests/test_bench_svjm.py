"""The SVJM's plain reference against the port on the CPU: each function
on seeded parameters of five chains, the jump thresholds of both routes
bit for bit, a replayed call of each SVJM cell against the port's own
call, the bfloat16 control, and two SVJM faults planted in the port."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from benchmark.harness import check, data, main, spec
from benchmark.harness.system import System, leaves_of
from benchmark.reference import svjm as ref
from benchmark.reference import svm as ref_svm
from benchmark.tests.small import cpu_route, small_cell
from sgmcmc_tpu_torch.models import registry
from sgmcmc_tpu_torch.models import svjm as port
from sgmcmc_tpu_torch.ops.cuda import fused_pf

CELLS = ["svjm_k1", "svjm_unfused"]
PYTORCH_STEPS = "sgmcmc_tpu_torch.ops.buffered.run_buffered_pf.pytorch_steps"


def _params(seed=0, C=5):
    """Reference leaves and the port's parameters of C chains: natural
    parameters drawn around the truth, the last two chains' logit_pJ at
    the projection's ends."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((5, C), generator=g)
    leaves = ref.from_natural(A=-0.95 + 1.9 * u[0], Q=0.2 + 2.0 * u[1],
                              R=0.3 + 2.0 * u[2], pJ=0.01 + 0.5 * u[3],
                              QJ=0.5 + 4.0 * u[4])
    leaves["logit_pJ"][-2:, 0] = torch.tensor([-13.0, 13.0])
    return leaves, port.SVJMParams(**{k: v.clone()
                                      for k, v in leaves.items()})


def _particles(C=5, N=33, seed=1):
    g = torch.Generator().manual_seed(seed)
    x, xn, z0, z1 = torch.randn((4, C, N), generator=g) * 1.5
    y = torch.randn((C, 1), generator=g)
    return x, xn, [z0, z1], y


def test_from_natural_matches_the_ports_scalars():
    leaves, _ = _params()
    a, lq, lr, lqj = (leaves[k].reshape(-1)[:3] for k in
                      ("A", "LQinv_vec", "LRinv_vec", "LQJinv_vec"))
    pj = torch.sigmoid(leaves["logit_pJ"][:3, 0])
    for c in range(3):
        one = port.from_scalars(float(a[c]), float(lq[c]) ** -2,
                                float(lr[c]) ** -2, float(pj[c]),
                                float(lqj[c]) ** -2)
        mine = ref.from_natural(*(torch.tensor([v]) for v in (
            a[c], lq[c] ** -2, lr[c] ** -2, pj[c], lqj[c] ** -2)))
        for k in ref.LEAVES:
            torch.testing.assert_close(mine[k], getattr(one, k),
                                       rtol=1e-5, atol=1e-6)
    assert {k: v.shape[1:] for k, v in leaves.items()} == ref.SHAPES
    assert tuple(f.name for f in dataclasses.fields(port.SVJMParams)) \
        == ref.LEAVES


def test_columns_and_prior_moments_equal_the_ports():
    leaves, params = _params()
    pvec = port._fused_pack(params)
    cols = ref.columns(leaves)
    assert len(cols) == port.FUSED.n_param
    for i, col in enumerate(cols):
        assert torch.equal(col, pvec[:, i:i + 1]), i
    mean, var = ref.prior_moments(leaves)
    pm, pv = registry.get_model("svjm").prior_mean_var(params)
    assert torch.equal(mean[:, 0], pm) and torch.equal(var[:, 0], pv)


def test_jump_thresholds_of_both_routes_are_bit_equal():
    """The fused window's threshold (pJ clipped) and the PyTorch step's
    (unclipped) are the port's floats, and the same float wherever the
    projection leaves logit_pJ (|logit_pJ| <= 13: the clip never binds)."""
    leaves, params = _params()
    k1 = ref.jump_threshold(leaves)
    assert torch.equal(k1[:, 0], port._fused_pack(params)[:, 5])
    assert torch.equal(ref.jump_threshold(leaves, clip=False)[:, 0],
                       torch.special.ndtri(params.pJ))
    grid = torch.linspace(-13.0, 13.0, 200_001)[:, None]
    edges = torch.tensor([[-13.0], [13.0]])
    for logit in (grid, edges, torch.nextafter(edges, torch.zeros(()))):
        p = {"logit_pJ": ref.project({"A": torch.zeros(len(logit), 1, 1),
                                      "LQinv_vec": logit, "LRinv_vec": logit,
                                      "logit_pJ": logit,
                                      "LQJinv_vec": logit})["logit_pJ"]}
        assert torch.equal(ref.jump_threshold(p),
                           ref.jump_threshold(p, clip=False))
    # sigmoid is monotone, so the ends bound every projected pJ
    ends = torch.sigmoid(edges)
    assert ends[0] > ref.PJ_CLIP and ends[1] < torch.tensor(1.0 - ref.PJ_CLIP)


def test_kernel_functions_equal_both_routes():
    """init, propose, reweight and statistic against the fused body and
    the PyTorch step's kernel and statistic."""
    leaves, params = _params()
    x, xn, z, y = _particles()
    cols = ref.columns(leaves)
    pvec = port._fused_pack(params)
    pv = [pvec[:, i:i + 1] for i in range(pvec.shape[1])]
    mean, var = ref.prior_moments(leaves)
    pm, pvar = registry.get_model("svjm").prior_mean_var(params)
    z0 = torch.stack(z, 1)                                     # [C, Z, N]
    x0 = ref.init(z, mean, var)[0]
    assert torch.equal(x0, fused_pf.initial_state(port.FUSED, z0, pm,
                                                  pvar)[:, 0])
    assert torch.equal(x0, port.KERNEL.sample_x0(
        params, z0.transpose(1, 2), pm, pvar)[..., 0])
    prop = ref.propose(cols, z, [x], y)[0]
    assert torch.equal(prop, port._fused_propose(pv, z, [x], y)[0])
    assert torch.equal(prop, port.KERNEL.propose(
        params, z0.transpose(1, 2), x[..., None], y)[..., 0])
    lw = ref.reweight(cols, [x], [xn], y)
    assert torch.equal(lw, port._fused_reweight(pv, [x], [xn], y))
    assert torch.equal(lw, port.KERNEL.reweight(params, x[..., None],
                                                xn[..., None], y))
    h = torch.stack(ref.statistic(cols, [x], [xn], y), -1)     # [C, N, 5]
    assert torch.equal(h, torch.stack(port._fused_stat(pv, [x], [xn], y),
                                      -1))
    assert torch.equal(h, port.grad_statistic(params, x[..., None],
                                              xn[..., None], y, 0))
    # about pJ of the jumps drawn, and every one where z_2 is below it
    jump = (z[1] < cols[5]).float()
    assert torch.equal(jump.bool(), z[1] < torch.special.ndtri(
        params.pJ)[:, None])


def test_unpack_prior_and_projection_equal_the_ports():
    leaves, params = _params()
    stat = torch.randn((5, ref.STAT_DIM), generator=torch.Generator()
                       .manual_seed(2))
    got = ref.unpack(stat)
    want = port.unpack_grad(stat)
    prior = ref.prior_hyper({"prior": {"var": 100.0}})
    g_ref = ref.grad_logprior(prior, leaves)
    g_port = port.grad_logprior(port.default_prior(var=100.0), params)
    raw = {k: v * -1.3 for k, v in leaves.items()}
    raw["logit_pJ"] = raw["logit_pJ"] * 2.0
    proj = ref.project(raw)
    proj_port = port.project_parameters(port.SVJMParams(**raw))
    for k in ref.LEAVES:
        assert torch.equal(got[k], getattr(want, k)), k
        assert torch.equal(g_ref[k], getattr(g_port, k)), k
        assert torch.equal(proj[k], getattr(proj_port, k)), k
    dp = port.default_prior(var=100.0)
    for k, v in (("df", dp.df_Qinv), ("scale", dp.scale_Qinv[0, 0]),
                 ("df", dp.df_QJinv), ("alpha_pJ", dp.alpha_pJ),
                 ("beta_pJ", dp.beta_pJ), ("var_A", dp.var_col_A[0])):
        assert torch.tensor(prior[k], dtype=torch.float32) == v, k


def test_simulate_is_the_svm_without_jumps_and_jumps_at_pj():
    truth = {"A": 0.9, "Q": 0.5, "R": 1.0, "pJ": 0.05, "QJ": 2.0}
    z = np.random.default_rng(3).standard_normal((3, 4001))
    z[0, 0] = 0.0                          # x_0 = 0 in both models
    no_jumps = z.copy()
    no_jumps[2] = np.inf
    np.testing.assert_array_equal(
        ref.simulate(truth, no_jumps),
        ref_svm.simulate({k: truth[k] for k in ("A", "Q", "R")}, z[:2]))
    share = float((z[2, 1:] < -1.6448536269514722).mean())
    assert abs(share - 0.05) < 0.015
    ys = ref.simulate(truth, z)
    assert np.isfinite(ys).all() and not np.array_equal(
        ys, ref.simulate(truth, no_jumps))


def _system_call(cell, seed=11):
    dev = torch.device("cpu")
    obs = data.series(ref, cell.config, seed, dev)
    leaves = data.starts(ref, cell.config, seed, 6, dev)
    with cpu_route(cell):
        system = System(cell.config, cell.workload, obs, 3, dev, leaves)
        _, state = system.state()
        rec, aux = system.call(first=True)
    return obs, leaves, state, rec, aux, system


@pytest.mark.parametrize("name", CELLS)
def test_replay_equals_the_ports_call(name):
    torch.manual_seed(0)
    cell = small_cell(name, chains=6)
    assert spec.reference_model(cell.config["reference"]) is ref
    obs, leaves, state, rec, aux, system = _system_call(cell)
    final = leaves_of(system.sampler.parameters, ref.LEAVES)
    trace = leaves_of(rec, ref.LEAVES)
    ll, f = check.replay(ref, cell.config, cell.workload, obs, leaves, state)
    assert torch.equal(ll, aux)
    for k in ref.LEAVES:
        assert torch.equal(f[k], trace[k]), k
        assert torch.equal(f[k][:, -1], final[k]), k
    ll_p, f_p = check.replay(ref, cell.config, cell.workload, obs, leaves,
                             state, path=trace)
    assert torch.equal(ll_p, ll)
    for k in ref.LEAVES:
        assert torch.equal(f_p[k], f[k])
    # the control (bfloat16) is far from it
    ll16, _ = check.replay(ref, cell.config, cell.workload, obs, leaves,
                           state, dtype=torch.bfloat16)
    assert (ll16 - aux).abs().max() > 1e-3 * aux.abs().max()


def _cell(name):
    """The cell cut small; the unfused cell's PyTorch steps counted (the
    CPU runs every window step there)."""
    cell = small_cell(name)
    if name == "svjm_unfused":
        steps = (int(cell.workload["iters_per_call"])
                 * spec.window_steps(cell.config))
        cell.workload["launches_per_call"][PYTORCH_STEPS] = steps
    return cell


def _run(cell, seed=2 ** 31 + 77):
    with cpu_route(cell):
        return main.run_cell(cell, seed, 0.5, False, time.time(), "cpu",
                             "gloo")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(name):
    cell = _cell(name)
    out, metrics, correct, checks, _ = _run(cell)
    assert correct, checks
    assert {"steps_per_s", "setup_s"} <= set(metrics)
    obs, first, last = out.check_inputs
    args = (ref, cell.config, cell.workload, obs, first, last)
    control = check.in_place(ref.LEAVES, last, check.reference_outputs(*args),
                             check.reference_outputs(*args,
                                                     dtype=torch.bfloat16))
    assert not check.verdict(control, cell.workload["limits"])[0], control


def _no_jumps(monkeypatch):
    """Jumps never drawn: the threshold set to -inf on both routes."""
    def pack(params):
        pvec = port._fused_pack(params).clone()
        pvec[:, 5] = -torch.inf
        return pvec

    def propose(params, z, x_t, y_next):
        sd = torch.sqrt(params.Q[:, None, None])
        return params.a[:, None, None] * x_t + sd * z[..., 0:1]
    monkeypatch.setattr(port, "FUSED", dataclasses.replace(
        port.FUSED, pack_params=pack))
    monkeypatch.setattr(port, "KERNEL", dataclasses.replace(
        port.KERNEL, propose=propose))


def _responsibility_is_the_prior(monkeypatch):
    """The statistic's responsibility r1 replaced by the prior pJ."""
    real = port._fused_stat

    def stat(pv, x, x_new, y_t):
        a, lqinv, _, lqjinv, logit_pj, _ = pv
        h = real(pv, x, x_new, y_t)
        d = x_new[0] - a * x[0]
        v0 = 1.0 / (lqinv * lqinv)
        vj = 1.0 / (lqjinv * lqjinv)
        v1 = v0 + vj
        r1 = 1.0 / (1.0 + torch.exp(torch.clamp(-logit_pj, -60.0, 60.0)))
        r0 = 1.0 - r1
        dn0 = 0.5 * d * d / (v0 * v0) - 0.5 / v0
        dn1 = 0.5 * d * d / (v1 * v1) - 0.5 / v1
        return [h[0], (-2.0 * v0 / lqinv) * (r0 * dn0 + r1 * dn1),
                d * x[0] * (r0 / v0 + r1 / v1), torch.zeros_like(d),
                (-2.0 * vj / lqjinv) * r1 * dn1]
    monkeypatch.setattr(port, "_fused_stat", stat)
    monkeypatch.setattr(port, "FUSED", dataclasses.replace(
        port.FUSED, stat=stat))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_no_jumps, _responsibility_is_the_prior])
def test_svjm_fault_in_the_timed_path_is_not_correct(name, fault,
                                                     monkeypatch):
    cell = _cell(name)
    fault(monkeypatch)
    _, _, correct, checks, _ = _run(cell)
    assert not correct, {k: v["value"] for k, v in checks.items()}
    failed = [k for k, v in checks.items() if not v["value"] <= v["limit"]]
    assert set(failed) <= set(check.NUMBERS), failed
