"""The cells that were there before PaRIS and Z normals came into the
reference: their series, chain starts, replayed draws, reference outputs
and metric readings on a fixed synthetic trace, as digests and values
frozen from the harness before that change (on the CPU).  A change to
the harness that moves any of them moves a cell's check or metric."""
import hashlib
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import check, data, spec, trace
from benchmark.reference import fit as ref_fit
from benchmark.tests.small import small_cell

SEED = 2 ** 31 + 12345

FROZEN = {
    "svm_k1": {
        "series": "08872c0a74ca26b1",
        "starts": "d1d18f247e91edcf",
        "draws": "70ce8c6bcd7c34c5",
        "replay": "af5a1b5166a5a4b8",
        "readers": {
            "steps_per_s": 81920.0,
            "call_p95_ms": None,
            "peak_mem_gib": 1.0,
            "setup_s": 1.0,
            "device_idle_pct": 24.811594202898547,
            "step_mfu": 523.0972096041531,
            "k1_roofline": 6941.097588978187,
            "loop_ops_per_iter": 8.0,
            "host_ms_per_iter": 0.9,
            "program_idle_pct": 23.36231884057971,
        },
    },
    "garch_unfused": {
        "series": "4289c162ea3f0a45",
        "starts": "e7441829b065444a",
        "draws": "dc92cf535b55e40d",
        "replay": "755d1f76afef654e",
        "readers": {
            "steps_per_s": 81920.0,
            "peak_mem_gib": 1.0,
            "setup_s": 1.0,
            "device_idle_pct": 24.811594202898547,
            "step_mfu": 633.670603504218,
            "resample_roofline": 1057.4586526825333,
            "smoother_ms_per_wstep": 0.00173,
            "smoother_ops_per_wstep": 0.13333333333333333,
            "host_ms_per_iter": 0.9,
            "smoother_host_ms_per_wstep": 0.12,
            "program_idle_pct": 23.36231884057971,
        },
    },
    "garch_k1": {
        "series": "4289c162ea3f0a45",
        "starts": "e7441829b065444a",
        "draws": "26a34c337775eabd",
        "replay": "8968806f91019769",
        "readers": {
            "steps_per_s": 81920.0,
            "call_p95_ms": None,
            "peak_mem_gib": 1.0,
            "setup_s": 1.0,
            "device_idle_pct": 24.811594202898547,
            "step_mfu": 633.670603504218,
            "k1_roofline": 4853.1251435132035,
            "loop_ops_per_iter": 8.0,
            "host_ms_per_iter": 0.9,
            "program_idle_pct": 23.36231884057971,
        },
    },
    "svm_island_4chip": {
        "series": "08872c0a74ca26b1",
        "starts": "d1d18f247e91edcf",
        "draws": "70ce8c6bcd7c34c5",
        "replay": "250fae21a8baf94d",
        "readers": {
            "steps_per_s.island": 81920.0,
            "peak_mem_gib": 1.0,
            "setup_s": 1.0,
            "device_idle_pct.island": 24.811594202898547,
            "step_mfu.island": 523.0972096041531,
            "k1_roofline.island": 6941.097588978187,
            "collective_ms_per_iter": 0.02595,
            "host_ms_per_iter.island": 0.9,
            "program_idle_pct.island": 23.36231884057971,
            "collectives_per_iter": None,
        },
    },
}


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _trace(calls):
    """A fixed synthetic trace: every per-layer reader finds its kernels
    and spans."""
    names = ["void fused_window_kernel<SvmBody>(...)",
             "void resample_apply_kernel<true>(...)",
             "void sgmcmc_step::smoother_step_kernel<GarchOptimalBody>(...)",
             "elementwise", "ncclDevKernel_AllReduce"]
    ops, t = [], 0.0
    for i in range(200):
        ops.append((names[i % len(names)], t, t + 10.0 + i % 7))
        t += 17.0
    tr = trace.Trace(ops, 0.0, t + 50.0, calls)
    tr.host = [("sgmcmc.smoother.step", 0.0, 120.0, 0),
               ("sgmcmc.iter", 0.0, 900.0, 0), ("sgmcmc.fit_scan", 0.0, t, 0)]
    return tr


def fingerprint(name) -> dict:
    cpu = torch.device("cpu")
    cell = spec.load_cell(name)
    cfg, wl = cell.config, cell.workload
    ref = spec.reference_model(cfg["reference"])
    out = {"series": _digest(data.series(ref, cfg, SEED, cpu)),
           "starts": _digest(*[v for _, v in sorted(
               data.starts(ref, cfg, SEED, 8, cpu).items())])}
    plan = check.plan_of(cfg, wl)
    gen = torch.Generator().manual_seed(SEED)
    z0, normals, positions, backward = ref_fit._filter_draws(gen, plan, 4,
                                                             cpu)
    assert backward is None
    j = torch.arange(plan.N, dtype=torch.float32)
    out["draws"] = _digest(
        torch.stack(z0, 1),
        torch.stack([torch.stack(normals(t), 1) for t in range(plan.W)], 1),
        torch.stack([positions(t, j) for t in range(plan.W)], 1),
        gen.get_state())
    sc = small_cell(name, chains=6)
    obs = data.series(ref, sc.config, 11, cpu)
    leaves = data.starts(ref, sc.config, 11, 6, cpu)
    state = torch.Generator().manual_seed(3).get_state()
    ll, f = check.replay(ref, sc.config, sc.workload, obs, leaves, state)
    out["replay"] = _digest(ll, *[f[k] for k in ref.LEAVES])
    run = SimpleNamespace(
        cell=cell, calls=[(0.0, 1.0)], window_start=0.0, setup_s=1.0,
        peak_bytes=2 ** 30, traces=[_trace(2)],
        chain_steps_per_call=int(wl["num_chains"]) * int(wl["iters_per_call"]))
    out["readers"] = {m["name"]: spec.metric_reader(m["name"])(run)
                      for m in cell.end_to_end + cell.per_layer}
    return out


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_cell_is_unchanged(name):
    got, want = fingerprint(name), FROZEN[name]
    for key in ("series", "starts", "draws", "replay"):
        assert got[key] == want[key], key
    # every metric the cell had reads as it did; a metric added later to
    # the cell (smoother_step_roofline) is not frozen here
    for metric, value in want["readers"].items():
        assert got["readers"][metric] == value, metric
