"""The port's exchange-rate demo against the JAX package's: the segment
loader and the data preparation on the same files (the JAX demo modules
imported by file path), the two legs of ``fit_model`` on their routes,
the demo's entry points on synthetic segments (the real series is not in
the repository), and its refusals.  All on the CPU."""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from sgmcmc_tpu_torch.demo.exchange_rate import (calculate_ksd,
                                                 exchange_rate_demo as demo,
                                                 exchange_rate_demo_gbp,
                                                 process_exchange_data,
                                                 save_params)
from sgmcmc_tpu_torch.inference import sgmcmc
from sgmcmc_tpu_torch.ops import smoothers

torch.set_num_threads(1)

JAX_DEMO = os.path.join(os.path.dirname(__file__), "..", "demo",
                        "exchange_rate")
LENGTHS = (40, 61, 38, 70, 45)


def jax_module(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_demo_{name}", os.path.join(JAX_DEMO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return demo.write_synthetic_data(
        str(tmp_path_factory.mktemp("demo") / "synthetic.npz"), LENGTHS,
        seed=3)


@pytest.mark.parametrize("min_len", [7, 25, 45])
def test_load_segments_matches_jax(npz, min_len):
    want = jax_module("exchange_rate_demo").load_segments(npz, min_len)
    got = demo.load_segments(npz, min_len)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if min_len == 7:
        # runs 7 h apart: one segment a run (the split keeps the loader's
        # boundary convention: a run's last step opens the next segment)
        assert [s.shape[0] for s in got] == [39, 61, 38, 70, 46]


def test_process_exchange_data_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    minutes = np.datetime64("2021-03-01T00:00") + np.cumsum(
        rng.integers(1, 40, 300)).astype("timedelta64[m]")
    close = 1.1 * np.exp(np.cumsum(1e-4 * rng.standard_normal(300)))
    raw = tmp_path / "raw.csv"
    with open(raw, "w") as f:
        f.write("<DATE>,<TIME>,<CLOSE>\n")
        for t, c in zip(minutes, close):
            s = str(t).replace("-", "").replace(":", "")
            f.write(f"{s[:8]},{s[9:]}00,{float(c)!r}\n")
    want = jax_module("process_exchange_data").process(
        str(raw), str(tmp_path / "jax.npz"))
    got = process_exchange_data.process(str(raw), str(tmp_path / "port.npz"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_fit_model_legs_take_their_routes(npz, monkeypatch):
    """SGLD: the fused window's route (systematic Poyiadjis O(N), which
    the card runs as one kernel launch); LD: PaRIS over the whole
    segment.  Both finite, the sampler left holding one chain (the JAX
    demo's sharded branch skips ``select_chain(0)``,
    ``exchange_rate_demo.py:103-108``)."""
    obs = demo.load_segments(npz)[1]
    backward = []
    real = smoothers._backward_indices

    def spy(*a, **kw):
        backward.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(smoothers, "_backward_indices", spy)
    for leg, iters in (("sgld", 4), ("ld", 2)):
        sampler, plist, times = demo.fit_model("svm", obs, leg, iters, 32,
                                               chunk_iters=3, device="cpu")
        kw = demo.leg_kwargs(leg, 32)
        score = sampler._make_score(sampler._score_config(**kw), None, **kw)
        assert sgmcmc._fused_eligible(score.config, score.fused_model) == \
            (leg == "sgld")
        assert len(plist) == iters and times == list(range(iters))
        assert all(np.isfinite(p.A.numpy()).all() for p in plist)
        assert sampler._num_chains is None
        assert sampler.parameters.num_chains == 1
        assert isinstance(sampler.noisy_loglikelihood(N=32, pf="filter"),
                          float)
        # PaRIS draws backward indices on every step of the LD leg only
        assert len(backward) == (0 if leg == "sgld" else iters * obs.shape[0])


def test_sharded_fit_raises(npz):
    """--n_particle_devices P runs one process per device: in one process
    it raises, naming torchrun; the multi-sequence modes refuse it, as in
    the JAX demo."""
    obs = demo.load_segments(npz)[1]
    with pytest.raises(ValueError, match="torchrun"):
        demo.fit_model("svm", obs, "sgld", 2, 32, n_particle_devices=2,
                       device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        demo.main(["--data", npz, "--n_particle_devices", "2", "--device",
                   "cpu", "--sgld_iters", "2", "--ld_iters", "1"])
    with pytest.raises(ValueError, match="--mode single"):
        demo.main(["--data", npz, "--mode", "subset", "--n_particle_devices",
                   "2", "--device", "cpu", "--sgld_iters", "2",
                   "--ld_iters", "1"])


@pytest.mark.parametrize("mode", ["single", "subset"])
def test_demo_main_on_synthetic_segments(npz, tmp_path, mode):
    res = demo.main(["--data", npz, "--mode", mode, "--sgld_iters", "6",
                     "--ld_iters", "1", "--N", "32", "--sgld_chunk_iters",
                     "4", "--out", str(tmp_path), "--device", "cpu"])
    assert set(res) == {"sgld", "ld"}
    for leg, r in res.items():
        assert r["samples"] == (6 if leg == "sgld" else 1)
        assert np.isfinite(r["loglikelihood"])
        assert set(r["summary"]) == {"phi", "sigma", "tau"}
        assert os.path.exists(tmp_path / f"svm_{leg}_trace.p")


def test_save_params_then_calculate_ksd(npz, tmp_path):
    paths = save_params.main(["--data", npz, "--N", "32", "--fit_time",
                              "0.2", "--chunk_iters", "3",
                              "--ld_chunk_iters", "1", "--out",
                              str(tmp_path), "--device", "cpu"])
    res = calculate_ksd.main(["--data", npz, "--trace", paths["sgld"],
                              paths["ld"], "--N", "32", "--max_samples",
                              "12", "--device", "cpu"])
    assert set(res) == {paths["sgld"], paths["ld"]}
    for v in res.values():
        assert set(v) == {"phi", "sigma", "tau"}
        assert np.isfinite(list(v.values())).all()


def test_missing_data_names_the_flag(tmp_path):
    missing = str(tmp_path / "none.npz")
    with pytest.raises(FileNotFoundError, match="--data"):
        demo.load_segments(missing)
    with pytest.raises(FileNotFoundError, match="--data"):
        demo.main(["--device", "cpu"] if not os.path.exists(
            demo.DEFAULT_DATA) else ["--data", missing, "--device", "cpu"])
    if not os.path.exists(exchange_rate_demo_gbp.DEFAULT_GBP_DATA):
        with pytest.raises(FileNotFoundError, match="EURGBP"):
            exchange_rate_demo_gbp.main(["--device", "cpu"])
