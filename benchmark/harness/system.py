"""The system under test: the port's sampler, built and called as the
configuration and the cell name it.

The configuration names the sampler class and the parameter class of the
port by their dotted paths; the cell names the call's options and the
port's launch counters that show the route a call took.  Nothing else of
the port is touched.
"""
from __future__ import annotations

import importlib

import torch


def dotted(path: str):
    module, _, name = path.rpartition(".")
    obj = importlib.import_module(module)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def counter(path: str):
    """(object, attribute) of a launch counter named
    ``module.function.attribute``."""
    owner, _, attr = path.rpartition(".")
    return dotted(owner), attr


class System:
    """One sampler of the port and the call the cell repeats."""

    def __init__(self, config: dict, workload: dict, observations, seed: int,
                 device, leaves: dict):
        sampler_cls = dotted(config["sampler"])
        self.params_cls = dotted(config["params_class"])
        self.sampler = sampler_cls(observations=observations, device=device,
                                   seed=seed)
        self.start = self.params_cls(**leaves)
        self.kw = dict(num_iters=int(workload["iters_per_call"]),
                       epsilon=float(config["epsilon"]),
                       num_chains=int(workload["num_chains"]),
                       record="all", return_aux=True, N=int(config["N"]),
                       subsequence_length=int(config["S"]),
                       buffer_length=int(config["B"]), pf=config["pf"],
                       **workload["call"])
        for key in ("kernel", "n_tilde"):
            if key in config:
                self.kw[key] = config[key]
        if int(config.get("particle_devices", 1)) > 1:
            self.kw.update(n_particle_devices=int(config["particle_devices"]),
                           island_fused=bool(config["island_fused"]))
        self.iter_type = config["iter_type"]
        self.counters = {name: counter(name)
                         for name in workload["launches_per_call"]}

    def state(self):
        """(the chains' parameters, the generator's state) before a call."""
        return self.sampler.parameters, self.sampler.generator.get_state()

    def call(self, first: bool = False):
        """One call; ``first`` starts the chains at the cell's starts, later
        calls continue from the parameters the last one left.  Returns the
        recorded trace (the parameters after each iteration, ``[C, iters,
        ...]``) and the per-iteration log-likelihoods ``[C, iters]``."""
        init = self.start if first else "replicate"
        return self.sampler.fit_scan(self.iter_type, chain_init=init,
                                     **self.kw)

    def launches(self) -> dict:
        return {name: getattr(obj, attr)
                for name, (obj, attr) in self.counters.items()}


def leaves_of(params, names) -> dict:
    return {k: getattr(params, k) for k in names}
