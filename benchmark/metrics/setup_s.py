"""Seconds from the process's start to the end of the set-up's call:
imports, inputs, the sampler, the kernel library's build or load, and one
call of the cell's shape."""


def read(run):
    return run.setup_s
