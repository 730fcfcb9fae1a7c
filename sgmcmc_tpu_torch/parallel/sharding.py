"""Device mesh of the port: chains x particles over ``torch.distributed``.

Counterpart of ``sgmcmc_tpu/parallel/sharding.py``.  The JAX package runs
one controller over a ``Mesh(("chain", "particle"))``; the port runs one
process per device (NCCL between cards, gloo on the CPU) and names the
same two axes with a :class:`~torch.distributed.device_mesh.DeviceMesh`:

* ``chain`` — independent chains, a block of ``C / n_chain`` consecutive
  chains a rank, with no communication until the trace is gathered;
* ``particle`` — one particle filter's N particles split over P ranks,
  with collectives for resampling and normalisation (``pf_shard.py``).

The mesh is row-major, ``rank = chain_idx * P + particle_idx``, as JAX's
``reshape(n_chain, n_particle)``; a tiled all-gather over a particle group
therefore concatenates the shards in particle order.  Collectives over a
group of one rank are skipped; each one that runs is a
``sgmcmc.collective`` span in a profiler's trace.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models.base import params_map
from ..utils.profiling import span

AXES = ("chain", "particle")
# all_gather_single replaces all_gather_into_tensor from torch 2.13 on
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def initialize_multi_host(init_method: str | None = None,
                          world_size: int | None = None,
                          rank: int | None = None,
                          backend: str | None = None,
                          timeout: float | None = None) -> DeviceMesh:
    """Join the process group and return the ``(world, 1)`` chain mesh.

    The counterpart of ``jax.distributed.initialize``: without arguments it
    reads what ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT``, through ``env://``).  On a machine
    with cards the process takes ``cuda:LOCAL_RANK`` (modulo the cards
    there) and the backend defaults to NCCL; on the CPU to gloo.  Call it
    once per process before building other meshes with :func:`make_mesh`.
    ``timeout`` (seconds) bounds every collective's wait.
    """
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else int(world_size)
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    local_rank = int(env.get("LOCAL_RANK", rank))
    if init_method is None:
        if "MASTER_ADDR" not in env:
            raise ValueError(
                "initialize_multi_host needs init_method= (e.g. "
                "'file:///path' or 'tcp://localhost:PORT') or the "
                "MASTER_ADDR / MASTER_PORT that torchrun sets")
        init_method = "env://"
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if not dist.is_initialized():
        kw = {} if timeout is None else {
            "timeout": datetime.timedelta(seconds=timeout)}
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank, **kw)
    return make_mesh(world_size, 1)


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_chain_devices: int | None = None,
              n_particle_devices: int = 1) -> DeviceMesh:
    """The ``(chain, particle)`` mesh over every rank of the process group
    (``n_chain_devices`` defaults to ``world / n_particle_devices``).  In
    a process without a group it first makes a group of one rank (gloo, or
    NCCL where a card is), so ``make_mesh(1, 1)`` needs no launcher."""
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            store=dist.HashStore(), world_size=1, rank=0)
    world = dist.get_world_size()
    P = int(n_particle_devices)
    n_chain = world // P if n_chain_devices is None else int(n_chain_devices)
    if P < 1 or n_chain < 1 or n_chain * P != world:
        raise ValueError(
            f"a {n_chain} x {P} (chain x particle) mesh needs {n_chain * P} "
            f"ranks, the process group has {world} (one process per "
            f"device: launch with torchrun --nproc_per_node {n_chain * P})")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_chain, P), mesh_dim_names=AXES)


def mesh_coordinates(mesh: DeviceMesh) -> tuple[int, int]:
    """This rank's ``(chain_idx, particle_idx)``."""
    c, p = mesh.get_coordinate()
    return int(c), int(p)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.size(AXES.index(axis)))


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank along ``axis`` (None for one
    rank: no collective runs over it)."""
    return None if axis_size(mesh, axis) == 1 else mesh.get_group(axis)


def _leaf_block(x: torch.Tensor, n_chain: int, c: int) -> torch.Tensor:
    C = x.shape[0]
    if C % n_chain:
        raise ValueError(f"{C} chains do not split over a chain axis of "
                         f"{n_chain}")
    b = C // n_chain
    return x[c * b:(c + 1) * b]


def shard_chain_states(mesh: DeviceMesh, tree):
    """This rank's block of ``[C, ...]`` chain states: the chain group's
    ranks take consecutive blocks of ``C / n_chain`` chains.  ``tree`` is
    a parameter dataclass (the models' own, or one converted from the JAX
    package's) or a tensor."""
    c, _ = mesh_coordinates(mesh)
    n_chain = axis_size(mesh, "chain")
    if isinstance(tree, torch.Tensor):
        return _leaf_block(tree, n_chain, c)
    return params_map(lambda x: _leaf_block(x, n_chain, c), tree)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in group-rank order
    (``jax.lax.all_gather(..., tiled=True)``); one collective."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    # the concatenated form along dim 0, the one every backend takes
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with span("sgmcmc.collective"):
        _all_gather(out, x.contiguous(), group=group)
    if dim == 0:
        return out
    out = out.reshape((n,) + tuple(x.shape)).movedim(0, dim)
    return out.reshape(x.shape[:dim] + (n * x.shape[dim],)
                       + x.shape[dim + 1:])


def all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """``x`` reduced by ``op`` (``dist.ReduceOp.SUM`` / ``MAX``) over
    ``group``, in a new tensor."""
    if group is None:
        return x
    out = x.clone()
    with span("sgmcmc.collective"):
        dist.all_reduce(out, op=op, group=group)
    return out


def gather_chain_states(mesh: DeviceMesh, tree, dim: int = 0):
    """The inverse of :func:`shard_chain_states`: every chain block's
    states, concatenated along ``dim`` over the chain group (one
    collective per field)."""
    group = axis_group(mesh, "chain")
    if isinstance(tree, torch.Tensor):
        return all_gather_cat(tree, group, dim)
    return params_map(lambda x: all_gather_cat(x, group, dim), tree)


def chain_parallel_step(step_fn, mesh: DeviceMesh):
    """Lift ``step_fn(generator, params, observations) -> (params, aux)``
    to the rank's chain block: the chain-batched step itself, since every
    function of the port already runs all its chains at once and the
    chain axis needs no communication."""
    return step_fn


def chain_parallel_fit(step_fn, mesh: DeviceMesh, num_iters: int,
                       project_fn=None):
    """``fit(generator, params_local, observations) -> (params, aux [C_loc,
    num_iters])``: ``num_iters`` chain-parallel steps of the rank's chain
    block, each followed by the projection (``inference.sgmcmc.fit``
    without a trace)."""
    from ..inference.sgmcmc import fit as sgmcmc_fit
    pstep = chain_parallel_step(step_fn, mesh)

    def fit(generator, params_local, observations):
        params, _, aux = sgmcmc_fit(generator, params_local, observations,
                                    pstep, num_iters, project_fn=project_fn,
                                    output_all=False)
        return params, aux

    return fit
