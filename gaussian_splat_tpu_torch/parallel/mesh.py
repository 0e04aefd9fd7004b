"""Device meshes and the model's row blocks, one process per device.

Counterpart of gaussian_splat_tpu/parallel/mesh.py in PyTorch's idiom. The
JAX package drives every device from one process and places arrays on a
`jax.sharding.Mesh`; here each process drives one device — one rank of a
`torch.distributed` process group — and holds its own block of the model:

  * `make_mesh(n)` joins the process group of n ranks (or takes the one this
    process already joined) and returns a 1-D `DeviceMesh` named "dev" over
    it. The backend follows the device the caller names: NCCL for "cuda",
    gloo for "cpu"; None means the GPU and raises without one. It is never
    chosen silently: a CUDA mesh over a gloo group raises. World size, rank
    and the group's address (`tcp://127.0.0.1:<port>`) are given
    explicitly. A rank drives the card of its host's ordinal: `LOCAL_RANK`
    where a launcher set it (torchrun, over one host or several), else its
    rank (every rank on this host).
  * `shard_model(model, mesh)`: this rank's equal row block of every leaf, on
    this rank's device, as fresh parameters (each rank's optimizer then
    updates its own block only). A model too large for one process is given
    as a function of a row range instead, with its splat count: each rank
    then makes its own block alone.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gaussian_splat_tpu_torch._device import DeviceLike, resolve_device
from gaussian_splat_tpu_torch.models.gaussians import GaussianModel

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}  # the process group's, by device type
# a collective that waits longer than this raises instead of hanging
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


def local_index(rank: int) -> int:
    """The CUDA ordinal that `rank` drives on its host: `LOCAL_RANK` where a
    launcher set it, else the rank itself."""
    return int(os.environ.get("LOCAL_RANK", rank))


def _ranks_on_host(world: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = "dev",
    device: DeviceLike = None,
    rank: Optional[int] = None,
    init_method: Optional[str] = None,
) -> DeviceMesh:
    """1-D device mesh of `n_devices` ranks, this process being `rank`.

    If this process has not joined a process group yet, it joins one of
    world size `n_devices` at `init_method` (e.g. "tcp://127.0.0.1:29500")
    as `rank`; otherwise the group it joined must have `n_devices` ranks
    (None: any) and the device's backend. On "cuda" it raises when fewer
    cards are visible than this host's ranks ask for (`LOCAL_WORLD_SIZE`,
    else n_devices), and makes cuda:`local_index(rank)` this process's
    device."""
    kind = resolve_device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for {kind!r} devices")
    backend = BACKENDS[kind]
    if kind == "cuda" and n_devices is not None:
        _check_cards(_ranks_on_host(n_devices), f"make_mesh({n_devices})")
    if not dist.is_initialized():
        if n_devices is None or rank is None or init_method is None:
            raise ValueError(
                "no process group yet: give make_mesh n_devices, rank and "
                "init_method, or call parallel.distributed.init_distributed first"
            )
        if kind == "cuda":
            torch.cuda.set_device(local_index(rank))
        dist.init_process_group(
            backend, init_method=init_method, world_size=n_devices, rank=rank,
            timeout=COLLECTIVE_TIMEOUT,
        )
    world = dist.get_world_size()
    if n_devices is not None and world != n_devices:
        raise ValueError(f"make_mesh({n_devices}) in a process group of {world} ranks")
    if dist.get_backend() != backend:
        raise ValueError(
            f"a {kind} mesh needs the {backend} backend; this process group "
            f"runs {dist.get_backend()}"
        )
    if kind == "cuda":
        _check_cards(_ranks_on_host(world), f"a mesh of {world} ranks")
        torch.cuda.set_device(local_index(dist.get_rank()))
    return DeviceMesh(kind, torch.arange(world), mesh_dim_names=(axis_name,))


def _check_cards(needed: int, what: str) -> None:
    if torch.cuda.device_count() < needed:
        raise ValueError(
            f"{what} needs {needed} cards on this host, but only "
            f"{torch.cuda.device_count()} CUDA devices are visible"
        )


def mesh_device(mesh: DeviceMesh, axis_name: str = "dev") -> torch.device:
    """This rank's device: its host's card (`local_index`) on a CUDA mesh,
    the CPU on a gloo one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", local_index(mesh.get_local_rank(axis_name)))
    return torch.device(mesh.device_type)


def shard_model(
    model, mesh: DeviceMesh, axis_name: str = "dev", num_gaussians: Optional[int] = None,
) -> GaussianModel:
    """This rank's block of rows of every leaf (rows [r·N/D, (r+1)·N/D)), on
    this rank's device, as a new GaussianModel. N must divide by D: pad the
    model first (`pad_to_multiple`).

    With `num_gaussians` = N, `model` is instead a function (start, stop) →
    rows [start, stop) of the model's five leaves, by name: the rank makes
    only its own block, and no process ever holds the whole model."""
    ndev = mesh.size()
    rank = mesh.get_local_rank(axis_name)
    made = num_gaussians is not None
    n = num_gaussians if made else model.num_gaussians
    if n % ndev:
        raise ValueError(f"{n} splats do not split into {ndev} equal blocks: pad the model")
    per = n // ndev
    start, stop = rank * per, (rank + 1) * per
    if made:
        block = model(start, stop)
        leaves = [block[k] for k in GaussianModel.LEAVES]
        if leaves[0].shape[0] != per:
            raise ValueError(f"rows [{start}, {stop}) came back with {leaves[0].shape[0]} rows")
    else:
        leaves = [getattr(model, k).detach()[start:stop] for k in GaussianModel.LEAVES]
    return GaussianModel.create(*leaves, device=mesh_device(mesh, axis_name))


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m
