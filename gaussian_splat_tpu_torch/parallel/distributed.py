"""Joining the process group from the standard environment.

Counterpart of gaussian_splat_tpu/parallel/distributed.py. Where the JAX
package calls `jax.distributed.initialize`, a process here joins a
`torch.distributed` process group, from arguments or from the variables
that PyTorch's launchers set (`MASTER_ADDR`, `MASTER_PORT`, `RANK`,
`WORLD_SIZE`). With neither it is a no-op that returns False, so a single
process may call it unconditionally.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gaussian_splat_tpu_torch._device import DeviceLike
from gaussian_splat_tpu_torch.parallel.mesh import make_mesh


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: DeviceLike = None,
) -> bool:
    """Join the process group from the arguments, or else from the standard
    environment (`MASTER_ADDR`/`MASTER_PORT`, `WORLD_SIZE`, `RANK`); the
    backend follows `device` (None: the GPU, NCCL). Returns True if more than
    one process takes part. With no address in either it does nothing and
    returns False."""
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if init_method is None:
        return False
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    make_mesh(world_size, device=device, rank=rank, init_method=init_method)
    return dist.get_world_size() > 1


def make_pod_mesh(axis_name: str = "dev", device: DeviceLike = None) -> DeviceMesh:
    """1-D mesh over every rank of the process group this process joined,
    in rank order."""
    return make_mesh(None, axis_name, device)


def local_batch_slice(total: int) -> slice:
    """This process's contiguous block of a length-`total` leading axis
    (equal split across the ranks; total must divide evenly). One process,
    outside any group, owns everything."""
    p = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    assert total % p == 0, f"{total} not divisible by {p} processes"
    per = total // p
    return slice(i * per, (i + 1) * per)
