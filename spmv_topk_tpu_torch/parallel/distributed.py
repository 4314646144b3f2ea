"""Several processes: ``torch.distributed`` setup and the global mesh.

The JAX package runs its multi-host deployments (BASELINE.json configs
4-5) on ``jax.distributed`` and one global mesh over every process's
chips; rows are sharded in contiguous blocks per device and the merge
moves only k (value, row) pairs per device. Here the processes form a
``torch.distributed`` process group (gloo for CPU meshes, NCCL for CUDA
meshes), the global mesh lists every process's devices, rank by rank, and
the engines exchange their small host payloads and candidates with
``all_gather``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh


def world_size() -> int:
    """Processes of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device_type: Optional[str] = None) -> None:
    """Initialize the default process group from the arguments or the
    same variables the JAX package reads (COORDINATOR_ADDRESS, as
    host:port; NUM_PROCESSES; PROCESS_ID); no-op without an address or
    when a group exists. ``device_type`` "cpu" takes gloo, "cuda" NCCL
    (default: "cuda" where a card is visible)."""
    if dist.is_initialized():
        return
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is None:
        return   # single process
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    n = int(num_processes if num_processes is not None
            else os.environ["NUM_PROCESSES"])
    r = int(process_id if process_id is not None
            else os.environ["PROCESS_ID"])
    if device_type == "cuda":
        torch.cuda.set_device(r % torch.cuda.device_count())
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://{addr}", world_size=n,
                            rank=r)


def collective_device() -> torch.device:
    """Where the process group's tensors live: the current card for NCCL,
    the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (same shape and type everywhere), stacked on
    a new axis 0 in rank order, on ``t``'s device."""
    dev = collective_device()
    src = t.to(dev).contiguous()
    out = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(out, src)
    return torch.stack(out).to(t.device)


def process_allgather(x) -> np.ndarray:
    """All processes' copies of the NumPy value ``x``, stacked on axis 0
    in rank order (``multihost_utils.process_allgather(x, tiled=False)``
    in the JAX package)."""
    arr = np.ascontiguousarray(np.asarray(x))
    return all_gather(torch.from_numpy(arr)).numpy()


def global_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of every process's devices, rank by rank (each process's
    own in its order), so contiguous row shards land on one process
    first. ``devices``: this process's devices (default every visible
    CUDA device). One process: ``make_mesh(devices)``."""
    from .mesh import make_mesh

    local = make_mesh(devices)
    if world_size() == 1:
        return local
    lists = [None] * world_size()
    dist.all_gather_object(lists, [str(d) for d in local])
    devs, owners = [], []
    for r, names in enumerate(lists):
        devs += names
        owners += [r] * len(names)
    return Mesh(devs, owners)


def positions(mesh: Mesh) -> list:
    """This process's positions of ``mesh``. Raises unless the mesh
    covers every process of the group."""
    owners = getattr(mesh, "owners", [0] * len(mesh))
    n = world_size()
    if sorted(set(owners)) != list(range(n)):
        raise ValueError(f"the mesh's devices belong to ranks "
                         f"{sorted(set(owners))}, the process group has "
                         f"{n}: build it with distributed.global_mesh")
    return [i for i, r in enumerate(owners) if r == rank()]


def local_shard_rows(num_rows: int, mesh: Mesh) -> tuple:
    """[lo, hi) rows owned by this process's devices of ``mesh``."""
    D = len(mesh)
    rows_per = -(-num_rows // D)
    ids = positions(mesh)
    lo = min(ids) * rows_per
    hi = min((max(ids) + 1) * rows_per, num_rows)
    return lo, hi
